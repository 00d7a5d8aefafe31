"""PyTorch port, what carries across packages: byte-identical proofs
from one seed, cross-package host verification, public parameters, and
the port's import boundary (no jax, nothing of the JAX package)."""

import os
import random
import subprocess
import sys

import pytest

from fabric_token_sdk_tpu.crypto import setup as ref_setup, token as ref_tok
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import setup, token as tok, transfer as tr

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def params():
    ref_pp = ref_setup.setup(base=4, exponent=2, rng=random.Random(0xCA11))
    port_pp = setup.setup(base=4, exponent=2, rng=random.Random(0xCA11))
    return ref_pp, port_pp


def test_public_params_byte_compatible(params):
    ref_pp, port_pp = params
    raw = ref_pp.serialize()
    assert port_pp.serialize() == raw  # same seed, same setup
    back = setup.PublicParams.deserialize(raw)
    assert back.serialize() == raw
    assert ref_setup.PublicParams.deserialize(back.serialize()).serialize() == raw


def _prove(mod_tok, mod_tr, pp, in_vals, out_vals, seed):
    rng = random.Random(seed)
    ins, inw = mod_tok.tokens_with_witness(in_vals, "EUR", pp.ped_params, rng)
    outs, outw = mod_tok.tokens_with_witness(out_vals, "EUR", pp.ped_params, rng)
    return ins, outs, mod_tr.TransferProver(inw, outw, ins, outs, pp, rng).prove()


@pytest.mark.parametrize("shape", [((9,), (9,)), ((2, 1), (1, 2))], ids=["1in1out", "2in2out"])
def test_proofs_byte_identical_and_cross_verified(params, shape):
    ref_pp, port_pp = params
    ins_r, outs_r, raw_r = _prove(ref_tok, ref_tr, ref_pp, *shape, seed=5)
    ins_p, outs_p, raw_p = _prove(tok, tr, port_pp, *shape, seed=5)
    assert (ins_p, outs_p) == (ins_r, outs_r)
    assert raw_p == raw_r
    tr.TransferVerifier(ins_r, outs_r, port_pp).verify(raw_r)
    ref_tr.TransferVerifier(ins_p, outs_p, ref_pp).verify(raw_p)
    bad = bytearray(raw_p)
    bad[len(bad) // 2] ^= 1
    with pytest.raises(Exception):
        tr.TransferVerifier(ins_p, outs_p, port_pp).verify(bytes(bad))


def test_host_batch_verify_copy_agrees(params):
    _, pp = params
    specs = [_prove(tok, tr, pp, (3,), (3,), seed=s) for s in (6, 7)]
    specs.append((specs[0][0], specs[1][1], specs[0][2]))  # mismatched output
    assert tr.verify_transfer_proofs(specs, pp) == [True, True, False]


def test_port_imports_no_jax_and_no_reference_package():
    """Importing every port module leaves jax and fabric_token_sdk_tpu[.*]
    out of sys.modules (the prefix check must not match the port's own
    name, which starts with the reference's)."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import fabric_token_sdk_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
         if importlib.util.find_spec(m.name).origin.endswith(".py")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
       or m == "fabric_token_sdk_tpu" or m.startswith("fabric_token_sdk_tpu.")]
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from jax" not in src
    assert "fabric_token_sdk_tpu." not in src.replace("fabric_token_sdk_tpu_torch", "")
    assert "fabric_token_sdk_tpu " not in src.replace("fabric_token_sdk_tpu_torch", "")
