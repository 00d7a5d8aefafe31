"""PyTorch port, what carries across packages: byte-identical proofs
from one seed, cross-package host verification, public parameters, the
port's import boundary (no jax, nothing of the JAX package, the token
services included), and where a `Party` and its `Network` run."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch_prove as ref_bp
from fabric_token_sdk_tpu.crypto import setup as ref_setup, token as ref_tok
from fabric_token_sdk_tpu.crypto import transfer as ref_tr
from fabric_token_sdk_tpu_torch.crypto import batch_prove as bp
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


def test_prover_state_carries_over_from_reference():
    """The JAX batched prover's tables and encoded points, taken as numpy,
    equal the port prover's own buffers built from the same parameters,
    and load into it."""
    ref_pp = ref_setup.setup(base=16, exponent=2, rng=random.Random(0xCA12))
    pp = setup.setup(base=16, exponent=2, rng=random.Random(0xCA12))
    ref = ref_bp.BatchedTransferProver(ref_pp)
    arrays = {name: np.asarray(getattr(ref, name).table.flat) for name in ("ped3", "ped2", "pedP")}
    arrays.update(pk=ref.pk_np, Q=ref.Q_np, sig_R=ref.sig_R_np, sig_S=ref.sig_S_np)
    state = bp.prover_state_from_reference(arrays)
    prover = bp.BatchedTransferProver(pp, device="cpu")
    own = prover.state_dict()
    assert sorted(state) == sorted(own)
    for name, t in own.items():
        assert torch.equal(state[name], t), name
    prover.load_state_dict(state)


def test_fabtoken_public_params_byte_compatible():
    from fabric_token_sdk_tpu.drivers.fabtoken import FabTokenPublicParams as RefFabPP
    from fabric_token_sdk_tpu_torch.drivers.fabtoken import FabTokenPublicParams

    ref = RefFabPP(label="fab", quantity_precision=32, issuers=[b"i1", b"i2"], auditor=b"a")
    raw = ref.serialize()
    port = FabTokenPublicParams.deserialize(raw)
    assert port == FabTokenPublicParams("fab", 32, [b"i1", b"i2"], b"a")
    assert port.serialize() == raw
    assert RefFabPP.deserialize(port.serialize()) == ref


def test_token_request_wire_format_both_directions():
    from fabric_token_sdk_tpu.api import request as ref_req
    from fabric_token_sdk_tpu.models.token import ID as RefID
    from fabric_token_sdk_tpu_torch.api import request as req
    from fabric_token_sdk_tpu_torch.models.token import ID

    def build(mod, id_cls):
        r = mod.TokenRequest(anchor="tx9")
        r.issues.append(mod.IssueRecord(action=b"issue", issuer=b"me", outputs_metadata=[b"m0"],
                                        receivers=[b"r0"], signature=b"sig"))
        r.transfers.append(mod.TransferRecord(action=b"xfer", input_ids=[id_cls("tx8", 1)],
                                              senders=[b"s"], outputs_metadata=[b"m1", b"m2"],
                                              receivers=[b"r1", b"r2"], signatures=[b"z"]))
        r.auditor_signature = b"asig"
        r.set_application_metadata("k", b"v")
        return r

    ref, port = build(ref_req, RefID), build(req, ID)
    raw = port.to_bytes()
    assert raw == ref.to_bytes()
    assert port.marshal_to_sign() == ref.marshal_to_sign()
    assert port.marshal_to_audit() == ref.marshal_to_audit()
    assert ref_req.TokenRequest.from_bytes(raw).to_bytes() == raw
    back = req.TokenRequest.from_bytes(ref.to_bytes())
    assert back.to_bytes() == raw and back.transfers[0].input_ids == [ID("tx8", 1)]
    assert back.wire_bytes() == raw


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
for need in ("parallel.sharding", "crypto.sign", "crypto.batch_sign", "utils.devobs",
             "api", "api.tms", "models", "drivers", "drivers.zkatdlog.driver",
             "drivers.fabtoken.driver", "services.interop", "services.interop.htlc",
             "utils.profiler", "services.network", "services.network.orderer",
             "services.network.pipeline", "services.network.ledger", "services.network.wal",
             "utils.tracing", "utils.faults", "utils.slo", "utils.resilience",
             "services.ttx", "services.ttx.party", "services.ttx.transaction",
             "services.ttx.pipeline", "services.vault", "services.vault.store",
             "services.vault.vault", "services.selector", "services.selector.selector",
             "services.ttxdb", "services.ttxdb.db", "services.auditor",
             "services.auditor.auditor", "services.owner", "services.owner.owner",
             "services.query", "services.query.query", "services.certifier",
             "services.certifier.certifier", "services.nfttx", "services.nfttx.nft"):
    assert port.__name__ + "." + need in names, need
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


def test_party_network_on_the_cpu_never_touch_cuda(monkeypatch):
    """A port `Network(device="cpu")` with parties whose zkatdlog drivers
    keep the default device (None): an issue, a lone transfer (host by
    policy) and a group of two through the batched plane on the CPU never
    ask for CUDA, while each party's `ZKATDLogDriver(pp)` still resolves
    to the card on its first batched-plane call (raising here, where
    there is none)."""
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.api.wallet import AuditorWallet
    from fabric_token_sdk_tpu_torch.crypto import sign
    from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
    from fabric_token_sdk_tpu_torch.services.auditor import AuditorService
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction

    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: asked.append(1) or False)
    pp = setup.setup(base=4, exponent=2, rng=random.Random(0xCA11))
    rng = random.Random(4)
    aw = AuditorWallet("auditor", sign.keygen(rng))
    auditor = AuditorService(ZKATDLogDriver(pp), aw)
    net = Network(RequestValidator(ZKATDLogDriver(pp, device="cpu"), aw.identity),
                  BlockPolicy(max_block_txs=8), device="cpu")
    issuer_p, alice_p, bob_p = (Party(n, ZKATDLogDriver(pp), net, aw.identity, rng=rng)
                                for n in ("issuer", "alice", "bob"))
    issuer = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(issuer.identity)
    alice = alice_p.new_owner_wallet("alice", anonymous=True, nym_params=pp.nym_params)
    bob = bob_p.new_owner_wallet("bob", anonymous=True, nym_params=pp.nym_params)
    tx = Transaction(issuer_p, "seed")
    tx.issue("issuer", "USD", [3, 3, 3], [alice.recipient_identity()] * 3, anonymous=False)
    tx.collect_endorsements(auditor)
    tx.submit()
    txs = []
    for i in range(3):
        t = Transaction(alice_p, f"pay-{i}")
        t.transfer("alice", "USD", [3], [bob.recipient_identity()])
        t.collect_endorsements(auditor)
        txs.append(t)
    assert txs[0].submit().status.value == "Valid"
    for t in txs[1:]:
        t.submit_async()
    assert [t.wait().status.value for t in txs[1:]] == ["Valid", "Valid"]
    assert (alice_p.balance("USD"), bob_p.balance("USD")) == (0, 9)
    assert net.device == torch.device("cpu") and not asked
    assert all(p.driver.device is None for p in (issuer_p, alice_p, bob_p))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alice_p.driver.batch_prover()
    assert asked
