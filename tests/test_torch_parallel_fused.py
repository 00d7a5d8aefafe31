"""PyTorch port, the fused pairing product of the mesh plane (B16) and the
fused entry point `pairing.pairing_product` (B17), and the
`multichip_torch.py` dry run.

`sharded_pairing_product(..., fused=True)` on a logical mesh of CPU
devices: per cell the Miller loops of its row span and leg span, the
gather over mp, the tail (product and final exponentiation) once a row
group; one fused product a row group when mp = 1. On the CPU each
wrapper runs its kernel's plain version, whose cost is per call, so the
calls are counted and the GT values compared with hostmath row for row
(two of the rows have random legs, `torch_mesh_cases.ps_rows`).
The JAX package's fused `shard_map` program compiles for minutes on the
CPU: that comparison is marked slow."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.ops import pairing as ref_pr
from fabric_token_sdk_tpu.parallel import sharding as ref_sh
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import limbs as lb, pairing as pr, stages as st, tower as tw
from fabric_token_sdk_tpu_torch.parallel import make_mesh, sharded_pairing_product
from fabric_token_sdk_tpu_torch.utils import devobs
from torch_mesh_cases import host_gt, ones, ps_rows

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture
def stage_calls(monkeypatch):
    """Counts the calls of the stage wrappers the fused path makes."""
    calls = {}
    for name in ("miller_rows", "gt_product_final_exp_rows", "pairing_product_rows",
                 "gt_product_rows", "final_exp_rows"):
        fn = getattr(st, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(st, name, counted)
    return calls


@pytest.mark.parametrize("K", [2, 4])
def test_fused_pairing_product_matches_hostmath(K, stage_calls):
    """(dp, mp) = (4, 2), ragged B = 5 (padded to 8): a Miller call per
    mesh cell, a tail call per row group, no staged stage; GT values
    equal hostmath's row for row."""
    Ps, Qs, rows_P, rows_Q = ps_rows(0xF0 + K, 5, K)
    mesh = make_mesh(8, mp=2, devices=CPU8)
    devobs.reset()
    gt = sharded_pairing_product(Ps, Qs, mesh, fused=True)
    assert stage_calls == {"miller_rows": 8, "gt_product_final_exp_rows": 4}
    assert gt.shape == (5, 6, 2, lb.NWORDS)
    assert tw.decode_fp12(gt) == host_gt(rows_P, rows_Q)
    assert pr.gt_is_one_host(gt.numpy()).tolist() == ones(5)
    e = devobs.snapshot()[("stages", "fused_pairing")]
    assert (e["rows"], e["padded_rows"], e["dp"], e["mp"]) == (5 * K, 3 * K, 4, 2)


def test_fused_mp1_is_one_product_a_row_group(stage_calls):
    """mp = 1: each row group is one fused product over its rows."""
    Ps, Qs, rows_P, rows_Q = ps_rows(0xF5, 3, 2)
    gt = sharded_pairing_product(Ps, Qs, make_mesh(2, mp=1, devices=CPU8), fused=True)
    assert stage_calls == {"pairing_product_rows": 2}
    assert tw.decode_fp12(gt) == host_gt(rows_P, rows_Q)
    assert pr.gt_is_one_host(gt.numpy()).tolist() == ones(3)


def test_pairing_product_entry_masks_and_zero_legs(stage_calls):
    """`pairing.pairing_product`, the fused entry: one product call; a
    masked leg gives GT one, and an unmasked (0, 0) leg gives the same
    value (its Miller value lies in Fp4, which the final exponentiation
    sends to one)."""
    rng = random.Random(0xF7)
    p1, q1, q2 = hm.rand_g1(rng), hm.rand_g2(rng), hm.rand_g2(rng)
    Ps = torch.from_numpy(pr.encode_g1([p1, None, p1, None])).reshape(2, 2, 2, lb.NWORDS)
    Qs = torch.from_numpy(pr.encode_g2([q1, q2, q1, q2])).reshape(2, 2, 2, 2, lb.NWORDS)
    mask = np.array([[False, True], [False, False]])
    gt = pr.pairing_product(Ps, Qs, inf_mask=mask)
    assert stage_calls == {"pairing_product_rows": 1}
    assert tw.decode_fp12(gt) == [hm.pairing(p1, q1)] * 2
    assert pr.pairing_product(Ps[:0], Qs[:0]).shape == (0, 6, 2, lb.NWORDS)


@pytest.mark.slow
def test_fused_pairing_product_matches_reference_fused():
    """The port's fused product on the logical (4, 2) mesh against the
    JAX package's fused `shard_map` program on its 8 devices (a fresh
    multi-minute XLA compile)."""
    Ps, Qs, rows_P, rows_Q = ps_rows(0xFA, 5, 2)
    ref_P = np.stack([np.asarray(ref_pr.encode_g1(r)) for r in rows_P])
    ref_Q = np.stack([np.asarray(ref_pr.encode_g2(r)) for r in rows_Q])
    want = ref_sh.sharded_pairing_product(ref_P, ref_Q, ref_sh.make_mesh(8, mp=2), fused=True)
    got = sharded_pairing_product(Ps, Qs, make_mesh(8, mp=2, devices=CPU8), fused=True)
    assert torch.equal(got, lb.from_reference_limbs(np.asarray(want), hm.P))


# ------------------------------------------------------------------ multichip_torch.py

def test_multichip_script_needs_the_cuda_devices_it_names(monkeypatch):
    """Without --logical the mesh is laid over CUDA devices, and a
    machine with fewer fails; the script imports nothing of JAX."""
    import multichip_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        multichip_torch.main(["--devices", "2", "--mp", "2"])
    src = open(os.path.join(ROOT, "multichip_torch.py")).read()
    assert "import jax" not in src and "from jax" not in src
    assert "fabric_token_sdk_tpu." not in src.replace("fabric_token_sdk_tpu_torch", "")


@pytest.mark.slow
def test_multichip_script_logical_cpu():
    """`multichip_torch.py --logical --device cpu` at the smallest size
    (one cell; ~30 s of plain versions), both pairing paths."""
    for extra in ([], ["--fused"]):
        res = subprocess.run(
            [sys.executable, os.path.join(ROOT, "multichip_torch.py"), "--logical", "--device",
             "cpu", "--devices", "1", *extra],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert res.returncode == 0, res.stdout + res.stderr
        assert "multichip_torch: mesh dp=1 mp=1 ok" in res.stdout
