"""PyTorch port, the mesh plane's staged pairing product:
`sharded_pairing_product` on a logical (dp, mp) = (4, 2) mesh of CPU
devices (fused off), each row group the staged sequence on its device,
against hostmath, and against the JAX package's staged product with the
same dp and mp in a slow test.

Every cell of the logical mesh is the CPU, where the wrappers run their
kernels' plain torch versions; each row group is a whole plain call of
several seconds, so these tests sit in a file of their own. The rows are
Pointcheval-Sanders checks padded with pairs (P, Q), (-P, Q), and two of
them have random legs (`torch_mesh_cases.ps_rows`): the values are
compared with hostmath's row for row."""

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.ops import pairing as ref_pr
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import limbs as lb, pairing as pr, tower as tw
from fabric_token_sdk_tpu_torch.parallel import MeshConfig, make_mesh, sharded_pairing_product
from fabric_token_sdk_tpu_torch.parallel import sharding
from fabric_token_sdk_tpu_torch.utils import devobs
from fabric_token_sdk_tpu_torch.utils import metrics as mx
from torch_mesh_cases import host_gt, ones, ps_rows

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _counter(name):
    return mx.REGISTRY.counter(name).value


@pytest.mark.parametrize("K", [2, 4])
def test_sharded_pairing_product_staged_matches_hostmath(K):
    """The staged sequence over the 4 row groups of the logical (4, 2)
    mesh (fused off) on a ragged B = 5: miller, gt_product and final_exp
    once a group; GT values equal hostmath's row for row."""
    Ps, Qs, rows_P, rows_Q = ps_rows(0xA0 + K, 5, K)
    mesh = make_mesh(8, mp=2, devices=CPU8)
    calls = _counter("stages.calls")
    gt = sharded_pairing_product(Ps, Qs, mesh, fused=False)
    assert _counter("stages.calls") - calls == 3 * 4
    assert tw.decode_fp12(gt) == host_gt(rows_P, rows_Q)
    assert pr.gt_is_one_host(gt.numpy()).tolist() == ones(5)


def test_k_not_divisible_by_mp_degrades_to_staged(monkeypatch):
    """K % mp != 0 on the fused path is a planning decision: the staged
    sequence over the mesh's row groups, counted under
    `sharding.fallbacks`, a flight event and the ledger. No mesh is the
    staged sequence on the tensors' device; a MeshConfig is refused."""
    seen = []

    def staged(Ps, Qs, inf_mask=None):
        seen.append(tuple(Ps.shape[:2]))
        return torch.zeros((Ps.shape[0], 6, 2, lb.NWORDS), dtype=torch.int32)

    fused = []
    monkeypatch.setattr(pr, "pairing_product_staged", staged)
    monkeypatch.setattr(sharding, "_fused_row_group", lambda group, P, Q: fused.append(
        tuple(P.shape)) or torch.zeros((P.shape[0], 6, 2, lb.NWORDS), dtype=torch.int32))
    mesh = make_mesh(8, mp=2, devices=CPU8)
    P3, Q3 = torch.zeros((5, 3, 2, 8), dtype=torch.int32), torch.zeros((5, 3, 2, 2, 8),
                                                                      dtype=torch.int32)
    devobs.reset()
    before = _counter("sharding.fallbacks")
    assert sharded_pairing_product(P3, Q3, mesh, fused=True).shape == (5, 6, 2, 8)
    assert _counter("sharding.fallbacks") - before == 1
    assert seen == [(2, 3)] * 4 and fused == []  # 5 rows padded to 8, 4 groups
    assert mx.FLIGHT.tail(1)[0]["reason"] == "k_not_divisible"
    assert devobs.snapshot()[("stages", "fused_pairing")]["degrades"] == {"k_not_divisible": 1}
    P2, Q2 = P3[:, :2].contiguous(), Q3[:, :2].contiguous()
    sharded_pairing_product(P2, Q2, None, fused=True)  # no mesh: one staged call
    assert seen[-1] == (5, 2) and fused == []
    assert sharded_pairing_product(P2, Q2, mesh, fused=True).shape == (5, 6, 2, 8)
    assert fused == [(2, 2, 2, 8)] * 4
    with pytest.raises(TypeError):
        sharded_pairing_product(P2, Q2, MeshConfig.build(8, 2), fused=True)
    assert _counter("sharding.fallbacks") - before == 1


@pytest.mark.slow
def test_staged_pairing_product_matches_reference_dp_mp():
    """The port's staged product on the logical (4, 2) mesh against the
    JAX package's `pairing_product_staged` with dp = 4 and mp = 2 (slow
    in the reference too: its pairing tiles compile for minutes)."""
    Ps, Qs, rows_P, rows_Q = ps_rows(0xB2, 5, 2)
    ref_P = np.stack([np.asarray(ref_pr.encode_g1(r)) for r in rows_P])
    ref_Q = np.stack([np.asarray(ref_pr.encode_g2(r)) for r in rows_Q])
    want = ref_pr.pairing_product_staged(ref_P, ref_Q, dp=4, mp=2)
    got = sharded_pairing_product(Ps, Qs, make_mesh(8, mp=2, devices=CPU8))
    assert torch.equal(got, lb.from_reference_limbs(np.asarray(want), hm.P))
