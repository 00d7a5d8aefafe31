"""PyTorch port, the mesh plane: `parallel/sharding.py` against the JAX
package's mesh on its 8 virtual CPU devices, hostmath and the port's
calls without a mesh.

The port's mesh here is logical: `make_mesh(..., devices=[cpu] * 8)`,
every cell on the CPU, where each wrapper runs its kernel's plain torch
version (the counterpart of the reference's virtual devices, not a
fallback). Running a batch over a mesh's row groups must never change a
result: the outputs are compared bit for bit. The sharded pairing
products are in `tests/test_torch_parallel_pairing.py` (staged) and
`tests/test_torch_parallel_fused.py` (fused)."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import hostmath as ref_hm
from fabric_token_sdk_tpu.ops import curve as ref_cv
from fabric_token_sdk_tpu.parallel import sharding as ref_sh
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, sign
from fabric_token_sdk_tpu_torch.ops import curve as cv, curve2 as cv2, limbs as lb
from fabric_token_sdk_tpu_torch.ops import pairing as pr, stages as st
from fabric_token_sdk_tpu_torch.parallel import (
    DeviceMesh, MeshConfig, make_mesh, run_rows_dp, shard_rows, sharded_pairing_product,
    sharded_schnorr_rows,
)
from fabric_token_sdk_tpu_torch.parallel import sharding
from fabric_token_sdk_tpu_torch.utils import devobs
from fabric_token_sdk_tpu_torch.utils import metrics as mx

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _counter(name):
    return mx.REGISTRY.counter(name).value


def _mesh(dp, mp=1):
    return make_mesh(dp * mp, mp=mp, devices=CPU8)


def test_mesh_shapes_and_clamping():
    mesh = make_mesh(8, mp=2, devices=CPU8)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"dp": 4, "mp": 2}
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    # a non-dividing mp is clamped to the largest divisor and counted
    before = _counter("sharding.clamped")
    site = _counter("sharding.clamped.make_mesh")
    flights = len(mx.FLIGHT)
    assert make_mesh(8, mp=3, devices=CPU8).shape == {"dp": 4, "mp": 2}
    assert _counter("sharding.clamped") - before == 1
    assert _counter("sharding.clamped.make_mesh") - site == 1
    assert mx.FLIGHT.tail(1)[0]["kind"] == "sharding.clamped" and len(mx.FLIGHT) > flights
    assert make_mesh(3, mp=1, devices=CPU8).shape == {"dp": 3, "mp": 1}


def test_make_mesh_raises_without_enough_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(9, devices=CPU8)


def test_mesh_config_build_and_of():
    cfg = MeshConfig.build(8, 2)
    assert (cfg.n_devices, cfg.dp, cfg.mp) == (8, 4, 2)
    before = _counter("sharding.clamped")
    cfg = MeshConfig.build(6, 4)  # 4 does not divide 6 -> clamp to 3
    assert (cfg.dp, cfg.mp) == (2, 3)
    assert _counter("sharding.clamped") - before == 1
    assert MeshConfig.of(make_mesh(8, mp=2, devices=CPU8)) == MeshConfig(8, 4, 2)
    assert MeshConfig.of(cfg) is cfg
    assert MeshConfig.of(None) is None
    # the reference's own mesh coerces to the same config
    assert MeshConfig.of(ref_sh.make_mesh(8, mp=2)) == MeshConfig(8, 4, 2)


def test_entry_points_refuse_a_mesh_config():
    """A MeshConfig is a shape: it names no device, so nothing can be
    placed by it, and the entry points say so instead of ignoring it."""
    cfg = MeshConfig.build(8, 2)
    x = torch.zeros((3, 3, lb.NWORDS), dtype=torch.int32)
    for call in (lambda: run_rows_dp(st.g1_add_rows, x, x, mesh=cfg),
                 lambda: sharded_schnorr_rows(x, x, x, x[:, 0], mesh=cfg),
                 lambda: sharded_pairing_product(x, x, cfg, fused=True)):
        with pytest.raises(TypeError, match="MeshConfig names no devices"):
            call()


def test_shard_rows_pads_ragged_batch():
    mesh = make_mesh(8, mp=2, devices=CPU8)  # dp = 4
    rng = random.Random(3)
    pts = torch.from_numpy(cv.encode_points([hm.rand_g1(rng) for _ in range(5)]))
    before = _counter("sharding.padded_rows")
    placed = shard_rows(pts, mesh)
    assert placed.shape[0] == 8  # 5 -> the next multiple of dp = 4
    assert _counter("sharding.padded_rows") - before == 3
    assert torch.equal(placed[:5], pts)
    assert torch.equal(placed[5:], pts[:1].expand(3, 3, 8))
    before = _counter("sharding.padded_rows")
    assert torch.equal(shard_rows(pts[:4].numpy(), mesh), pts[:4])  # aligned: untouched
    assert _counter("sharding.padded_rows") == before


@pytest.mark.parametrize("dp", [1, 2, 3, 5])
def test_row_groups_cover_the_rows_in_order(dp):
    """Row group i gets rows [i*b, (i+1)*b) of the batch padded to a dp
    multiple, on the first device of mesh row i; the results come back
    in row order with the padding sliced off."""
    mesh = _mesh(dp)
    x = torch.arange(11 * 2).reshape(11, 2)
    y = -x
    seen = []

    def body(group, a, b):
        seen.append((group, a[:, 0].tolist(), b[:, 0].tolist()))
        return a + b.abs()

    before = _counter("sharding.padded_rows")
    got = sharding._on_row_groups(body, (x, y), mesh)
    assert torch.equal(got, 2 * x)
    pad = (-11) % dp
    assert _counter("sharding.padded_rows") - before == pad
    rows = list(range(0, 22, 2)) + [0] * pad  # padded by repeating row 0
    b = len(rows) // dp
    assert seen == [(mesh.devices[i], rows[i * b:(i + 1) * b], [-r for r in rows[i * b:(i + 1) * b]])
                    for i in range(dp)]


# ------------------------------------------------------------------ row groups

N_ROWS = 11  # ragged: uneven spans for every dp below


@pytest.fixture(scope="module")
def stage_cases():
    """name -> (rows function, inputs, result without a mesh) for each
    `*_rows` function whose plain version is cheap on the CPU; the
    variable-base ladders, the Miller loop and the final exponentiation
    run on meshes in the Schnorr and pairing tests and in the slow
    matrix."""
    rng = random.Random(0x5EED)
    g1 = torch.from_numpy(cv.encode_points([hm.rand_g1(rng) for _ in range(N_ROWS)]))
    g1b = torch.from_numpy(cv.encode_points([hm.rand_g1(rng) for _ in range(N_ROWS)]))
    g2pts = [hm.rand_g2(rng) for _ in range(2)]
    g2 = torch.from_numpy(cv2.encode_points([g2pts[i % 2] for i in range(N_ROWS)]))
    g2b = torch.from_numpy(cv2.encode_points([g2pts[(i + 1) % 2] for i in range(N_ROWS)]))
    table = cv.FixedBaseTable([hm.rand_g1(rng) for _ in range(3)]).table
    msm = torch.from_numpy(cv.encode_scalars([rng.randrange(hm.R) for _ in range(3 * N_ROWS)])
                           .reshape(N_ROWS, 3, lb.NWORDS))
    f = torch.from_numpy(lb.ints_to_words([rng.randrange(hm.P) for _ in range(N_ROWS * 24)])
                         .reshape(N_ROWS, 2, 6, 2, lb.NWORDS))
    cases = {
        "g1_msm": (st.g1_msm_rows, (msm,), (table,)),
        "g1_msm_select": (st.g1_msm_select_rows, (msm,), (table,)),
        "g1_add": (st.g1_add_rows, (g1, g1b), ()),
        "g1_sub": (st.g1_sub_rows, (g1, g1b), ()),
        "g1_to_affine": (st.g1_to_affine_rows, (g1,), ()),
        "g2_add": (st.g2_add_rows, (g2, g2b), ()),
        "g2_to_affine": (st.g2_to_affine_rows, (g2,), ()),
        "gt_product": (st.gt_product_rows, (f,), ()),
    }
    return {name: (fn, arrays, consts, run_rows_dp(fn, *arrays, consts=consts))
            for name, (fn, arrays, consts) in cases.items()}


@pytest.mark.parametrize("dp", [2, 3, 5])
@pytest.mark.parametrize("name", ["g1_msm", "g1_msm_select", "g1_add", "g1_sub", "g1_to_affine",
                                  "g2_add", "g2_to_affine", "gt_product"])
def test_run_rows_dp_bit_identical(stage_cases, name, dp):
    """Over a logical mesh of dp row groups (11 rows: ragged for each
    dp): one call a group, the result equal to the call without a
    mesh."""
    fn, arrays, consts, base = stage_cases[name]
    calls = _counter("stages.calls")
    assert torch.equal(run_rows_dp(fn, *arrays, consts=consts, mesh=_mesh(dp)), base)
    assert _counter("stages.calls") - calls == dp


def test_run_rows_dp_on_a_4x2_mesh(stage_cases):
    """The (4, 2) mesh's 4 row groups (mp does not split rows); no mesh
    is one call."""
    fn, arrays, consts, base = stage_cases["g1_add"]
    calls = _counter("stages.calls")
    assert torch.equal(run_rows_dp(fn, *arrays, mesh=_mesh(4, 2)), base)
    assert _counter("stages.calls") - calls == 4
    calls = _counter("stages.calls")
    assert torch.equal(run_rows_dp(fn, *arrays), base)
    assert _counter("stages.calls") - calls == 1


@pytest.mark.slow
@pytest.mark.parametrize("name", ["g1_mul", "g2_mul", "miller", "final_exp"])
def test_heavy_stage_rows_dp_bit_identical(name):
    """The variable-base ladders, the Miller loop and the final
    exponentiation over dp in {2, 3, 5} row groups (each group a whole
    plain call of several seconds on the CPU)."""
    rng = random.Random(0xD0)
    n = 5
    g1 = torch.from_numpy(cv.encode_points([hm.rand_g1(rng) for _ in range(n)]))
    g2 = torch.from_numpy(cv2.encode_points([hm.rand_g2(rng) for _ in range(n)]))
    k = torch.from_numpy(cv.encode_scalars([rng.randrange(hm.R) for _ in range(n)]))
    P = torch.from_numpy(pr.encode_g1([hm.rand_g1(rng) for _ in range(n)]))
    Q = torch.from_numpy(pr.encode_g2([hm.rand_g2(rng) for _ in range(n)]))
    fn, arrays = {
        "g1_mul": (st.g1_mul_rows, (g1, k)),
        "g2_mul": (st.g2_mul_rows, (g2, k)),
        "miller": (st.miller_rows, (P, Q)),
        "final_exp": (st.final_exp_rows, (st.miller_rows(P, Q),)),
    }[name]
    base = fn(*arrays)
    for dp in (2, 3, 5):
        assert torch.equal(run_rows_dp(fn, *arrays, mesh=_mesh(dp)), base), dp


def test_dispatch_is_recorded_on_the_ledger(stage_cases):
    fn, arrays, consts, _ = stage_cases["g1_add"]
    devobs.reset()
    run_rows_dp(fn, *arrays, mesh=_mesh(3))
    e = devobs.snapshot()["g1_add_rows"]
    assert (e["dispatches"], e["rows"], e["padded_rows"], e["dp"], e["mp"]) == (1, N_ROWS, 1, 3, 1)
    assert e["degrades"] == {}


# ------------------------------------------------------------------ errors

def test_dispatch_error_propagates_no_sequential_fallback(stage_cases, monkeypatch):
    """A deliberate divergence from the reference, whose span dispatch
    re-runs the call unsharded after any error (`sharding.fallbacks`):
    here a failing row group (the third launch) reaches the caller, and
    the ledger records no dispatch."""
    fn, arrays, consts, _ = stage_cases["g1_add"]
    before = _counter("sharding.fallbacks")
    calls = []

    def flaky(a, b, negate_b):
        calls.append(a.shape[0])
        if len(calls) == 3:
            raise MemoryError("injected row-group fault")
        return real(a, b, negate_b)

    real = st.g1_addsub_plain
    monkeypatch.setattr(st, "g1_addsub_plain", flaky)
    devobs.reset()
    with pytest.raises(MemoryError, match="injected row-group fault"):
        run_rows_dp(fn, *arrays, mesh=_mesh(4))
    assert calls == [3, 3, 3]
    assert _counter("sharding.fallbacks") == before
    assert devobs.snapshot() == {}


# ------------------------------------------------------------------ Schnorr rows

def _schnorr_rows(rng, n):
    keys = [sign.keygen(rng) for _ in range(n)]
    chals = [rng.randrange(hm.R) for _ in range(n)]
    resps = [rng.randrange(hm.R) for _ in range(n)]
    return [k.public.point for k in keys], chals, resps


def test_sharded_schnorr_rows_matches_reference_and_host():
    """com = g^z - pk^c over the 4 row groups of the logical (4, 2) mesh:
    equal, as group elements, to the JAX package's `sharded_schnorr_rows`
    on its 8-device mesh (pk^c comes from the port's window ladder, the
    reference's from its bit ladder: same points, another Jacobian Z),
    and to the host response equation `sign.response_commitment`; and
    bit-identical to the port's unsharded rows."""
    rng = random.Random(0x5C)
    N = 18
    pks, chals, resps = _schnorr_rows(rng, N)
    table = cv.FixedBaseTable([hm.G1_GEN])
    resp_t = torch.from_numpy(cv.encode_scalars(resps)).reshape(N, 1, lb.NWORDS)
    pk_t = torch.from_numpy(cv.encode_points(pks))
    chal_t = torch.from_numpy(cv.encode_scalars(chals))
    mesh = make_mesh(8, mp=2, devices=CPU8)
    calls = _counter("stages.calls")
    got = sharded_schnorr_rows(table, resp_t, pk_t, chal_t, mesh)
    assert _counter("stages.calls") - calls == 3 * 4  # msm, mul, sub a row group
    assert torch.equal(got, sharded_schnorr_rows(table.table, resp_t, pk_t, chal_t, mesh=None))
    assert cv.decode_points(got) == [sign.response_commitment(pk, c, z)
                                     for pk, c, z in zip(pks, chals, resps)]
    ref = ref_sh.sharded_schnorr_rows(
        ref_cv.FixedBaseTable([ref_hm.G1_GEN]),
        np.asarray(ref_cv.encode_scalars(resps))[:, None, :],
        np.stack([np.asarray(ref_cv.encode_point(pk)) for pk in pks]),
        np.asarray(ref_cv.encode_scalars(chals)),
        mesh=ref_sh.make_mesh(8, mp=2),
    )
    assert cv.decode_points(got) == cv.decode_points(lb.from_reference_limbs(np.asarray(ref), hm.P))
