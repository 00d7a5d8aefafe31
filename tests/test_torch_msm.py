"""PyTorch port, fixed-base multiexp (`g1_msm_rows`, nbases 1/2/3) and
`FixedBaseTable` against hostmath and the JAX package's g1_msm tiles.

Same bases and scalars (from `random.Random(seed)`) go to both packages.
The port returns canonical Jacobian words; the reference returns
redundant 8-bit limbs, which `from_reference_limbs` canonicalizes. The
two must be EQUAL as Jacobian coordinates, not only as affine points,
because both add the same window entries in the same order."""

import random

import numpy as np
import pytest
import torch

from fabric_token_sdk_tpu.crypto import hostmath as ref_hm
from fabric_token_sdk_tpu.ops import curve as ref_cv, stages as ref_st
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import curve as cv, limbs as lb, stages as st


def _bases(seed, n):
    rng = random.Random(seed)
    return [hm.g1_mul(hm.G1_GEN, rng.randrange(1, hm.R)) for _ in range(n)]


def _scalar_rows(seed, nbases, n=5):
    rng = random.Random(seed)
    rows = [[0] * nbases, [1] * nbases, [hm.R - 1] * nbases]
    return rows + [[rng.randrange(hm.R) for _ in range(nbases)] for _ in range(n - 3)]


@pytest.mark.parametrize("nbases", [1, 2, 3])
def test_g1_msm_rows_matches_reference_and_hostmath(nbases):
    bases = _bases(100 + nbases, nbases)
    rows = _scalar_rows(200 + nbases, nbases)
    flat = [s for r in rows for s in r]
    table = cv.FixedBaseTable(bases)
    got = st.g1_msm_rows(table.table, torch.from_numpy(cv.encode_scalars(flat).reshape(len(rows), nbases, 8)))
    assert got.dtype == torch.int32 and got.shape == (len(rows), 3, 8)
    assert cv.decode_points(got) == [ref_hm.g1_multiexp(bases, r) for r in rows]

    ref_table = ref_cv.FixedBaseTable(bases)
    ref_out = ref_st.g1_msm_rows(
        np.asarray(ref_table.flat), ref_cv.encode_scalars(flat).reshape(len(rows), nbases, -1)
    )
    assert torch.equal(got, lb.from_reference_limbs(ref_out, hm.P))


def test_fixed_base_table_carries_over_from_reference():
    bases = _bases(300, 3)
    ref_flat = np.asarray(ref_cv.FixedBaseTable(bases).flat)  # (192, 16, 96)
    table = cv.FixedBaseTable.from_reference(ref_flat)
    assert table.nbases == 3 and tuple(table.table.shape) == (192, 16, 3, 8)
    assert torch.equal(table.table, cv.FixedBaseTable(bases).table)
    back = lb.to_reference_limbs(table.table).reshape(ref_flat.shape)
    assert np.array_equal(back, ref_flat)  # reference tables are canonical
    # a registered buffer: .to() moves it, state_dict carries it
    assert "table" in dict(table.named_buffers())
    assert table.to("cpu").table.device.type == "cpu"
    assert torch.equal(table.state_dict()["table"], table.table)


def test_scalar_and_point_encodings_match_reference():
    rng = random.Random(301)
    ks = [0, 1, hm.R - 1, hm.R, -1] + [rng.getrandbits(300) for _ in range(5)]
    assert np.array_equal(lb.to_reference_limbs(cv.encode_scalars(ks)), ref_cv.encode_scalars(ks))
    pts = _bases(302, 4) + [None]
    ref = np.stack([ref_cv.encode_point(p) for p in pts])
    assert np.array_equal(lb.to_reference_limbs(cv.encode_points(pts)), ref)
    assert cv.decode_points(cv.encode_points(pts)) == pts
    assert cv.decode_points(torch.from_numpy(cv.encode_points(pts))) == ref_cv.decode_points(ref)


def test_g1_msm_rows_rejects_bad_input():
    table = cv.FixedBaseTable(_bases(303, 2))
    with pytest.raises(ValueError):
        st.g1_msm_rows(table.table, torch.zeros((2, 3, 8), dtype=torch.int32))  # 3 scalars, 2 bases
    with pytest.raises(ValueError):
        st.g1_msm_rows(table.table, torch.zeros((0, 2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        cv.FixedBaseTable(table=torch.zeros((65, 16, 3, 8), dtype=torch.int32))
