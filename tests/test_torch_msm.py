"""PyTorch port, fixed-base multiexp (`g1_msm_rows`, nbases 1/2/3) and
`FixedBaseTable` against hostmath and the JAX package's g1_msm tiles.

Same bases and scalars (from `random.Random(seed)` or a seeded numpy
generator) go to both packages. The port returns canonical Jacobian
words; the reference returns redundant 8-bit limbs, which
`from_reference_limbs` canonicalizes. The two are equal as points: the
port splits a row's windows over lanes and adds them in projective
coordinates (`ops/curve.py:msm`, the g1_msm kernels' sequence), so its
Jacobian Z differs from the reference's scan of Jacobian adds."""

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
    assert cv.decode_points(got) == cv.decode_points(lb.from_reference_limbs(ref_out, hm.P))


def _np_scalar_rows(seed, nbases, n=6):
    """Edge rows (0, 1, r-1, every digit 15, one window, a zero scalar
    beside random ones) and random rows, the random words from a seeded
    numpy generator."""
    gen = np.random.default_rng(seed)
    rand = [int.from_bytes(gen.bytes(32), "little") % hm.R for _ in range(n * nbases)]
    rows = [[0] * nbases, [1] * nbases, [hm.R - 1] * nbases, [(1 << 256) - 1] * nbases,
            [5 << (4 * 63)] * nbases]
    rows += [rand[i * nbases:(i + 1) * nbases] for i in range(n)]
    rows[-1][0] = 0
    return rows


@pytest.mark.parametrize("select", [False, True], ids=["gather", "select"])
@pytest.mark.parametrize("nbases", [1, 2, 3])
def test_split_msm_plain_matches_reference_as_points(nbases, select):
    """The plain version of both kernels (the split windows, the complete
    projective additions, the butterfly) against the JAX package's
    `g1_msm_rows` on the same table and scalar words, as affine points;
    the two forms give the same words."""
    bases = _bases(120 + nbases, nbases)
    rows = _np_scalar_rows(220 + nbases, nbases)
    words = lb.ints_to_words([s for r in rows for s in r]).reshape(len(rows), nbases, 8)
    table = cv.FixedBaseTable(bases)
    sc = torch.from_numpy(words)
    plain = st.g1_msm_select_plain if select else st.g1_msm_plain
    got = plain(table.table, sc)
    ref_out = ref_st.g1_msm_rows(np.asarray(ref_cv.FixedBaseTable(bases).flat),
                                 lb.to_reference_limbs(words))
    assert cv.decode_points(got) == cv.decode_points(lb.from_reference_limbs(ref_out, hm.P))
    assert cv.decode_points(got) == [hm.g1_multiexp(bases, [s % hm.R for s in r]) for r in rows]
    other = st.g1_msm_plain if select else st.g1_msm_select_plain
    assert torch.equal(got, other(table.table, sc))


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


def _with_entry(table, t, d, x, y, z, lift=False):
    """A copy of `table` with entry [t][d] set to the Montgomery words of
    (x, y, z), each moved into [p, 2p) with `lift`."""
    out = table.clone()
    out[t, d] = torch.from_numpy(lb.ints_to_words([v * cv._R_MOD_P % hm.P + (hm.P if lift else 0)
                                                   for v in (x, y, z)]))
    return out


@pytest.mark.parametrize("case", ["jacobian", "infinity_with_xy", "state_dict", "lifted"])
def test_fixed_base_table_refuses_a_non_affine_entry(case):
    """The g1_msm kernels and `msm` read only X and Y of an entry, so a
    table given from outside (`table=`, `from_reference`, a state dict)
    must hold affine entries (Z = 1) or the all-zero infinity: another
    Jacobian Z of the same point, or a Z = 0 with X, Y not zero, raises.
    Coordinates in [p, 2p) with Z = 1 are accepted."""
    bases = _bases(303, 1)
    table = cv.FixedBaseTable(bases).table
    x, y = hm.g1_mul(bases[0], 3 * 16 ** 5)
    lam = 7
    if case == "lifted":  # the same affine entry, every coordinate + p
        bad = _with_entry(table, 5, 3, x, y, 1, lift=True)
        assert torch.equal(cv.FixedBaseTable(table=bad).table, bad)
        return
    if case == "infinity_with_xy":
        bad = _with_entry(table, 5, 0, 1, 1, 0)
    else:  # (lam^2 x, lam^3 y, lam): the same point as entry [5][3]
        bad = _with_entry(table, 5, 3, lam * lam * x % hm.P, lam ** 3 * y % hm.P, lam)
        assert cv.decode_points(bad[5, 3:4]) == cv.decode_points(table[5, 3:4])
    if case == "state_dict":
        module = cv.FixedBaseTable(bases)
        with pytest.raises(ValueError, match="neither affine"):
            module.load_state_dict({"table": bad})
        assert torch.equal(module.table, table)
    else:
        with pytest.raises(ValueError, match="neither affine"):
            cv.FixedBaseTable(table=bad)


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
