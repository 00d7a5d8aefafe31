"""Pairing-product rows for the mesh-plane tests of the PyTorch port
(`tests/test_torch_parallel_pairing.py`, `tests/test_torch_parallel_fused.py`):
not a test module."""

import random

import torch

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, pssign
from fabric_token_sdk_tpu_torch.ops import pairing as pr

# Rows whose product is not one, at different offsets within the dp = 4
# row groups of a ragged B = 5 (groups of 2 after padding: row 1 is the
# second of group 0, row 4 the first of group 2); of B = 3 over dp = 2,
# row 1 alone.
BAD = (1, 4)


def ps_rows(seed, B, K, bad=BAD):
    """B rows of K legs with their host legs. A good row multiplies to GT
    one: a PS check e(-S, Q) e(R, H) padded with pairs (P, Q), (-P, Q),
    so each of its leg halves is one on its own. A row in `bad` has every
    G1 point replaced by a random one, so no span of its legs multiplies
    to one and its value differs from every other row's: comparing GT
    values then checks the order of rows, the padding and the gather of
    the leg spans."""
    rng = random.Random(seed)
    signer = pssign.keygen(1, rng)
    rows_P, rows_Q = [], []
    for i in range(B):
        m = [rng.randrange(100)]
        s = signer.sign(m, rng)
        ps, qs = [hm.g1_neg(s.S), s.R], [signer.Q, signer.message_base(m)]
        while len(ps) < K:
            p, q = hm.rand_g1(rng), hm.rand_g2(rng)
            ps += [p, hm.g1_neg(p)]
            qs += [q, q]
        if i in bad:
            ps = [hm.rand_g1(rng) for _ in ps]
        rows_P.append(ps[:K])
        rows_Q.append(qs[:K])
    Ps = torch.stack([torch.from_numpy(pr.encode_g1(r)) for r in rows_P])
    Qs = torch.stack([torch.from_numpy(pr.encode_g2(r)) for r in rows_Q])
    return Ps, Qs, rows_P, rows_Q


def host_gt(rows_P, rows_Q):
    return [hm.pairing_product(list(zip(p, q))) for p, q in zip(rows_P, rows_Q)]


def ones(B, bad=BAD):
    """The expected GT-is-one verdicts of `ps_rows(..., B, ...)`."""
    return [i not in bad for i in range(B)]


# ------------------------------------------------------------ bound planes

# The logical meshes the bound planes are held on: every cell the CPU.
MESH_SHAPES = {"(2, 1)": (2, 1), "(2, 2)": (4, 2)}
SHARD_COUNTERS = ("stages.sharded_calls", "stages.shards", "pairing.staged.sharded_calls",
                  "pairing.staged.shards")


def cpu_mesh(name):
    """The logical mesh `name` ("(2, 1)" or "(2, 2)") over the CPU."""
    from fabric_token_sdk_tpu_torch.parallel import make_mesh

    n, mp = MESH_SHAPES[name]
    return make_mesh(n, mp=mp, devices=[torch.device("cpu")] * n)


class ShardCounts:
    """The deltas of the mesh plane's counters over a `with` block."""

    def __enter__(self):
        from fabric_token_sdk_tpu_torch.utils import metrics as mx

        self._reg = mx.REGISTRY
        self._base = {k: self._reg.counter(k).value for k in SHARD_COUNTERS}
        return self

    def __exit__(self, *exc):
        self.delta = {k: self._reg.counter(k).value - v for k, v in self._base.items()}
        return False
