"""Long-term identity signatures: Schnorr over BN254 G1.

Capability parity with reference `crypto/ecdsa/ecdsa.go` (signing
identities for issuers/auditors built on mathlib curves). We use Schnorr
rather than ECDSA — same API shape (keygen/sign/verify, serializable
public keys), simpler and pairing-free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from . import hostmath as hm
from .serialization import guard, dumps, g1s_bytes, loads


@dataclass
class PublicKey:
    point: tuple  # G1 = g^sk

    def to_bytes(self) -> bytes:
        return hm.g1_to_bytes(self.point)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PublicKey":
        return cls(hm.g1_from_bytes(raw))

    @guard
    def verify(self, message: bytes, sig_raw: bytes) -> None:
        d = loads(sig_raw)
        chal, resp = d["c"], d["z"]
        # com = g^z · pk^{-c}; the negation rides the SCALAR, so this is
        # verbatim the response equation the batched plane's sub tile
        # evaluates (`crypto/batch_sign.py`: msm(g, z) - mul(pk, c)) —
        # one equation, two executors, differential-pinned in
        # tests/test_batch_sign.py
        com = response_commitment(self.point, chal, resp)
        if challenge(self.point, com, message) != chal:
            raise ValueError("invalid signature")


@dataclass
class SigningKey:
    sk: int
    public: PublicKey

    def sign(self, message: bytes, rng=None) -> bytes:
        rho = hm.rand_zr(rng)
        com = hm.g1_mul(hm.G1_GEN, rho)
        chal = _challenge(self.public.point, com, message)
        return dumps({"c": chal, "z": (rho + chal * self.sk) % hm.R})


def keygen(rng=None) -> SigningKey:
    sk = hm.rand_zr(rng)
    return SigningKey(sk, PublicKey(hm.g1_mul(hm.G1_GEN, sk)))


def response_commitment(pk_point, chal: int, resp: int):
    """The shared response equation: com = g^resp · pk^{-chal} with the
    negation folded into the scalar (group order R, so -c ≡ R - c). The
    batched plane computes the identical point via the stage tiles."""
    return hm.g1_add(
        hm.g1_mul(hm.G1_GEN, resp), hm.g1_mul(pk_point, -chal % hm.R)
    )


def challenge(pk_point, com, message: bytes) -> int:
    """Fiat-Shamir challenge binding (pk, commitment, message)."""
    return hm.hash_to_zr(message + g1s_bytes([pk_point, com]), b"fts/schnorr-sig")


def verify_many(rows):
    """Host-batched Schnorr verification over (pk_point, message, sig_raw)
    rows — the row format the block sign collector emits.

    Two block-wide dispatches replace 2N scalar ctypes round trips and 2N
    hashlib calls: one `hm.g1_multiexp_rows` recomputes every response
    commitment (each row is (g, pk) x (z, -c), the exact
    `response_commitment` algebra) and one `hm.hash_to_zr_many`
    recomputes every challenge. Returns one entry per row: True (valid),
    False (challenge mismatch) or None (signature this batch could not
    evaluate — the scalar path owns the precise error). Challenges are
    byte-identical to `PublicKey.verify` by construction
    (differential-pinned in tests/test_host_batch.py).
    """
    rows = list(rows)
    out = [None] * len(rows)
    parsed = []  # (row index, pk_point, message, chal, resp)
    for i, (pk_point, message, sig_raw) in enumerate(rows):
        try:
            d = loads(sig_raw)
            chal, resp = d["c"], d["z"]
            if not isinstance(chal, int) or not isinstance(resp, int):
                raise ValueError("non-integer signature fields")
        except Exception:
            continue
        parsed.append((i, pk_point, message, chal, resp))
    if not parsed:
        return out
    coms = hm.g1_multiexp_rows(
        [[hm.G1_GEN, pk] for _i, pk, _m, _c, _z in parsed],
        [[resp, -chal % hm.R] for _i, _pk, _m, chal, resp in parsed],
    )
    transcripts = []  # (row index, expected chal) aligned with transcripts
    keep = []
    for (i, pk, message, chal, _z), com in zip(parsed, coms):
        try:
            transcripts.append(
                (message + g1s_bytes([pk, com]), b"fts/schnorr-sig")
            )
            keep.append((i, chal))
        except Exception:
            continue  # un-encodable commitment: scalar path reports it
    for (i, chal), got in zip(keep, hm.hash_to_zr_many(transcripts)):
        out[i] = got == chal
    return out


_challenge = challenge  # backwards-compatible private alias
