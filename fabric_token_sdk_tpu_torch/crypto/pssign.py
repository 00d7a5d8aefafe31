"""Pointcheval-Sanders multi-message signatures + blind issuance.

Reference: `crypto/pssign/sign.go` (keygen/sign/verify/randomize) and
`crypto/pssign/blindsign.go` (ElGamal-encrypted blind signing with a
correctness proof). The signature underlies range-proof set membership and
PS-credential pseudonyms.

Scheme (asymmetric, messages m_1..m_l, plus an appended hash message):
  SK = (x_0 .. x_{l+1});  Q random G2;  PK_i = Q^{x_i}
  Sign:  R random G1;  S = R^{x_0 + sum_i x_i m_i + x_{l+1} H(m)}
  Verify: e(-S, Q) * e(R, PK_0 + sum PK_i^{m_i} + PK_{l+1}^{H(m)}) == 1
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import elgamal, hostmath as hm, schnorr
from .serialization import dumps, g1s_bytes, g2s_bytes, loads, zrs_bytes


def hash_messages(messages: Sequence[int]) -> int:
    """m_{l+1} = H(m_1..m_l) (reference sign.go:198-206)."""
    return hm.hash_to_zr(zrs_bytes(messages), b"fts/ps-msgs")


@dataclass
class Signature:
    R: tuple  # G1
    S: tuple  # G1

    def to_bytes(self) -> bytes:
        return dumps({"r": self.R, "s": self.S})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Signature":
        d = loads(raw)
        return cls(d["r"], d["s"])

    def transcript_bytes(self) -> bytes:
        return g1s_bytes([self.R, self.S])


@dataclass
class SignVerifier:
    pk: List[tuple]  # G2 points, length l+2
    Q: tuple  # G2

    def message_base(self, messages: Sequence[int], msg_hash: Optional[int] = None):
        """PK_0 + sum PK_{i+1}^{m_i} + PK_{l+1}^{H(m)} in G2."""
        if msg_hash is None:
            msg_hash = hash_messages(messages)
        if len(messages) != len(self.pk) - 2:
            raise ValueError("PS verify: message count does not match public key")
        acc = self.pk[0]
        for i, m in enumerate(messages):
            acc = hm.g2_add(acc, hm.g2_mul(self.pk[i + 1], m))
        return hm.g2_add(acc, hm.g2_mul(self.pk[-1], msg_hash))

    def verify(self, messages: Sequence[int], sig: Signature) -> None:
        self.verify_with_hash(messages, None, sig)

    def verify_with_hash(self, messages, msg_hash: Optional[int], sig: Signature) -> None:
        """Verify with an explicit hash message (used by blind signing,
        where the hash binds the request proof instead of the messages)."""
        if sig.R is None or sig.S is None:
            raise ValueError("PS verify: nil signature")
        h = self.message_base(messages, msg_hash)
        ok = hm.gt_is_unity(
            hm.pairing_product([(hm.g1_neg(sig.S), self.Q), (sig.R, h)])
        )
        if not ok:
            raise ValueError("invalid Pointcheval-Sanders signature")

    def randomize(self, sig: Signature, rng=None) -> Signature:
        r = hm.rand_zr(rng)
        return Signature(hm.g1_mul(sig.R, r), hm.g1_mul(sig.S, r))


@dataclass
class Signer(SignVerifier):
    sk: List[int]

    def sign(self, messages: Sequence[int], rng=None) -> Signature:
        if len(messages) != len(self.sk) - 2:
            raise ValueError("PS sign: message count does not match secret key")
        R = hm.g1_mul(hm.G1_GEN, hm.rand_zr(rng))
        exp = self.sk[0]
        for i, m in enumerate(messages):
            exp = (exp + self.sk[i + 1] * m) % hm.R
        exp = (exp + self.sk[-1] * hash_messages(messages)) % hm.R
        return Signature(R, hm.g1_mul(R, exp))


def keygen(length: int, rng=None) -> Signer:
    """Keys to sign vectors of `length` messages (reference sign.go:43-66)."""
    Q = hm.g2_mul(hm.G2_GEN, hm.rand_zr(rng))
    sk = [hm.rand_zr(rng) for _ in range(length + 2)]
    pk = [hm.g2_mul(Q, x) for x in sk]
    return Signer(pk=pk, Q=Q, sk=sk)


# ===================================================================
# Blind signing (reference blindsign.go): the recipient commits to the
# messages, ElGamal-encrypts them, proves consistency; the signer signs
# homomorphically over the ciphertexts; the recipient decrypts + verifies.
# ===================================================================


@dataclass
class EncProof:
    messages: List[int]
    enc_randomness: List[int]
    com_bf: int
    challenge: int

    def to_bytes(self) -> bytes:
        return dumps(
            {"m": self.messages, "e": self.enc_randomness, "b": self.com_bf, "c": self.challenge}
        )


@dataclass
class BlindSignRequest:
    commitment: tuple  # Pedersen commitment to messages
    ciphertexts: List[elgamal.Ciphertext]
    proof: EncProof
    enc_pk: elgamal.PublicKey


@dataclass
class BlindSignResponse:
    msg_hash: int
    ciphertext: elgamal.Ciphertext


def _enc_challenge(ped, com, enc_pk, cts, c1_coms, c2_coms, com_com) -> int:
    raw = g1s_bytes(
        ped,
        [com, enc_pk.gen, enc_pk.h],
        [c.c1 for c in cts],
        [c.c2 for c in cts],
        c1_coms,
        c2_coms,
        [com_com],
    )
    return hm.hash_to_zr(raw, b"fts/ps-blind")


class Recipient:
    """Requests a blind PS signature on committed messages."""

    def __init__(self, messages, com_bf, commitment, enc_sk, ped_params, verifier, rng=None):
        self.messages = list(messages)
        self.com_bf = com_bf
        self.commitment = commitment
        self.enc_sk = enc_sk
        self.ped = list(ped_params)  # length l+1: bases for messages + bf
        self.verifier = verifier
        self.rng = rng
        self.enc_randomness: List[int] = []

    def request(self) -> BlindSignRequest:
        pk = self.enc_sk.pk
        # messages are encrypted in the exponent over the signature base
        # hash_to_g1(commitment) — the same base the signer uses for R
        # (reference blindsign.go:294-299)
        base = hm.hash_to_g1(hm.g1_to_bytes(self.commitment), b"fts/ps-base")
        cts = []
        self.enc_randomness = []
        for m in self.messages:
            ct, r = pk.encrypt_zr(m, base, self.rng)
            cts.append(ct)
            self.enc_randomness.append(r)
        # prove: commitment opens to messages AND ciphertexts encrypt them
        rho_m = [hm.rand_zr(self.rng) for _ in self.messages]
        rho_e = [hm.rand_zr(self.rng) for _ in self.messages]
        rho_bf = hm.rand_zr(self.rng)
        c1_coms = [hm.g1_mul(pk.gen, rho_e[i]) for i in range(len(self.messages))]
        c2_coms = [
            hm.g1_add(hm.g1_mul(base, rho_m[i]), hm.g1_mul(pk.h, rho_e[i]))
            for i in range(len(self.messages))
        ]
        com_com = hm.g1_multiexp(self.ped, rho_m + [rho_bf])
        chal = _enc_challenge(self.ped, self.commitment, pk, cts, c1_coms, c2_coms, com_com)
        proof = EncProof(
            messages=schnorr.respond(self.messages, rho_m, chal),
            enc_randomness=schnorr.respond(self.enc_randomness, rho_e, chal),
            com_bf=schnorr.respond([self.com_bf], [rho_bf], chal)[0],
            challenge=chal,
        )
        return BlindSignRequest(self.commitment, cts, proof, pk)

    def unblind(self, resp: BlindSignResponse) -> Signature:
        S = self.enc_sk.decrypt(resp.ciphertext)
        R = hm.hash_to_g1(hm.g1_to_bytes(self.commitment), b"fts/ps-base")
        sig = Signature(R, S)
        self.verifier.verify_with_hash(self.messages, resp.msg_hash, sig)
        return sig


# Backwards-compatible alias: verification with an explicit hash lives on
# SignVerifier directly.
VerifierWithHash = SignVerifier


class BlindSigner:
    def __init__(self, signer: Signer, ped_params):
        self.signer = signer
        self.ped = list(ped_params)

    def blind_sign(self, req: BlindSignRequest) -> BlindSignResponse:
        if len(req.ciphertexts) != len(self.signer.sk) - 2:
            raise ValueError("blind sign: ciphertext count does not match key")
        verify_enc_proof(self.ped, req)
        msg_hash = hm.hash_to_zr(req.proof.to_bytes(), b"fts/ps-blind-hash")
        base = hm.hash_to_g1(hm.g1_to_bytes(req.commitment), b"fts/ps-base")
        sk = self.signer.sk
        c1 = None
        c2 = hm.g1_mul(base, sk[0])
        for i, ct in enumerate(req.ciphertexts):
            c1 = hm.g1_add(c1, hm.g1_mul(ct.c1, sk[i + 1]))
            c2 = hm.g1_add(c2, hm.g1_mul(ct.c2, sk[i + 1]))
        c2 = hm.g1_add(c2, hm.g1_mul(base, sk[-1] * msg_hash % hm.R))
        return BlindSignResponse(msg_hash, elgamal.Ciphertext(c1, c2))


def verify_enc_proof(ped, req: BlindSignRequest) -> None:
    """Check the recipient's commitment/encryption consistency proof."""
    p, pk = req.proof, req.enc_pk
    n = len(req.ciphertexts)
    if len(p.messages) != n or len(p.enc_randomness) != n:
        raise ValueError("blind sign: malformed proof")
    c = p.challenge
    base = hm.hash_to_g1(hm.g1_to_bytes(req.commitment), b"fts/ps-base")
    c1_coms = [
        hm.g1_add(hm.g1_mul(pk.gen, p.enc_randomness[i]), hm.g1_neg(hm.g1_mul(req.ciphertexts[i].c1, c)))
        for i in range(n)
    ]
    c2_coms = [
        hm.g1_add(
            hm.g1_add(hm.g1_mul(base, p.messages[i]), hm.g1_mul(pk.h, p.enc_randomness[i])),
            hm.g1_neg(hm.g1_mul(req.ciphertexts[i].c2, c)),
        )
        for i in range(n)
    ]
    com_com = hm.g1_add(
        hm.g1_multiexp(ped, p.messages + [p.com_bf]),
        hm.g1_neg(hm.g1_mul(req.commitment, c)),
    )
    if _enc_challenge(ped, req.commitment, pk, req.ciphertexts, c1_coms, c2_coms, com_com) != c:
        raise ValueError("invalid blind-sign request proof")
