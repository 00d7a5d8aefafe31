"""zkatdlog public parameters + trusted setup (reference `crypto/setup.go`).

PublicParams carry: Pedersen generators, range-proof parameters (PS public
key, Q, PS signatures on 0..base-1, exponent), nym (pseudonym) generators,
auditor/issuer identities, and the quantity precision.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

from . import hostmath as hm, pssign
from .serialization import dumps, loads

DLOG_LABEL = "zkatdlog"
DEFAULT_PRECISION = 64


@dataclass
class RangeProofParams:
    sign_pk: List[tuple]  # 3 x G2
    Q: tuple  # G2
    signed_values: List[pssign.Signature]  # PS sigs on 0..base-1
    exponent: int

    @property
    def base(self) -> int:
        return len(self.signed_values)

    def validate(self) -> None:
        if len(self.sign_pk) != 3:
            raise ValueError(
                f"invalid range proof parameters: signature public key should be 3, got {len(self.sign_pk)}"
            )
        if len(self.signed_values) < 2:
            raise ValueError("invalid range proof parameters: signed values should be >= 2")
        if self.Q is None:
            raise ValueError("invalid range proof parameters: generator Q is nil")
        if self.exponent == 0:
            raise ValueError("invalid range proof parameters: exponent is 0")


@dataclass
class PublicParams:
    label: str = DLOG_LABEL
    curve: str = "bn254"
    ped_gen: Optional[tuple] = None  # G1: obfuscation base / PedGen
    ped_params: List[tuple] = field(default_factory=list)  # 3 x G1
    range_params: Optional[RangeProofParams] = None
    nym_params: List[tuple] = field(default_factory=list)  # 2 x G1 (pseudonyms)
    auditor: bytes = b""
    issuers: List[bytes] = field(default_factory=list)
    quantity_precision: int = DEFAULT_PRECISION

    # ---- capability flags (driver API parity: setup.go:99-108) ----
    def token_data_hiding(self) -> bool:
        return True

    def graph_hiding(self) -> bool:
        return False

    def identifier(self) -> str:
        return self.label

    def max_token_value(self) -> int:
        return self.range_params.base ** self.range_params.exponent - 1

    def precision(self) -> int:
        return self.quantity_precision

    def add_auditor(self, identity: bytes) -> None:
        self.auditor = identity

    def add_issuer(self, identity: bytes) -> None:
        self.issuers.append(identity)

    def auditors(self) -> List[bytes]:
        return [self.auditor] if self.auditor else []

    # ---------------------------------------------------- serialization

    def serialize(self) -> bytes:
        return dumps(
            {
                "identifier": self.label,
                "curve": self.curve,
                "ped_gen": self.ped_gen,
                "ped_params": self.ped_params,
                "range": {
                    "pk": self.range_params.sign_pk,
                    "q": self.range_params.Q,
                    "sigs": [[s.R, s.S] for s in self.range_params.signed_values],
                    "exp": self.range_params.exponent,
                },
                "nym": self.nym_params,
                "auditor": self.auditor,
                "issuers": list(self.issuers),
                "precision": self.quantity_precision,
            }
        )

    @classmethod
    def deserialize(cls, raw: bytes, label: str = DLOG_LABEL) -> "PublicParams":
        d = loads(raw)
        if d["identifier"] != label:
            raise ValueError(
                f"invalid identifier, expecting [{label}], got [{d['identifier']}]"
            )
        rp = RangeProofParams(
            sign_pk=d["range"]["pk"],
            Q=d["range"]["q"],
            signed_values=[pssign.Signature(r, s) for r, s in d["range"]["sigs"]],
            exponent=d["range"]["exp"],
        )
        return cls(
            label=d["identifier"],
            curve=d["curve"],
            ped_gen=d["ped_gen"],
            ped_params=d["ped_params"],
            range_params=rp,
            nym_params=d["nym"],
            auditor=d["auditor"],
            issuers=d["issuers"],
            quantity_precision=d["precision"],
        )

    def compute_hash(self) -> bytes:
        return hashlib.sha256(self.serialize()).digest()

    def validate(self) -> None:
        if self.ped_gen is None:
            raise ValueError("invalid public parameters: nil Pedersen generator")
        if len(self.ped_params) != 3:
            raise ValueError(
                f"invalid public parameters: length mismatch in Pedersen parameters [{len(self.ped_params)} vs. 3]"
            )
        if len(self.nym_params) != 2:
            raise ValueError("invalid public parameters: nym parameters should be 2")
        if self.range_params is None:
            raise ValueError("invalid public parameters: nil range proof parameters")
        self.range_params.validate()
        if self.quantity_precision != DEFAULT_PRECISION:
            raise ValueError(
                f"invalid public parameters: quantity precision should be {DEFAULT_PRECISION}"
            )
        g1_points = [self.ped_gen] + self.ped_params + self.nym_params
        for s in self.range_params.signed_values:
            g1_points += [s.R, s.S]
        for pt in g1_points:
            if pt is not None and not hm.g1_is_on_curve(pt):
                raise ValueError("invalid public parameters: G1 point not on curve")
        # G2 elements feed pairing equations: enforce r-torsion membership
        # (small-subgroup hardening, cf. hostmath.g2_from_bytes)
        for q in [self.range_params.Q] + self.range_params.sign_pk:
            if not hm.g2_in_subgroup(q):
                raise ValueError("invalid public parameters: G2 point not in subgroup")


def setup(base: int, exponent: int, label: str = DLOG_LABEL, rng=None) -> PublicParams:
    """Trusted setup (reference setup.go:210-236).

    Generates Pedersen + nym generators and PS-signs 0..base-1 for the
    range proof. The PS secret key is discarded.
    """
    signer = pssign.keygen(1, rng)
    signed = [signer.sign([v], rng) for v in range(base)]
    pp = PublicParams(label=label)
    pp.ped_gen = hm.rand_g1(rng)
    pp.ped_params = [hm.rand_g1(rng) for _ in range(3)]
    pp.nym_params = [hm.rand_g1(rng) for _ in range(2)]
    pp.range_params = RangeProofParams(
        sign_pk=signer.pk, Q=signer.Q, signed_values=signed, exponent=exponent
    )
    return pp
