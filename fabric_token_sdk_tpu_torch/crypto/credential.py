"""Anonymous credentials from Pointcheval-Sanders signatures (idemix-analog).

Reference capability: the zkatdlog driver uses Fabric idemix for anonymous
owner identities (setup.go IdemixIssuerPK; nogh/identity.go). Here the
same capability is built from the in-house PS machinery:

* a user obtains a credential on hidden attributes via BLIND issuance
  (`pssign.BlindSigner` — the issuer never sees the attributes), and
* presents it unlinkably via a proof of knowledge of the randomized
  signature bound to a presentation message, with SELECTIVE DISCLOSURE:
  revealed attributes move to the statement side of the pairing equation
  (e(R'^c, PK_0 + sum_disclosed PK_i^{v_i})), hidden ones stay witnesses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import elgamal, hostmath as hm, pssign, schnorr, sigproof
from .serialization import dumps, g1s_bytes, g2s_bytes, guard, loads


@dataclass
class CredentialIssuerPublic:
    pk: List[tuple]
    Q: tuple
    ped: List[tuple]


@dataclass
class CredentialIssuer:
    """Issues credentials on `n_attrs` hidden attributes."""

    signer: pssign.Signer
    ped: List[tuple]  # n_attrs + 1 commitment bases

    @classmethod
    def create(cls, n_attrs: int, rng=None) -> "CredentialIssuer":
        signer = pssign.keygen(n_attrs, rng)
        ped = [hm.rand_g1(rng) for _ in range(n_attrs + 1)]
        return cls(signer, ped)

    @property
    def public(self) -> CredentialIssuerPublic:
        return CredentialIssuerPublic(self.signer.pk, self.signer.Q, self.ped)

    def blind_issue(self, request: pssign.BlindSignRequest) -> pssign.BlindSignResponse:
        return pssign.BlindSigner(self.signer, self.ped).blind_sign(request)


@dataclass
class Credential:
    attributes: List[int]
    msg_hash: int  # the PS "hash" message fixed at blind issuance
    signature: pssign.Signature


def _presentation_challenge(pub, com_gt, sig, disclosed: Dict[int, int],
                            message: bytes) -> int:
    raw = (
        g2s_bytes(pub.pk, [pub.Q])
        + g1s_bytes(pub.ped)
        + hm.gt_to_bytes(com_gt)
        + sig.transcript_bytes()
        + dumps({"d": {str(k): v for k, v in sorted(disclosed.items())}})
        + message
    )
    return hm.hash_to_zr(raw, b"fts/credential")


class CredentialUser:
    def __init__(self, issuer_pub: CredentialIssuerPublic, attributes: Sequence[int], rng=None):
        self.pub = issuer_pub
        self.attributes = list(attributes)
        self.rng = rng

    # ------------------------------------------------------------ issuance

    def request_credential(self):
        """-> (recipient_state, BlindSignRequest) for the issuer."""
        bf = hm.rand_zr(self.rng)
        com = hm.g1_multiexp(self.pub.ped, self.attributes + [bf])
        enc_sk = elgamal.keygen(rng=self.rng)
        verifier = pssign.SignVerifier(pk=self.pub.pk, Q=self.pub.Q)
        rec = pssign.Recipient(
            self.attributes, bf, com, enc_sk, self.pub.ped, verifier, self.rng
        )
        return rec, rec.request()

    def finish(self, rec, response: pssign.BlindSignResponse) -> Credential:
        sig = rec.unblind(response)  # verifies internally
        return Credential(self.attributes, response.msg_hash, sig)

    # -------------------------------------------------------- presentation

    def present(self, cred: Credential, message: bytes,
                disclose: Optional[Sequence[int]] = None) -> bytes:
        """Unlinkable presentation bound to `message`, revealing the
        attribute values at the indices in `disclose`."""
        disclose = sorted(set(disclose or []))
        hidden = [i for i in range(len(cred.attributes)) if i not in disclose]
        disclosed = {i: cred.attributes[i] for i in disclose}
        P = self.pub.ped[0]
        # randomize + obfuscate the signature
        rnd = pssign.SignVerifier(self.pub.pk, self.pub.Q).randomize(
            cred.signature, self.rng
        )
        bf = hm.rand_zr(self.rng)
        obf = pssign.Signature(rnd.R, hm.g1_add(rnd.S, hm.g1_mul(P, bf)))
        # commitment over hidden-attribute randomness
        rho = {i: hm.rand_zr(self.rng) for i in hidden}
        rho_h = hm.rand_zr(self.rng)
        rho_bf = hm.rand_zr(self.rng)
        t_rand = hm.g2_mul(self.pub.pk[-1], rho_h)
        for i in hidden:
            t_rand = hm.g2_add(t_rand, hm.g2_mul(self.pub.pk[i + 1], rho[i]))
        com_gt = hm.pairing_product(
            [(rnd.R, t_rand), (hm.g1_mul(P, rho_bf), self.pub.Q)]
        )
        chal = _presentation_challenge(self.pub, com_gt, obf, disclosed, message)
        z_hidden = [
            (rho[i] + chal * cred.attributes[i]) % hm.R for i in hidden
        ]
        return dumps(
            {
                "c": chal,
                "sr": obf.R,
                "ss": obf.S,
                "m": z_hidden,
                "h": (rho_h + chal * cred.msg_hash) % hm.R,
                "b": (rho_bf + chal * bf) % hm.R,
                "d": {str(i): disclosed[i] for i in disclose},
            }
        )


class CredentialVerifier:
    def __init__(self, issuer_pub: CredentialIssuerPublic):
        self.pub = issuer_pub

    @guard
    def verify(self, raw: bytes, message: bytes,
               expect_disclosed: Optional[Dict[int, int]] = None) -> Dict[int, int]:
        d = loads(raw)
        disclosed = {int(k): v for k, v in d["d"].items()}
        n_attrs = len(self.pub.pk) - 2
        hidden = [i for i in range(n_attrs) if i not in disclosed]
        if len(d["m"]) != len(hidden):
            raise ValueError("credential: response count mismatch")
        sig = pssign.Signature(d["sr"], d["ss"])
        chal, z_h, z_bf = d["c"], d["h"], d["b"]
        # t = sum_hidden PK_i^{z_i} + PK_h^{z_h}
        t = hm.g2_mul(self.pub.pk[-1], z_h)
        for z, i in zip(d["m"], hidden):
            t = hm.g2_add(t, hm.g2_mul(self.pub.pk[i + 1], z))
        # statement side: PK_0 + sum_disclosed PK_i^{v_i}
        stmt = self.pub.pk[0]
        for i, v in disclosed.items():
            if not 0 <= i < n_attrs:
                raise ValueError("credential: disclosed index out of range")
            stmt = hm.g2_add(stmt, hm.g2_mul(self.pub.pk[i + 1], v))
        P = self.pub.ped[0]
        com_gt = hm.pairing_product(
            [
                (hm.g1_neg(hm.g1_mul(sig.S, chal)), self.pub.Q),
                (hm.g1_mul(sig.R, chal), stmt),
                (sig.R, t),
                (hm.g1_mul(P, z_bf), self.pub.Q),
            ]
        )
        if _presentation_challenge(self.pub, com_gt, sig, disclosed, message) != chal:
            raise ValueError("invalid credential presentation")
        if expect_disclosed:
            for idx, val in expect_disclosed.items():
                if disclosed.get(idx) != val:
                    raise ValueError("credential: disclosed attribute mismatch")
        return disclosed
