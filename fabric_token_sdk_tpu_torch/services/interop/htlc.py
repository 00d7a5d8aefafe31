"""Hash-time-locked contracts: cross-network atomic-swap ownership scripts.

Reference: `token/services/interop/htlc/*` (script.go, lock.go, claim
views) and `token/core/interop/htlc`. A token owned by an HTLC script can
be claimed by the recipient with the hash preimage before the deadline, or
reclaimed by the sender after it.
"""

from __future__ import annotations

import hashlib
import time as _time
from dataclasses import dataclass
from typing import Optional

from ...crypto.serialization import dumps, guard, loads
from ...drivers import identity as identity_mod


@dataclass
class HTLCScript:
    sender: bytes  # identity that can reclaim after the deadline
    recipient: bytes  # identity that can claim with the preimage
    deadline: float  # unix seconds
    hash_value: bytes  # H(preimage)
    hash_func: str = "sha256"

    def to_identity(self) -> bytes:
        return identity_mod.htlc_identity(
            {
                "sender": self.sender,
                "recipient": self.recipient,
                "deadline": self.deadline,
                "hash": self.hash_value,
                "hash_func": self.hash_func,
            }
        )

    @classmethod
    def from_identity(cls, raw: bytes) -> "HTLCScript":
        d = identity_mod.parse(raw)
        if d["t"] != "htlc":
            raise ValueError("identity is not an HTLC script")
        s = d["script"]
        return cls(s["sender"], s["recipient"], s["deadline"], s["hash"], s["hash_func"])

    def check_preimage(self, preimage: bytes) -> bool:
        h = hashlib.new(self.hash_func)
        h.update(preimage)
        return h.digest() == self.hash_value


def lock(sender_identity: bytes, recipient_identity: bytes, preimage_hash: bytes,
         deadline: float, hash_func: str = "sha256") -> HTLCScript:
    """Build the script under which locked tokens are owned."""
    return HTLCScript(sender_identity, recipient_identity, deadline,
                      preimage_hash, hash_func)


@dataclass
class HTLCClaimSignature:
    """Signature wrapper carrying the preimage for claims (reference:
    htlc claim signature = recipient sig + preimage)."""

    preimage: bytes
    inner: bytes  # recipient identity's signature

    def to_bytes(self) -> bytes:
        return dumps({"p": self.preimage, "s": self.inner})

    @classmethod
    def from_bytes(cls, raw: bytes) -> "HTLCClaimSignature":
        d = loads(raw)
        return cls(d["p"], d["s"])


def claim(script: HTLCScript, preimage: bytes, recipient_sign, message: bytes,
          now: Optional[float] = None) -> bytes:
    """Recipient claims before the deadline with the correct preimage."""
    now = _time.time() if now is None else now
    if now >= script.deadline:
        raise ValueError("htlc: deadline passed, claim window closed")
    if not script.check_preimage(preimage):
        raise ValueError("htlc: wrong preimage")
    return HTLCClaimSignature(preimage, recipient_sign(message)).to_bytes()


def reclaim(script: HTLCScript, sender_sign, message: bytes,
            now: Optional[float] = None) -> bytes:
    """Sender reclaims after the deadline."""
    now = _time.time() if now is None else now
    if now < script.deadline:
        raise ValueError("htlc: deadline not reached, cannot reclaim")
    return sender_sign(message)


@guard
def verify_htlc_spend(script_identity: bytes, message: bytes, signature: bytes,
                      nym_params=None, now: Optional[float] = None) -> None:
    """Validator-side script check: claim (preimage + recipient sig before
    deadline) or reclaim (sender sig after deadline)."""
    script = HTLCScript.from_identity(script_identity)
    now = _time.time() if now is None else now
    if now < script.deadline:
        sig = HTLCClaimSignature.from_bytes(signature)
        if not script.check_preimage(sig.preimage):
            raise ValueError("htlc: invalid claim preimage")
        identity_mod.verify_signature(script.recipient, message, sig.inner, nym_params)
    else:
        identity_mod.verify_signature(script.sender, message, signature, nym_params)
