"""Wallets: long-term keys, pseudonym derivation, signing.

Reference: `token/wallet.go` + `token/core/zkatdlog/nogh/wallet.go`.
Owner wallets hand out recipient identities (fresh pseudonyms for
zkatdlog, long-term keys for fabtoken) and sign transfer requests for the
identities they control.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..crypto import hostmath as hm, nym as nym_mod, sign
from ..drivers import identity


@dataclass
class IssuerWallet:
    wallet_id: str
    key: sign.SigningKey

    @property
    def identity(self) -> bytes:
        return identity.pk_identity(self.key.public)

    def sign(self, message: bytes, rng=None) -> bytes:
        return self.key.sign(message, rng)


AuditorWallet = IssuerWallet  # same shape: long-term signing identity


class OwnerWallet:
    """Owner wallet: controls long-term secret + derived pseudonyms."""

    def __init__(self, wallet_id: str, anonymous: bool, nym_params=None, rng=None):
        self.wallet_id = wallet_id
        self.anonymous = anonymous
        self.rng = rng
        self.nym_params = list(nym_params) if nym_params else None
        self.key = sign.keygen(rng)
        self._nyms: Dict[bytes, nym_mod.NymSigner] = {}

    def recipient_identity(self) -> bytes:
        """Fresh identity for receiving tokens."""
        if not self.anonymous:
            return identity.pk_identity(self.key.public)
        if not self.nym_params:
            raise ValueError("anonymous wallet requires nym parameters")
        ny, bf = nym_mod.new_nym(self.key.sk, self.nym_params, self.rng)
        ident = identity.nym_identity(ny)
        self._nyms[ident] = nym_mod.NymSigner(self.key.sk, bf, ny, self.nym_params)
        return ident

    def owns(self, ident: bytes) -> bool:
        if ident in self._nyms:
            return True
        try:
            d = identity.parse(ident)
        except ValueError:
            return False
        return d["t"] == "pk" and d["pk"] == self.key.public.to_bytes()

    def sign(self, ident: bytes, message: bytes) -> bytes:
        """Sign on behalf of one of this wallet's identities."""
        if ident in self._nyms:
            return self._nyms[ident].sign(message, self.rng)
        if self.owns(ident):
            return self.key.sign(message, self.rng)
        raise ValueError(f"wallet [{self.wallet_id}] does not own this identity")


@dataclass
class WalletRegistry:
    """All wallets a node controls (reference WalletManager)."""

    owners: Dict[str, OwnerWallet] = field(default_factory=dict)
    issuers: Dict[str, IssuerWallet] = field(default_factory=dict)
    auditors: Dict[str, AuditorWallet] = field(default_factory=dict)

    def owner_wallet(self, wid: str) -> OwnerWallet:
        return self.owners[wid]

    def issuer_wallet(self, wid: str) -> IssuerWallet:
        return self.issuers[wid]

    def auditor_wallet(self, wid: str) -> AuditorWallet:
        return self.auditors[wid]

    def wallet_owning(self, ident: bytes) -> Optional[OwnerWallet]:
        for w in self.owners.values():
            if w.owns(ident):
                return w
        return None
