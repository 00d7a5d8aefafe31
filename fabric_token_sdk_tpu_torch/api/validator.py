"""Request-level validator: actions + signatures + audit binding.

Reference: `token/validator.go` + driver validators
(`fabtoken/validator.go`, `zkatdlog/crypto/validator/validator.go`).
Endorsers/committers run this against current ledger state.

Deferred-signature mode: a block pipeline (the JAX package's
`BlockValidationPipeline.sign_verdicts`; the port's orderer is still to
come) collects every `pk`-kind signature obligation of a block —
auditor, issuer, transfer owners — verifies them in ONE
`BatchedSchnorrVerifier` call on the card, and hands the verdicts back
through `validate(sig_verified=...)`. Each verdict is
`(identity_bytes, bool)` keyed by obligation — it applies ONLY when the
recorded identity equals the one the host check would verify against
(statement pinning), True skips the host check, False rejects, and a
missing/mismatched verdict host-verifies — so accept/reject can never
depend on the batched plane, only get faster.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from .driver import Driver, ValidationError
from .request import TokenRequest
from ..drivers import identity
from ..models.token import ID


@dataclass
class ValidationResult:
    spent: List[ID] = field(default_factory=list)
    # outputs in action order; each entry (action_kind, outputs)
    outputs: List[Tuple[str, List[bytes]]] = field(default_factory=list)


# obligation keys of the batched signature plane, shared with
# BlockValidationPipeline.sign_verdicts:
#   ("auditor", 0)                 — the request-level auditor signature
#   ("issue", record_index)        — one issuer signature per issue record
#   ("transfer", record_index, si) — one owner signature per transfer input
SIG_AUDITOR = ("auditor", 0)


class RequestValidator:
    def __init__(self, driver: Driver, auditor_identity: bytes = b""):
        self.driver = driver
        self.auditor = auditor_identity

    def validate(self, request: TokenRequest, resolve_input: Callable[[ID], bytes],
                 now=None,
                 transfer_proofs: Optional[Dict[int, bool]] = None,
                 sig_verified: Optional[Dict[tuple, tuple]] = None,
                 conservation: Optional[Dict[int, bool]] = None) -> ValidationResult:
        """`now`: deterministic commit timestamp for time-locked scripts.

        `transfer_proofs`: verdicts from the block-batched proof plane,
        keyed by transfer-record index — True means the action's ZK proof
        was already verified on the device (the driver skips its host
        proof check), False means it was already REJECTED. Records with
        no verdict verify on host. Everything else (ledger-input
        matching, conservation) always runs here.

        `sig_verified`: verdicts from the block-batched SIGNATURE plane,
        `{obligation_key: (identity_bytes, bool)}` (see the module
        docstring). Only `pk`-kind obligations ever get verdicts;
        nym/htlc identities always host-verify.

        `conservation`: True-only verdicts from the block-level
        vectorized conservation pass, keyed by transfer-record index —
        True means the driver's `validate_conservation_many` hook already
        proved the action's type/value checks over the very bytes the
        input_match leg pins to ledger state, so the driver skips its
        per-tx conservation arithmetic. Records without a verdict (and
        every failure) run the full scalar checks.
        """
        result = ValidationResult()
        payload = request.marshal_to_sign()
        sv = sig_verified or {}

        def _verdict(okey, ident) -> Optional[bool]:
            """Tri-state: True skip host check, False reject, None host."""
            v = sv.get(okey)
            if v is None or not ident or v[0] != ident:
                return None  # no verdict / statement mismatch -> host
            return bool(v[1])

        if self.auditor:
            if not request.auditor_signature:
                raise ValidationError("request is missing the auditor signature")
            ok = _verdict(SIG_AUDITOR, self.auditor)
            if ok is False:
                raise ValidationError(
                    "invalid auditor signature: rejected by the batched "
                    "signature plane"
                )
            if ok is None:
                try:
                    identity.verify_signature(
                        self.auditor, request.marshal_to_audit(),
                        request.auditor_signature,
                    )
                except ValueError as e:
                    raise ValidationError(f"invalid auditor signature: {e}") from e

        for ii, rec in enumerate(request.issues):
            # the driver returns the issuer identity the ACTION names (after
            # authorization checks); the record-level field is untrusted.
            outputs, action_issuer = self.driver.validate_issue(rec.action)
            if action_issuer:
                if not rec.signature:
                    raise ValidationError("issue is missing the issuer signature")
                ok = _verdict(("issue", ii), action_issuer)
                if ok is False:
                    raise ValidationError(
                        "invalid issuer signature: rejected by the batched "
                        "signature plane"
                    )
                if ok is None:
                    try:
                        identity.verify_signature(action_issuer, payload, rec.signature)
                    except ValueError as e:
                        raise ValidationError(f"invalid issuer signature: {e}") from e
            result.outputs.append(("issue", outputs))

        for idx, rec in enumerate(request.transfers):
            rec_sigs = {
                okey[2]: v for okey, v in sv.items()
                if okey[0] == "transfer" and okey[1] == idx
            }
            kwargs = dict(
                now=now,
                proof_verified=None if transfer_proofs is None
                else transfer_proofs.get(idx),
            )
            if rec_sigs:
                # `sig_verified` is passed ONLY when there are verdicts —
                # and verdicts only exist for drivers whose OWN
                # `transfer_sign_plan` hook emitted owners, so accepting
                # the kwarg is part of the same SPI opt-in (a driver
                # without the hooks is never called with it; a vguard-
                # decorated driver would mask a binding TypeError as
                # ValidationError, so there is no post-hoc fallback)
                kwargs["sig_verified"] = rec_sigs
            cv = conservation.get(idx) if conservation else None
            if cv is True:
                # same SPI opt-in as sig_verified: a verdict only exists
                # when THIS driver's validate_conservation_many hook
                # emitted it, so the kwarg is only bound for drivers that
                # declared it (True-only — failures carry no verdict)
                kwargs["conservation_verified"] = True
            spent, outputs = self.driver.validate_transfer(
                rec.action, resolve_input, payload, rec.signatures, **kwargs
            )
            if spent != rec.input_ids:
                raise ValidationError("transfer record ids do not match action")
            result.spent.extend(spent)
            result.outputs.append(("transfer", outputs))

        if not request.issues and not request.transfers:
            raise ValidationError("empty token request")
        # no double spend within one request
        if len(set(result.spent)) != len(result.spent):
            raise ValidationError("request spends the same token twice")
        return result
