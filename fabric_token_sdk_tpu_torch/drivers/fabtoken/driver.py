"""fabtoken driver — plaintext tokens, signature-based validation.

Reference: `token/core/fabtoken/*` (setup.go, issuer.go, sender.go,
validator.go, validator_transfer.go). Tokens are stored in the clear;
privacy comes only from identity management. Validation checks ownership
signatures, type consistency, and value conservation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from ...api.driver import Driver, IssueOutcome, TransferOutcome, ValidationError, vguard
from ...crypto.serialization import BytesCache, dumps, loads, loads_cached
from ...models.quantity import Quantity
from ...models.token import ID, Owner, Token, UnspentToken
from ...utils import profiler
from .. import identity

MAX_PRECISION = 64

# Bounded read-only decode cache: chained transfers spend the previous
# tx's outputs, so the same token bytes decode as an output in block N
# and an input in block N+1 (and again in every plan hook).
_TOKENS = BytesCache(Token.from_bytes)


@dataclass
class FabTokenPublicParams:
    """Reference `fabtoken/setup.go`: precision + authorized identities."""

    label: str = "fabtoken"
    quantity_precision: int = MAX_PRECISION
    issuers: List[bytes] = field(default_factory=list)
    auditor: bytes = b""

    def token_data_hiding(self) -> bool:
        return False

    def graph_hiding(self) -> bool:
        return False

    def max_token_value(self) -> int:
        return (1 << self.quantity_precision) - 1

    def serialize(self) -> bytes:
        return dumps(
            {
                "identifier": self.label,
                "precision": self.quantity_precision,
                "issuers": list(self.issuers),
                "auditor": self.auditor,
            }
        )

    @classmethod
    def deserialize(cls, raw: bytes) -> "FabTokenPublicParams":
        d = loads(raw)
        return cls(d["identifier"], d["precision"], d["issuers"], d["auditor"])

    def add_issuer(self, ident: bytes) -> None:
        self.issuers.append(ident)

    def add_auditor(self, ident: bytes) -> None:
        self.auditor = ident


class FabTokenDriver(Driver):
    name = "fabtoken"

    def __init__(self, pp: Optional[FabTokenPublicParams] = None):
        self.pp = pp or FabTokenPublicParams()

    def public_params(self) -> FabTokenPublicParams:
        return self.pp

    def precision(self) -> int:
        return self.pp.quantity_precision

    # ------------------------------------------------------------ actions

    def issue(self, issuer_identity, token_type, values, owners, anonymous=False) -> IssueOutcome:
        if len(values) != len(owners):
            raise ValueError("issue: values/owners length mismatch")
        for v in values:
            Quantity(v, self.pp.quantity_precision)  # range check
        outputs = [
            Token(Owner(owner), token_type, hex(v)).to_bytes()
            for v, owner in zip(values, owners)
        ]
        action = dumps({"outputs": outputs, "issuer": issuer_identity})
        # fabtoken metadata mirrors the clear outputs (reference: ppm.go)
        return IssueOutcome(action_bytes=action, outputs=outputs, metadata=list(outputs))

    def transfer(self, input_ids, input_tokens, input_metadata, token_type, values, owners) -> TransferOutcome:
        if len(values) != len(owners):
            raise ValueError("transfer: values/owners length mismatch")
        for v in values:
            Quantity(v, self.pp.quantity_precision)  # range check
        outputs = [
            Token(Owner(owner), token_type, hex(v)).to_bytes()
            for v, owner in zip(values, owners)
        ]
        action = dumps(
            {
                "ids": [[i.tx_id, i.index] for i in input_ids],
                "inputs": list(input_tokens),
                "outputs": outputs,
            }
        )
        return TransferOutcome(action_bytes=action, outputs=outputs, metadata=list(outputs))

    # ------------------------------------------------------------ validate

    @vguard
    def validate_issue(self, action_bytes: bytes):
        with profiler.leg("conservation"):
            d = loads_cached(action_bytes)
            outputs = d["outputs"]
            if not outputs:
                raise ValidationError("issue must have at least one output")
            issuer = d["issuer"]
            if self.pp.issuers and issuer not in self.pp.issuers:
                raise ValidationError("issuer is not authorized")
            token_type = None
            for raw in outputs:
                t = _TOKENS.lookup(raw)
                q = t.quantity_as(self.pp.quantity_precision)
                if q.is_zero():
                    raise ValidationError("issue output with zero value")
                if token_type is None:
                    token_type = t.type
                elif t.type != token_type:
                    raise ValidationError("issue outputs with mixed types")
        # fabtoken issues always require the action issuer's signature
        return outputs, issuer

    @vguard
    def validate_transfer(self, action_bytes, resolve_input, signed_payload,
                          signatures, now=None, proof_verified=None,
                          sig_verified=None, conservation_verified=None):
        # fabtoken carries no ZK proof: `transfer_batch_plan` never emits
        # a plan, so `proof_verified` is always None here and ignored
        with profiler.leg("input_match"):
            d = loads_cached(action_bytes)
            ids = [ID(t, i) for t, i in d["ids"]]
            if not ids:
                raise ValidationError("transfer must have at least one input")
            ledger_inputs = [resolve_input(i) for i in ids]
            # action must reference the same inputs it was signed over
            if d["inputs"] != ledger_inputs:
                raise ValidationError(
                    "transfer inputs do not match ledger state"
                )
        with profiler.leg("conservation"):
            inputs = [_TOKENS.lookup(raw) for raw in ledger_inputs]
            if conservation_verified is not True:
                # no block-level verdict for this action: full scalar
                # checks (the batch pass covered the ACTION-claimed
                # inputs, which the input_match leg above just pinned to
                # ledger state, and the same output bytes)
                outputs = [_TOKENS.lookup(raw) for raw in d["outputs"]]
                types = {t.type for t in inputs} | {t.type for t in outputs}
                if len(types) != 1:
                    raise ValidationError(
                        f"tokens must have the same type, got {sorted(types)}"
                    )
                p = self.pp.quantity_precision
                in_sum = sum(t.quantity_as(p).value for t in inputs)
                out_sum = sum(t.quantity_as(p).value for t in outputs)
                if in_sum != out_sum:
                    raise ValidationError(
                        f"transfer does not preserve value: "
                        f"in={in_sum} out={out_sum}"
                    )
        if len(signatures) != len(inputs):
            raise ValidationError("one signature per input owner required")
        for si, (t, sig) in enumerate(zip(inputs, signatures)):
            v = sig_verified.get(si) if sig_verified else None
            if v is not None and v[0] == t.owner.raw:
                # batched-plane verdict for THIS owner identity: the
                # inputs==ledger check above pinned the claimed owner
                # the verdict was computed over to ledger state
                if not v[1]:
                    raise ValidationError(
                        "invalid owner signature: rejected by the batched "
                        "signature plane"
                    )
                continue
            try:
                identity.verify_signature(t.owner.raw, signed_payload, sig, now=now)
            except ValueError as e:
                raise ValidationError(f"invalid owner signature: {e}") from e
        return ids, d["outputs"]

    # ------------------------------------------------------------ batching

    def transfer_sign_plan(self, action_bytes: bytes):
        """Signature-plane hook: the ACTION-claimed input owners, one per
        required signature. Malformed bytes return None (host path
        rejects them with the precise error)."""
        try:
            d = loads_cached(action_bytes)
            owners = [_TOKENS.lookup(raw).owner.raw for raw in d["inputs"]]
            return owners or None
        except Exception:
            return None

    def issue_sign_plan(self, action_bytes: bytes):
        """Signature-plane hook: fabtoken issues always require the
        action-named issuer's signature."""
        try:
            issuer = loads_cached(action_bytes)["issuer"]
            return issuer if isinstance(issuer, bytes) and issuer else None
        except Exception:
            return None

    def validate_conservation_many(self, actions) -> List[Optional[bool]]:
        """Block-level vectorized conservation over transfer actions.

        Every action's tokens decode into one flat column (bounded parse
        cache: chained transfers make the same bytes recur), type/value
        columns are computed in a single pass, and each verdict falls out
        of segment sums instead of a per-tx parse/sum loop.

        A True verdict is decisive for exactly the checks the per-tx
        conservation leg performs — uniform type and value preservation
        over the ACTION-claimed inputs and outputs (the per-tx input_match
        leg separately pins claimed inputs to ledger state before the
        verdict is consumed). Anything else returns None: degrade-only,
        the scalar path re-checks and owns the precise error.
        """
        actions = list(actions)
        out: List[Optional[bool]] = [None] * len(actions)
        plans = []  # (action index, column start, n_in, n_out)
        flat: List[bytes] = []
        for i, raw in enumerate(actions):
            try:
                d = loads_cached(raw)
                ins, outs = d["inputs"], d["outputs"]
                if not isinstance(ins, list) or not isinstance(outs, list):
                    continue
                if not ins or not outs:
                    continue
            except Exception:
                continue
            plans.append((i, len(flat), len(ins), len(outs)))
            flat.extend(ins)
            flat.extend(outs)
        if not plans:
            return out
        p = self.pp.quantity_precision
        cols: List[Optional[tuple]] = []
        for raw in flat:
            try:
                t = _TOKENS.lookup(raw)
                cols.append((t.type, t.quantity_as(p).value))
            except Exception:
                cols.append(None)  # malformed token: scalar path reports
        for i, start, n_in, n_out in plans:
            seg = cols[start : start + n_in + n_out]
            if any(c is None for c in seg):
                continue
            if len({c[0] for c in seg}) != 1:
                continue
            if sum(c[1] for c in seg[:n_in]) == sum(c[1] for c in seg[n_in:]):
                out[i] = True
        return out

    # ------------------------------------------------------------ tokens

    def output_to_unspent(self, token_id, output_bytes, metadata_bytes=None) -> UnspentToken:
        t = _TOKENS.lookup(output_bytes)
        q = t.quantity_as(self.pp.quantity_precision)
        return UnspentToken(token_id, t.owner, t.type, q.decimal())

    def output_owner(self, output_bytes: bytes) -> bytes:
        return _TOKENS.lookup(output_bytes).owner.raw

    def verify_owner_signature(self, owner_identity, message, signature) -> None:
        identity.verify_signature(owner_identity, message, signature)
