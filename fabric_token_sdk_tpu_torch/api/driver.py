"""Driver SPI — what a token driver must implement.

Reference: `token/driver/driver.go`, `issue.go`, `transfer.go`,
`validator.go`, `wallet.go`. A driver owns the privacy model: how tokens
are represented on the ledger, how actions are proven and validated, and
how identities sign.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..models.token import ID, Token, UnspentToken


class ValidationError(Exception):
    """A token request failed validation."""


def vguard(fn):
    """Decorator for driver validate entry points: structural errors from
    attacker-supplied action bytes become ValidationError, never KeyError/
    TypeError/ValueError leaks (cf. crypto.serialization.guard)."""

    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except ValidationError:
            raise
        except (MemoryError, OSError):
            # transient environment faults are NOT validation verdicts:
            # they must reach the ledger's transient path (attempt fails,
            # nothing durable recorded, resubmission can succeed)
            raise
        except Exception as e:
            raise ValidationError(
                f"malformed action: {type(e).__name__}: {e}"
            ) from e

    wrapped.__name__ = fn.__name__
    wrapped.__doc__ = fn.__doc__
    return wrapped


@dataclass
class IssueOutcome:
    """Result of assembling an issue action."""

    action_bytes: bytes
    outputs: List[bytes]  # serialized on-ledger outputs
    metadata: List[bytes]  # per-output opening metadata (off-chain)


@dataclass
class TransferOutcome:
    action_bytes: bytes
    outputs: List[bytes]
    metadata: List[bytes]


class Driver(abc.ABC):
    """A token driver (privacy model + crypto backend)."""

    name: str = ""
    supports_anonymous_issue: bool = False

    # ------------------------------------------------------------ params

    @abc.abstractmethod
    def public_params(self):
        ...

    @abc.abstractmethod
    def precision(self) -> int:
        ...

    # ------------------------------------------------------------ actions

    @abc.abstractmethod
    def issue(self, issuer_identity: bytes, token_type: str, values: Sequence[int],
              owners: Sequence[bytes], anonymous: bool = True) -> IssueOutcome:
        ...

    @abc.abstractmethod
    def transfer(self, input_ids: Sequence[ID], input_tokens: Sequence[bytes],
                 input_metadata: Sequence[bytes], token_type: str,
                 values: Sequence[int], owners: Sequence[bytes]) -> TransferOutcome:
        ...

    # ------------------------------------------------------------ validate

    @abc.abstractmethod
    def validate_issue(self, action_bytes: bytes) -> Tuple[List[bytes], bytes]:
        """Validate an issue action; returns (serialized outputs to write,
        issuer identity whose signature the request must carry — empty for
        anonymous issuance where the proof itself authorizes)."""

    @abc.abstractmethod
    def validate_transfer(self, action_bytes: bytes,
                          resolve_input,  # Callable[[ID], bytes]
                          signed_payload: bytes,
                          signatures: Sequence[bytes],
                          now: Optional[float] = None,
                          proof_verified: Optional[bool] = None,
                          sig_verified: Optional[Dict[int, tuple]] = None,
                          ) -> Tuple[List[ID], List[bytes]]:
        """Validate a transfer action; returns (spent ids, outputs to write).
        `now` is the deterministic commit timestamp (script deadlines etc.
        must not depend on validator wall clocks). `proof_verified` is the
        block-batched plane's verdict on the action's ZK proof — True:
        skip the host proof check, False: reject, None: verify on host.
        Drivers without ZK proofs ignore it (their `transfer_batch_plan`
        never emits a plan, so it is always None for them).

        `sig_verified` carries the batched SIGNATURE plane's verdicts:
        `{signature_index: (identity_bytes, bool)}`. A verdict applies
        ONLY when `identity_bytes` equals the owner identity the host
        check would verify against (defense in depth — the verdict was
        computed over the ACTION-claimed owner, which the inputs==ledger
        pin makes equal); True skips the host signature check, False
        rejects, a missing/mismatched entry host-verifies. The validator
        passes the kwarg only when it HAS verdicts, and verdicts only
        exist for drivers whose own `transfer_sign_plan` emitted owners
        — so accepting `sig_verified` is part of the same SPI opt-in
        (drivers without the sign-plan hooks are never called with it,
        and a `vguard`-decorated validate_transfer would convert a
        binding TypeError into a spurious rejection, so implement both
        or neither)."""

    # ------------------------------------------------------------ batching

    def transfer_batch_plan(self, action_bytes: bytes):
        """Optional hook for the block-batched validation plane: return
        `(shape_key, row)` where all rows sharing `shape_key` can be
        verified together in ONE `batch_verifier().verify(rows)` call, or
        None to route this action through the host path (default)."""
        return None

    def batch_verifier(self, mesh=None):
        """The driver's block-batched transfer-proof verifier (an object
        with `verify(rows) -> bool array`), or None when the driver has
        no batched plane (default). `mesh` is a `parallel.sharding.
        DeviceMesh` to bind the verifier to (its stage calls over the
        mesh's row groups), re-bound on every call, None unbinding; a
        driver without a batched plane ignores it."""
        return None

    def batch_prover(self, mesh=None):
        """The driver's batched transfer-proof GENERATOR (the prove-side
        twin of `batch_verifier`), or None when the driver proves on the
        host only (default). `mesh` as in `batch_verifier`."""
        return None

    def transfer_sign_plan(self, action_bytes: bytes):
        """Optional hook for the block-batched SIGNATURE plane: the
        owner identity blobs a transfer action's signatures must verify
        against, one per required signature, in signature order — the
        ACTION-claimed owners (`validate_transfer` separately pins them
        to ledger state, so a verdict computed over them is exactly the
        host check). Return None (default) to route every signature of
        this action through the host path (malformed bytes, drivers
        whose owners are not identity blobs)."""
        return None

    def issue_sign_plan(self, action_bytes: bytes):
        """Signature-plane hook for issue actions: the issuer identity
        whose signature the request must carry (the same identity
        `validate_issue` returns after its authorization checks — the
        two MUST agree or the verdict is discarded by the identity
        match), or None when the issue needs no signature (anonymous
        issuance) or the action cannot be planned (default)."""
        return None

    def transfer_many(self, transfers: Sequence[tuple], rng=None,
                      min_batch=None):
        """Batch-prove SPI: build many transfer actions at once.
        `transfers` holds tuples of `transfer()`'s positional arguments;
        outcomes come back in request order. Default: sequential
        `transfer()` calls — the abstract `transfer()` takes no rng, so
        `rng`/`min_batch` are ignored here; drivers that thread
        randomness or batch proof generation override this (zkatdlog
        routes same-shape groups of >= min_batch through
        `TransferProver.batch`)."""
        return [self.transfer(*spec) for spec in transfers]

    # ------------------------------------------------------------ tokens

    @abc.abstractmethod
    def output_to_unspent(self, token_id: ID, output_bytes: bytes,
                          metadata_bytes: Optional[bytes]) -> UnspentToken:
        """Interpret a ledger output (+optional metadata) as a clear token."""

    @abc.abstractmethod
    def output_owner(self, output_bytes: bytes) -> bytes:
        ...

    # ------------------------------------------------------------ identity

    @abc.abstractmethod
    def verify_owner_signature(self, owner_identity: bytes, message: bytes,
                               signature: bytes) -> None:
        ...
