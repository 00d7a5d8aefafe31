"""zkatdlog driver — anonymous tokens with zero-knowledge validation.

Reference: `token/core/zkatdlog/nogh/*` (service.go, issuer.go, sender.go,
validator.go, deserializer.go). Tokens on the ledger are Pedersen
commitments + owner identities (pseudonyms); actions carry ZK proofs
(well-formedness + range) verified by every endorser.

The driver's batched planes run on the card: `batch_verifier()` is the
port's `BatchedTransferVerifier` and `batch_prover()` (also behind
`transfer_many`) its `BatchedTransferProver`. The driver takes the
device they run on (`ZKATDLogDriver(pp, device=None)`) and resolves it
only on the first batched-plane call, through `crypto.batch.resolve_device`:
None means the card and raises where there is none, "cpu" runs the
kernels' plain torch versions. Issue, transfer, validation and the plan
hooks are host code and never touch the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ...api.driver import Driver, IssueOutcome, TransferOutcome, ValidationError, vguard
from ...crypto import issue as issue_mod, transfer as transfer_mod
from ...crypto.serialization import BytesCache, dumps, loads_cached
from ...crypto.setup import PublicParams
from ...crypto.token import Metadata, Token as ZkToken, TokenDataWitness, token_in_the_clear, tokens_with_witness
from ...models.token import ID, Owner, UnspentToken
from ...utils import profiler
from .. import identity

# Bounded read-only decode cache: chained transfers spend the previous
# tx's outputs, so the same commitment bytes decode repeatedly across
# plan hooks and validation legs.
_ZTOKENS = BytesCache(ZkToken.from_bytes)


class ZKATDLogDriver(Driver):
    name = "zkatdlog"
    supports_anonymous_issue = True

    def __init__(self, pp: PublicParams, device=None):
        self.pp = pp
        self.device = device  # resolved by the batched planes on first use
        self._batch_verifier = None

    def public_params(self) -> PublicParams:
        return self.pp

    def precision(self) -> int:
        return self.pp.quantity_precision

    # ------------------------------------------------------------ actions

    def issue(self, issuer_identity, token_type, values, owners, anonymous=True,
              rng=None) -> IssueOutcome:
        if len(values) != len(owners):
            raise ValueError("issue: values/owners length mismatch")
        commitments, witnesses = tokens_with_witness(
            list(values), token_type, self.pp.ped_params, rng
        )
        proof = issue_mod.IssueProver(
            witnesses, commitments, anonymous, self.pp, rng
        ).prove()
        outputs = [
            ZkToken(owner=o, data=c).to_bytes() for o, c in zip(owners, commitments)
        ]
        metadata = [
            Metadata(token_type, w.value, w.bf, owner=o, issuer=issuer_identity).to_bytes()
            for w, o in zip(witnesses, owners)
        ]
        action = dumps(
            {
                "outputs": outputs,
                "proof": proof,
                "anon": anonymous,
                "issuer": b"" if anonymous else issuer_identity,
            }
        )
        return IssueOutcome(action_bytes=action, outputs=outputs, metadata=metadata)

    def _transfer_parts(self, input_ids, input_tokens, input_metadata, token_type,
                        values, owners, rng):
        """Everything of a transfer EXCEPT proof generation: witness
        decode/checks and fresh output commitments. Returns the prove
        request consumed by `TransferProver`/`TransferProver.batch` plus
        the assembly context."""
        if len(values) != len(owners):
            raise ValueError("transfer: values/owners length mismatch")
        in_tokens = [ZkToken.from_bytes(raw) for raw in input_tokens]
        in_meta = [Metadata.from_bytes(raw) for raw in input_metadata]
        in_witnesses = [
            TokenDataWitness(m.token_type, m.value, m.bf) for m in in_meta
        ]
        for t, m in zip(in_tokens, in_meta):
            # defensive: openings must match the commitments being spent
            token_in_the_clear(t, m, self.pp.ped_params)
        out_commitments, out_witnesses = tokens_with_witness(
            list(values), token_type, self.pp.ped_params, rng
        )
        prove_req = (
            in_witnesses,
            out_witnesses,
            [t.data for t in in_tokens],
            out_commitments,
        )
        return prove_req, (input_ids, input_tokens, token_type, values, owners)

    def _assemble_transfer(self, ctx, prove_req, proof) -> TransferOutcome:
        input_ids, input_tokens, token_type, values, owners = ctx
        _, out_witnesses, _, out_commitments = prove_req
        outputs = [
            ZkToken(owner=o, data=c).to_bytes() for o, c in zip(owners, out_commitments)
        ]
        metadata = [
            Metadata(token_type, w.value, w.bf, owner=o).to_bytes()
            for w, o in zip(out_witnesses, owners)
        ]
        action = dumps(
            {
                "ids": [[i.tx_id, i.index] for i in input_ids],
                "inputs": list(input_tokens),
                "outputs": outputs,
                "proof": proof,
            }
        )
        return TransferOutcome(action_bytes=action, outputs=outputs, metadata=metadata)

    def transfer(self, input_ids, input_tokens, input_metadata, token_type, values,
                 owners, rng=None) -> TransferOutcome:
        prove_req, ctx = self._transfer_parts(
            input_ids, input_tokens, input_metadata, token_type, values, owners, rng
        )
        proof = transfer_mod.TransferProver(*prove_req, self.pp, rng).prove()
        return self._assemble_transfer(ctx, prove_req, proof)

    def transfer_many(self, transfers: Sequence[tuple], rng=None,
                      min_batch=None) -> List[TransferOutcome]:
        """Batch-prove SPI: build many transfer actions in one pass, with
        proof generation routed through the batched prover on the driver's
        device (`TransferProver.batch` groups same-shape requests; groups
        below `min_batch`, default FTS_PROVE_MIN_BATCH, take the host
        prover). The device prover is the `prover_for(pp, device)` that
        `batch_prover()` also returns, built for the first group that
        reaches it. A device or launch error propagates:
        no group is proved again on the host in its place.

        `transfers`: tuples of `transfer()`'s positional arguments
        `(input_ids, input_tokens, input_metadata, token_type, values,
        owners)`. Returns outcomes in request order.
        """
        parts = [self._transfer_parts(*spec, rng) for spec in transfers]
        proofs = transfer_mod.TransferProver.batch(
            [req for req, _ in parts], self.pp, rng=rng, min_batch=min_batch,
            device=self.device,
        )
        return [
            self._assemble_transfer(ctx, req, proof)
            for (req, ctx), proof in zip(parts, proofs)
        ]

    # ------------------------------------------------------------ validate

    @vguard
    def validate_issue(self, action_bytes: bytes):
        d = loads_cached(action_bytes)
        outputs = [_ZTOKENS.lookup(raw) for raw in d["outputs"]]
        if not outputs:
            raise ValidationError("issue must have at least one output")
        anonymous = d["anon"]
        issuer = d["issuer"]
        if not anonymous:
            if self.pp.issuers and issuer not in self.pp.issuers:
                raise ValidationError("issuer is not authorized")
        elif issuer:
            raise ValidationError("anonymous issue must not name an issuer")
        try:
            with profiler.leg("fiat_shamir"):
                issue_mod.IssueVerifier(
                    [t.data for t in outputs], anonymous, self.pp
                ).verify(d["proof"])
        except ValueError as e:
            raise ValidationError(f"invalid issue proof: {e}") from e
        # non-anonymous issues require the named issuer's signature
        return d["outputs"], issuer

    @vguard
    def validate_transfer(self, action_bytes, resolve_input, signed_payload,
                          signatures, now=None, proof_verified=None,
                          sig_verified=None):
        with profiler.leg("input_match"):
            d = loads_cached(action_bytes)
            ids = [ID(t, i) for t, i in d["ids"]]
            if not ids:
                raise ValidationError("transfer must have at least one input")
            ledger_inputs = [resolve_input(i) for i in ids]
            if d["inputs"] != ledger_inputs:
                raise ValidationError(
                    "transfer inputs do not match ledger state"
                )
        with profiler.leg("conservation"):
            in_tokens = [_ZTOKENS.lookup(raw) for raw in ledger_inputs]
            out_tokens = [_ZTOKENS.lookup(raw) for raw in d["outputs"]]
        if proof_verified is False:
            raise ValidationError("invalid transfer proof")
        if proof_verified is None:
            # host path; proof_verified=True means the block-batched plane
            # already verified the SAME (inputs, outputs, proof) statement
            # this action carries (and the inputs==ledger check above
            # pins the claimed statement to ledger state)
            try:
                with profiler.leg("fiat_shamir"):
                    transfer_mod.TransferVerifier(
                        [t.data for t in in_tokens],
                        [t.data for t in out_tokens],
                        self.pp,
                    ).verify(d["proof"])
            except ValueError as e:
                raise ValidationError(f"invalid transfer proof: {e}") from e
        if len(signatures) != len(in_tokens):
            raise ValidationError("one signature per input owner required")
        for si, (t, sig) in enumerate(zip(in_tokens, signatures)):
            v = sig_verified.get(si) if sig_verified else None
            if v is not None and v[0] == t.owner:
                # batched-plane verdict for THIS owner identity (only pk
                # kinds ever get one — nym/htlc owners stay host-verified)
                if not v[1]:
                    raise ValidationError(
                        "invalid owner signature: rejected by the batched "
                        "signature plane"
                    )
                continue
            try:
                identity.verify_signature(
                    t.owner, signed_payload, sig, nym_params=self.pp.nym_params,
                    now=now,
                )
            except ValueError as e:
                raise ValidationError(f"invalid owner signature: {e}") from e
        return ids, d["outputs"]

    # ------------------------------------------------------------ batching

    def transfer_batch_plan(self, action_bytes: bytes):
        """Block-batched plane hook: extract `(n_in, n_out)` and the
        `(input_points, output_points, proof_bytes)` row the
        `BatchedTransferVerifier` consumes. The statement uses the
        ACTION-claimed inputs — `validate_transfer` separately pins them
        to ledger state, so a verdict computed here is exactly the host
        `TransferVerifier` check. Malformed bytes return None and fall to
        the host path (which rejects them with the precise error)."""
        try:
            d = loads_cached(action_bytes)
            in_tokens = [_ZTOKENS.lookup(raw) for raw in d["inputs"]]
            out_tokens = [_ZTOKENS.lookup(raw) for raw in d["outputs"]]
            proof = d["proof"]
            if not in_tokens or not out_tokens or not isinstance(proof, bytes):
                return None
            shape = (len(in_tokens), len(out_tokens))
            return shape, (
                [t.data for t in in_tokens],
                [t.data for t in out_tokens],
                proof,
            )
        except Exception:
            return None

    def transfer_host_batch(self, rows) -> List[Optional[bool]]:
        """Host-batched proof plane: `rows` are the (input_points,
        output_points, proof_bytes) tuples `transfer_batch_plan` emits for
        groups the device plane did not take. Verified in bulk via
        `transfer_mod.verify_transfer_proofs` — batched commitment
        multiexps plus ONE block-level Fiat-Shamir hash dispatch. True
        verdicts only are decisive; False/None rows fall back to the
        scalar `TransferVerifier`, which owns the precise error."""
        return transfer_mod.verify_transfer_proofs(list(rows), self.pp)

    def transfer_sign_plan(self, action_bytes: bytes):
        """Signature-plane hook: the ACTION-claimed input owners, one per
        required signature (`validate_transfer` pins claimed inputs to
        ledger state before any verdict is applied). Non-`pk` owner
        kinds (nym, htlc) survive here — the pipeline's collector routes
        them host when the identity cache yields no public key."""
        try:
            d = loads_cached(action_bytes)
            owners = [_ZTOKENS.lookup(raw).owner for raw in d["inputs"]]
            return owners or None
        except Exception:
            return None

    def issue_sign_plan(self, action_bytes: bytes):
        """Signature-plane hook: non-anonymous issues carry the named
        issuer's signature; anonymous issues need none."""
        try:
            d = loads_cached(action_bytes)
            if d["anon"]:
                return None
            issuer = d["issuer"]
            return issuer if isinstance(issuer, bytes) and issuer else None
        except Exception:
            return None

    def batch_verifier(self, mesh=None):
        """The cached `BatchedTransferVerifier` on the driver's device,
        built on the first call (the import and the window tables stay
        out of the constructor, so building a driver stays light). The
        cache holds the tables; `mesh` (a `DeviceMesh` whose first device
        is the driver's) is re-bound on every call, None unbinding, so each
        caller (each block pipeline sharing this driver) gets the dispatch
        it asked for, never a mesh another caller left bound."""
        if self._batch_verifier is None:
            from ...crypto.batch import BatchedTransferVerifier

            self._batch_verifier = BatchedTransferVerifier(self.pp, device=self.device,
                                                           mesh=mesh)
        else:
            self._batch_verifier.set_mesh(mesh)
        return self._batch_verifier

    def batch_prover(self, mesh=None):
        """The `BatchedTransferProver` on the driver's device, the
        prove-side twin of `batch_verifier`: the module-level
        `prover_for` cache that `TransferProver.batch` shares, `mesh`
        re-bound on every call as in `batch_verifier`."""
        from ...crypto.batch_prove import prover_for

        return prover_for(self.pp, device=self.device, mesh=mesh)

    # ------------------------------------------------------------ tokens

    def output_to_unspent(self, token_id, output_bytes, metadata_bytes=None) -> UnspentToken:
        t = ZkToken.from_bytes(output_bytes)
        if metadata_bytes is None:
            raise ValueError("zkatdlog tokens need metadata to be opened")
        m = Metadata.from_bytes(metadata_bytes)
        token_type, value, owner = token_in_the_clear(t, m, self.pp.ped_params)
        return UnspentToken(token_id, Owner(owner), token_type, str(value))

    def output_owner(self, output_bytes: bytes) -> bytes:
        return _ZTOKENS.lookup(output_bytes).owner

    def verify_owner_signature(self, owner_identity, message, signature) -> None:
        identity.verify_signature(
            owner_identity, message, signature, nym_params=self.pp.nym_params
        )
