"""Shared inputs of the port's batch-verify tests (not a test module):
transfers proved with the port's host prover from a seeded
`random.Random`, the planted bad rows of a range-proof block, and the
verdicts of a host `TransferVerifier`."""

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, token as tok
from fabric_token_sdk_tpu_torch.crypto import transfer as tr
from fabric_token_sdk_tpu_torch.crypto.rangeproof import RangeProof


def prove_txs(pp, count, rng, shape=(1, 1)):
    """`count` valid transfers of `shape` = (inputs, outputs)."""
    out = []
    for _ in range(count):
        vals = [rng.randrange(1, 50) for _ in range(shape[0])]
        ins, inw = tok.tokens_with_witness(vals, "USD", pp.ped_params, rng)
        outs_v = vals if shape[1] == shape[0] else [sum(vals)] + [0] * (shape[1] - 1)
        outs, outw = tok.tokens_with_witness(outs_v, "USD", pp.ped_params, rng)
        out.append((ins, outs, tr.TransferProver(inw, outw, ins, outs, pp, rng).prove()))
    return out


def _edit_range(raw: bytes, edit) -> bytes:
    p = tr.TransferProof.from_bytes(raw)
    r = RangeProof.from_bytes(p.range_correctness)
    edit(r)
    return tr.TransferProof(p.wf, r.to_bytes()).to_bytes()


def _bump_value_resp(r):
    m = r.membership_proofs[0][0]
    m.value_resp = (m.value_resp + 1) % hm.R


def _swap_digits(r):
    row = r.digit_commitments[-1]
    row[0], row[1] = row[1], row[0]


def _bump_challenge(r):
    r.challenge = (r.challenge + 1) % hm.R


def _truncate(raw: bytes) -> bytes:
    p = tr.TransferProof.from_bytes(raw)
    return tr.TransferProof(p.wf, p.range_correctness[:-5]).to_bytes()


def _drop(raw: bytes) -> bytes:
    return tr.TransferProof(tr.TransferProof.from_bytes(raw).wf, None).to_bytes()


PLANTS = {
    "membership value_resp bumped": lambda raw: _edit_range(raw, _bump_value_resp),
    "digit commitments swapped": lambda raw: _edit_range(raw, _swap_digits),
    "range challenge bumped": lambda raw: _edit_range(raw, _bump_challenge),
    "range bytes truncated": _truncate,
    "range proof missing": _drop,
}


def plant_range_rows(txs, start: int):
    """Replace rows start, start+1, ... with one planted fault each, in
    the order of PLANTS; returns the new list and the planted rows."""
    txs = list(txs)
    rows = []
    for j, plant in enumerate(PLANTS.values()):
        i = start + j
        txs[i] = (txs[i][0], txs[i][1], plant(txs[i][2]))
        rows.append(i)
    return txs, rows


def host_verdicts(txs, verifier_cls, pp):
    out = []
    for ins, outs, raw in txs:
        try:
            verifier_cls(ins, outs, pp).verify(raw)
            out.append(True)
        except Exception:
            out.append(False)
    return out
