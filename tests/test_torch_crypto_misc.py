"""PyTorch port, the host protocols above the kernels: nym signatures,
identity signatures (`pk`, `nym`, `htlc`), the auditor check, the issue
proof, one-out-of-many proofs (`crypto/o2omp.py`), the quantity model and
HTLC scripts, each mirroring its JAX package test and held byte for byte
against the JAX package for one seed, each package verifying the other's
bytes."""

import hashlib
import importlib
import random
import time
from types import SimpleNamespace

import pytest

from fabric_token_sdk_tpu_torch.crypto import audit, hostmath as hm, issue as issue_mod
from fabric_token_sdk_tpu_torch.crypto import nym, o2omp, pedersen, sign, token as tok
from fabric_token_sdk_tpu_torch.crypto.setup import setup
from fabric_token_sdk_tpu_torch.drivers import identity
from fabric_token_sdk_tpu_torch.models.quantity import Quantity
from fabric_token_sdk_tpu_torch.services.interop import htlc


def _package(root):
    mods = ("crypto.audit", "crypto.hostmath", "crypto.issue", "crypto.nym", "crypto.o2omp",
            "crypto.pedersen", "crypto.setup", "crypto.sign", "crypto.token",
            "drivers.identity")
    return SimpleNamespace(root=root, **{
        m.split(".")[1]: importlib.import_module(f"{root}.{m}") for m in mods})


REF = _package("fabric_token_sdk_tpu")
PORT = _package("fabric_token_sdk_tpu_torch")


@pytest.fixture(scope="module")
def pp():
    return setup(base=4, exponent=2, rng=random.Random(0xF75))


# ------------------------------------------------------------------ mirrors

def test_o2omp_roundtrip(rng):
    ped = [hm.rand_g1(rng), hm.rand_g1(rng)]
    nbits = 3
    index = 5
    r = hm.rand_zr(rng)
    commitments = [hm.rand_g1(rng) for _ in range(1 << nbits)]
    commitments[index] = hm.g1_mul(ped[1], r)  # a commitment to 0
    raw = o2omp.Prover(commitments, b"msg", ped, nbits, index, r, rng).prove()
    o2omp.Verifier(commitments, b"msg", ped, nbits).verify(raw)
    with pytest.raises(ValueError):
        o2omp.Verifier(commitments, b"other", ped, nbits).verify(raw)
    commitments[index] = hm.rand_g1(rng)
    with pytest.raises(ValueError):
        o2omp.Verifier(commitments, b"msg", ped, nbits).verify(raw)


def test_o2omp_malformed_proof_rejected_not_crash(rng):
    """Garbage bytes raise ValueError, never TypeError/KeyError (the
    o2omp half of `tests/test_crypto_misc.py:76`)."""
    from fabric_token_sdk_tpu_torch.crypto.serialization import dumps

    ped = [hm.rand_g1(rng), hm.rand_g1(rng)]
    v = o2omp.Verifier([hm.rand_g1(rng) for _ in range(4)], b"m", ped, 2)
    for garbage in [b"not json", dumps({"L": [5], "A": []}), dumps({"x": 1})]:
        with pytest.raises(ValueError):
            v.verify(garbage)


def test_nym_signature(rng):
    params = [hm.rand_g1(rng), hm.rand_g1(rng)]
    sk = hm.rand_zr(rng)
    ny, bf = nym.new_nym(sk, params, rng)
    raw = nym.NymSigner(sk, bf, ny, params).sign(b"transfer-tx-1", rng)
    nym.NymVerifier(ny, params).verify(b"transfer-tx-1", raw)
    with pytest.raises(ValueError):
        nym.NymVerifier(ny, params).verify(b"transfer-tx-2", raw)
    other, _ = nym.new_nym(hm.rand_zr(rng), params, rng)
    with pytest.raises(ValueError):
        nym.NymVerifier(other, params).verify(b"transfer-tx-1", raw)


def _signed_identity(kind, rng, nym_params):
    """(identity blob, message, signature, tampered signature) of a kind."""
    msg = b"spend-tx"
    if kind == "pk":
        key = sign.keygen(rng)
        return identity.pk_identity(key.public), msg, key.sign(msg, rng), key.sign(b"x", rng)
    if kind == "nym":
        sk = hm.rand_zr(rng)
        ny, bf = nym.new_nym(sk, nym_params, rng)
        signer = nym.NymSigner(sk, bf, ny, nym_params)
        return identity.nym_identity(ny), msg, signer.sign(msg, rng), signer.sign(b"x", rng)
    recipient = sign.keygen(rng)
    script = htlc.lock(identity.pk_identity(sign.keygen(rng).public),
                       identity.pk_identity(recipient.public),
                       hashlib.sha256(b"pre").digest(), time.time() + 3600)
    sig = htlc.claim(script, b"pre", lambda m: recipient.sign(m, rng), msg)
    bad = htlc.HTLCClaimSignature(b"wrong", recipient.sign(msg, rng)).to_bytes()
    return script.to_identity(), msg, sig, bad


@pytest.mark.parametrize("kind", ["pk", "nym", "htlc"])
def test_identity_signature(rng, pp, kind):
    ident, msg, sig, bad = _signed_identity(kind, rng, pp.nym_params)
    assert identity.identity_kind(ident) == kind
    identity.verify_signature(ident, msg, sig, nym_params=pp.nym_params)
    with pytest.raises(ValueError):
        identity.verify_signature(ident, msg, bad, nym_params=pp.nym_params)
    with pytest.raises(ValueError):
        identity.verify_signature(ident, b"tampered", sig, nym_params=pp.nym_params)
    assert (identity.public_key(ident) is not None) == (kind == "pk")


def test_auditor_check(rng):
    ped = [hm.rand_g1(rng) for _ in range(3)]
    bf = hm.rand_zr(rng)
    com = pedersen.token_commitment("USD", 9, bf, ped)
    t = tok.Token(owner=b"alice", data=com)
    at = audit.auditable_token(t, b"alice-audit-info", "USD", 9, bf)
    key = sign.keygen(rng)
    auditor = audit.Auditor(ped, signer=key)
    auditor.check([at], [])
    key.public.verify(b"request", auditor.endorse(b"request", rng))
    with pytest.raises(ValueError):
        auditor.check_token(audit.auditable_token(t, b"", "USD", 8, bf))


@pytest.mark.parametrize("anonymous", [True, False])
def test_issue_proof(rng, pp, anonymous):
    tokens, wits = tok.tokens_with_witness([6, 9], "EUR", pp.ped_params, rng)
    raw = issue_mod.IssueProver(wits, tokens, anonymous, pp, rng).prove()
    issue_mod.IssueVerifier(tokens, anonymous, pp).verify(raw)
    tokens2, _ = tok.tokens_with_witness([6, 9], "USD", pp.ped_params, rng)
    with pytest.raises(ValueError):
        issue_mod.IssueVerifier(tokens2, anonymous, pp).verify(raw)


def test_quantity_model():
    q = Quantity.from_uint64(255)
    assert q.hex() == "0xff" and q.decimal() == "255"
    assert Quantity.from_hex("0xff").value == 255
    assert q.add(Quantity.from_uint64(1)).value == 256
    with pytest.raises(ValueError):
        q.sub(Quantity.from_uint64(256))
    with pytest.raises(ValueError):
        Quantity(1 << 64, 64)
    with pytest.raises(ValueError):
        Quantity.from_hex("ff")


def test_htlc_claim_reclaim(rng):
    sender, recipient = sign.keygen(rng), sign.keygen(rng)
    preimage = b"super-secret"
    deadline = time.time() + 3600
    script = htlc.lock(identity.pk_identity(sender.public), identity.pk_identity(recipient.public),
                       hashlib.sha256(preimage).digest(), deadline)
    ident = script.to_identity()
    msg = b"spend-tx"
    sig = htlc.claim(script, preimage, lambda m: recipient.sign(m, rng), msg)
    identity.verify_signature(ident, msg, sig)
    with pytest.raises(ValueError):
        htlc.claim(script, b"wrong", lambda m: recipient.sign(m, rng), msg)
    forged = htlc.HTLCClaimSignature(b"wrong", recipient.sign(msg, rng)).to_bytes()
    with pytest.raises(ValueError):
        identity.verify_signature(ident, msg, forged)
    with pytest.raises(ValueError):
        htlc.reclaim(script, lambda m: sender.sign(m, rng), msg)
    sig2 = htlc.reclaim(script, lambda m: sender.sign(m, rng), msg, now=deadline + 1)
    htlc.verify_htlc_spend(ident, msg, sig2, now=deadline + 1)
    with pytest.raises(ValueError):
        identity.verify_signature(ident, msg, sig2)


# ------------------------------------------------------------------ across packages

@pytest.fixture(scope="module")
def both_pp():
    return {P.root: P.setup.setup(base=4, exponent=2, rng=random.Random(0xF75)) for P in (REF, PORT)}


def _nym_case(P, pp, seed):
    rng = random.Random(seed)
    sk = P.hostmath.rand_zr(rng)
    ny, bf = P.nym.new_nym(sk, pp.nym_params, rng)
    raw = P.nym.NymSigner(sk, bf, ny, list(pp.nym_params)).sign(b"tx", rng)
    return P.identity.nym_identity(ny), raw


def _issue_case(P, pp, seed, anonymous):
    rng = random.Random(seed)
    tokens, wits = P.token.tokens_with_witness([3, 12], "EUR", pp.ped_params, rng)
    return tokens, P.issue.IssueProver(wits, tokens, anonymous, pp, rng).prove()


def _audit_case(P, pp, seed):
    rng = random.Random(seed)
    bf = P.hostmath.rand_zr(rng)
    com = P.pedersen.token_commitment("USD", 11, bf, pp.ped_params)
    key = P.sign.keygen(rng)
    at = P.audit.auditable_token(P.token.Token(owner=b"o", data=com), b"info", "USD", 11, bf)
    P.audit.Auditor(pp.ped_params, signer=key).check([at], [])
    return com, bf, P.identity.pk_identity(key.public), \
        P.audit.Auditor(pp.ped_params, signer=key).endorse(b"request", rng)


def test_nym_and_audit_bytes_equal_across_packages(both_pp):
    ref_pp, port_pp = both_pp[REF.root], both_pp[PORT.root]
    ident, raw = _nym_case(PORT, port_pp, 5)
    assert (ident, raw) == _nym_case(REF, ref_pp, 5)
    for P, pp in ((REF, ref_pp), (PORT, port_pp)):
        P.identity.verify_signature(ident, b"tx", raw, nym_params=pp.nym_params)
        with pytest.raises(ValueError):
            P.identity.verify_signature(ident, b"ty", raw, nym_params=pp.nym_params)
    com, bf, auditor, sig = _audit_case(PORT, port_pp, 6)
    assert (com, bf, auditor, sig) == _audit_case(REF, ref_pp, 6)
    for P, pp in ((REF, ref_pp), (PORT, port_pp)):
        P.identity.verify_signature(auditor, b"request", sig)
        at = P.audit.auditable_token(P.token.Token(owner=b"o", data=com), b"", "USD", 12, bf)
        with pytest.raises(ValueError):
            P.audit.Auditor(pp.ped_params).check_token(at)


@pytest.mark.parametrize("anonymous", [True, False])
def test_issue_proof_bytes_equal_across_packages(both_pp, anonymous):
    ref_pp, port_pp = both_pp[REF.root], both_pp[PORT.root]
    tokens, raw = _issue_case(PORT, port_pp, 7, anonymous)
    assert (tokens, raw) == _issue_case(REF, ref_pp, 7, anonymous)
    for P, pp in ((REF, ref_pp), (PORT, port_pp)):
        P.issue.IssueVerifier(tokens, anonymous, pp).verify(raw)
        with pytest.raises(ValueError):
            P.issue.IssueVerifier(tokens[::-1], anonymous, pp).verify(raw)


def _o2omp_case(P, seed, nbits=3, index=5):
    rng = random.Random(seed)
    hm_ = P.hostmath
    ped = [hm_.rand_g1(rng), hm_.rand_g1(rng)]
    r = hm_.rand_zr(rng)
    commitments = [hm_.rand_g1(rng) for _ in range(1 << nbits)]
    commitments[index] = hm_.g1_mul(ped[1], r)
    raw = P.o2omp.Prover(commitments, b"msg", ped, nbits, index, r, rng).prove()
    return ped, commitments, raw


def test_o2omp_bytes_equal_across_packages():
    ped, commitments, raw = _o2omp_case(PORT, 8)
    assert (ped, commitments, raw) == _o2omp_case(REF, 8)
    for P in (REF, PORT):
        P.o2omp.Verifier(commitments, b"msg", ped, 3).verify(raw)
        with pytest.raises(ValueError):
            P.o2omp.Verifier(commitments, b"msg", ped[::-1], 3).verify(raw)
