"""PyTorch port, the host sigma protocols: mirrors of
`tests/test_crypto_protocols.py` (round trips and tamper rejection of the
setup, ElGamal, Pointcheval-Sanders signing and blind signing,
membership, range, well-formedness, transfer, issue and token
openings). Each case runs in both packages from one seed: the port's
bytes equal the reference's, each package's verifier accepts the
other's proof, and both reject the tampered one. `setup(base=4,
exponent=2)` keeps the pairings cheap."""

import importlib
import random
from types import SimpleNamespace

import pytest

_MODS = ("elgamal", "hostmath", "issue", "pedersen", "pssign", "rangeproof", "setup",
         "sigproof", "token", "transfer", "wellformedness")


def _package(root):
    return SimpleNamespace(root=root, **{
        m: importlib.import_module(f"{root}.crypto.{m}") for m in _MODS})


REF = _package("fabric_token_sdk_tpu")
PORT = _package("fabric_token_sdk_tpu_torch")
BOTH = (REF, PORT)
SEED = 0xF75


@pytest.fixture(scope="module")
def pps():
    """{root: PublicParams} from one seed, equal bytes."""
    out = {P.root: P.setup.setup(base=4, exponent=2, rng=random.Random(SEED)) for P in BOTH}
    assert out[REF.root].serialize() == out[PORT.root].serialize()
    return out


def _both(case):
    """`case(P, rng)` in each package from one seed; the results equal."""
    got = {P.root: case(P, random.Random(SEED + 1)) for P in BOTH}
    assert got[PORT.root] == got[REF.root]
    return got[PORT.root]


def _rejects(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def test_setup_serialize_roundtrip(pps):
    raw = pps[PORT.root].serialize()
    for P in BOTH:
        pp2 = P.setup.PublicParams.deserialize(raw)
        assert pp2.ped_params == pps[PORT.root].ped_params
        assert pp2.range_params.Q == pps[PORT.root].range_params.Q
        assert pp2.max_token_value() == 15
        pp2.validate()
        assert pp2.compute_hash() == pps[PORT.root].compute_hash()


def test_elgamal_roundtrip():
    def case(P, rng):
        sk = P.elgamal.keygen(rng=rng)
        m = P.hostmath.rand_g1(rng)
        ct, _ = sk.pk.encrypt(m, rng)
        assert sk.decrypt(ct) == m
        return m, ct.c1, ct.c2
    _both(case)


def test_pssign_roundtrip_and_tamper():
    def case(P, rng):
        signer = P.pssign.keygen(2, rng)
        sig = signer.sign([5, 11], rng)
        signer.verify([5, 11], sig)
        rnd = signer.randomize(sig, rng)
        signer.verify([5, 11], rnd)  # a randomised signature still verifies
        assert _rejects(lambda: signer.verify([5, 12], sig))
        return (sig.R, sig.S), (rnd.R, rnd.S)
    _both(case)


def test_ps_blind_sign_and_tampered_request():
    def case(P, rng):
        hm = P.hostmath
        signer = P.pssign.keygen(2, rng)
        ped = [hm.rand_g1(rng) for _ in range(3)]
        msgs, bf = [3, 9], hm.rand_zr(rng)
        com = hm.g1_multiexp(ped, msgs + [bf])
        rec = P.pssign.Recipient(msgs, bf, com, P.elgamal.keygen(rng=rng), ped,
                                 P.pssign.VerifierWithHash(pk=signer.pk, Q=signer.Q), rng)
        blind_signer = P.pssign.BlindSigner(signer, ped)
        sig = rec.unblind(blind_signer.blind_sign(rec.request()))  # verifies inside
        req2 = rec.request()
        req2.proof.messages[0] = (req2.proof.messages[0] + 1) % hm.R
        assert _rejects(lambda: blind_signer.blind_sign(req2))
        return sig.R, sig.S
    _both(case)


def test_membership_proof_and_tamper(pps):
    proofs = {}
    for P in BOTH:
        pp, rng = pps[P.root], random.Random(SEED + 2)
        rp = pp.range_params
        bf = P.hostmath.rand_zr(rng)
        com = P.hostmath.g1_multiexp(pp.ped_params[:2], [3, bf])
        w = P.sigproof.MembershipWitness(rp.signed_values[3], 3, bf)
        proof = P.sigproof.MembershipProver(w, com, pp.ped_gen, rp.Q, rp.sign_pk,
                                            pp.ped_params[:2], rng).prove()
        proofs[P.root] = (com, proof.to_bytes())
    assert proofs[REF.root] == proofs[PORT.root]
    com, raw = proofs[PORT.root]
    for P in BOTH:  # each package verifies the proof, and rejects it tampered
        pp = pps[P.root]
        rp = pp.range_params
        verifier = P.sigproof.MembershipVerifier(com, pp.ped_gen, rp.Q, rp.sign_pk,
                                                 pp.ped_params[:2])
        proof = P.sigproof.MembershipProof.from_bytes(raw)
        verifier.verify(proof)
        proof.value_resp = (proof.value_resp + 1) % P.hostmath.R
        assert _rejects(lambda: verifier.verify(proof))


def _range_prover(P, pp, values, rng):
    rp = pp.range_params
    tokens, wits = P.token.tokens_with_witness(values, "USD", pp.ped_params, rng)
    return tokens, P.rangeproof.RangeProver(
        [P.rangeproof.TokenWitness(w.token_type, w.value, w.bf) for w in wits], tokens,
        rp.signed_values, rp.base, rp.exponent, pp.ped_params, rp.sign_pk, pp.ped_gen, rp.Q,
        rng)


def test_range_proof_and_out_of_range(pps):
    def case(P, rng):
        pp = pps[P.root]
        rp = pp.range_params
        tokens, prover = _range_prover(P, pp, [7, 14], rng)
        raw = prover.prove()
        P.rangeproof.RangeVerifier(tokens, rp.base, rp.exponent, pp.ped_params, rp.sign_pk,
                                   pp.ped_gen, rp.Q).verify(raw)
        _, too_big = _range_prover(P, pp, [16], rng)  # > 15
        assert _rejects(too_big.prove)
        return tokens, raw
    tokens, raw = _both(case)
    pp = pps[REF.root]
    rp = pp.range_params
    REF.rangeproof.RangeVerifier(tokens, rp.base, rp.exponent, pp.ped_params, rp.sign_pk,
                                 pp.ped_gen, rp.Q).verify(raw)


def test_transfer_wf_and_unbalanced(pps):
    def case(P, rng):
        pp = pps[P.root]
        tok, wf = P.token, P.wellformedness
        in_t, in_w = tok.tokens_with_witness([5, 10], "USD", pp.ped_params, rng)

        def prove(out_vals):
            out_t, out_w = tok.tokens_with_witness(out_vals, "USD", pp.ped_params, rng)
            witness = wf.TransferWFWitness("USD", [w.value for w in in_w], [w.bf for w in in_w],
                                           [w.value for w in out_w], [w.bf for w in out_w])
            return out_t, wf.TransferWFProver(witness, pp.ped_params, in_t, out_t, rng).prove()

        out_t, raw = prove([7, 8])
        wf.TransferWFVerifier(pp.ped_params, in_t, out_t).verify(raw)
        bad_t, bad = prove([7, 9])  # unbalanced
        assert _rejects(lambda: wf.TransferWFVerifier(pp.ped_params, in_t, bad_t).verify(bad))
        return in_t, out_t, raw, bad
    _both(case)


@pytest.mark.parametrize("values", [([5, 10], [12, 3]), ([9], [9])])
def test_transfer_proof_cross_verifies_and_swapped_outputs_fail(pps, values):
    """2-in/2-out and the 1-in/1-out ownership transfer, which carries no
    range proof."""
    def case(P, rng):
        pp = pps[P.root]
        in_t, in_w = P.token.tokens_with_witness(values[0], "USD", pp.ped_params, rng)
        out_t, out_w = P.token.tokens_with_witness(values[1], "USD", pp.ped_params, rng)
        return in_t, out_t, P.transfer.TransferProver(in_w, out_w, in_t, out_t, pp, rng).prove()
    in_t, out_t, raw = _both(case)
    for P in BOTH:
        pp = pps[P.root]
        proof = P.transfer.TransferProof.from_bytes(raw)
        assert (proof.range_correctness is None) == (len(values[0]) == 1)
        P.transfer.TransferVerifier(in_t, out_t, pp).verify(raw)
        if len(out_t) > 1:
            assert _rejects(lambda: P.transfer.TransferVerifier(
                in_t, list(reversed(out_t)), pp).verify(raw))


@pytest.mark.parametrize("anonymous", [True, False])
def test_issue_proof_and_wrong_type(pps, anonymous):
    def case(P, rng):
        pp = pps[P.root]
        tokens, wits = P.token.tokens_with_witness([6, 9], "EUR", pp.ped_params, rng)
        raw = P.issue.IssueProver(wits, tokens, anonymous, pp, rng).prove()
        P.issue.IssueVerifier(tokens, anonymous, pp).verify(raw)
        tokens2, _ = P.token.tokens_with_witness([6, 9], "USD", pp.ped_params, rng)
        assert _rejects(lambda: P.issue.IssueVerifier(tokens2, anonymous, pp).verify(raw))
        return tokens, raw
    tokens, raw = _both(case)
    REF.issue.IssueVerifier(tokens, anonymous, pps[REF.root]).verify(raw)


def test_token_in_the_clear(pps):
    def case(P, rng):
        pp = pps[P.root]
        tokens, wits = P.token.tokens_with_witness([5], "USD", pp.ped_params, rng)
        t = P.token.Token(owner=b"alice", data=tokens[0])
        meta = P.token.Metadata("USD", 5, wits[0].bf, owner=b"alice")
        assert P.token.token_in_the_clear(t, meta, pp.ped_params) == ("USD", 5, b"alice")
        bad = P.token.Metadata("USD", 6, wits[0].bf)
        assert _rejects(lambda: P.token.token_in_the_clear(t, bad, pp.ped_params))
        return t.to_bytes(), meta.to_bytes()
    _both(case)
