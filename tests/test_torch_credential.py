"""PyTorch port, anonymous credentials (`crypto/credential.py`): blind
issuance and selective disclosure over the port's host PS machinery.
Mirrors `tests/test_credential.py`, and holds the port byte for byte
against the JAX package for one `random.Random` seed: the issuer's keys,
the blind issuance and every presentation are the same bytes, and each
package verifies the other's presentations."""

import random

import pytest

from fabric_token_sdk_tpu.crypto import credential as ref_cr
from fabric_token_sdk_tpu_torch.crypto import credential as cr
from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads


def test_credential_lifecycle(rng):
    issuer = cr.CredentialIssuer.create(n_attrs=3, rng=rng)
    attrs = [21, 7, 1999]
    user = cr.CredentialUser(issuer.public, attrs, rng)
    rec, req = user.request_credential()
    cred = user.finish(rec, issuer.blind_issue(req))
    verifier = cr.CredentialVerifier(issuer.public)
    p1 = user.present(cred, b"login-challenge-1")
    assert verifier.verify(p1, b"login-challenge-1") == {}
    p2 = user.present(cred, b"login-challenge-2", disclose=[1])
    assert verifier.verify(p2, b"login-challenge-2", expect_disclosed={1: 7}) == {1: 7}
    with pytest.raises(ValueError):
        verifier.verify(p2, b"login-challenge-2", expect_disclosed={1: 8})
    with pytest.raises(ValueError):
        verifier.verify(p2, b"other-message")
    d = loads(p2)
    d["d"]["1"] = 8
    with pytest.raises(ValueError):
        verifier.verify(dumps(d), b"login-challenge-2")
    p3 = user.present(cred, b"login-challenge-1")
    assert p3 != p1


def test_credential_forgery_rejected(rng):
    issuer = cr.CredentialIssuer.create(n_attrs=2, rng=rng)
    user = cr.CredentialUser(issuer.public, [5, 6], rng)
    rec, req = user.request_credential()
    cred = user.finish(rec, issuer.blind_issue(req))
    other = cr.CredentialIssuer.create(n_attrs=2, rng=rng)
    p = user.present(cred, b"m")
    with pytest.raises(ValueError):
        cr.CredentialVerifier(other.public).verify(p, b"m")


def _lifecycle(mod, seed):
    rng = random.Random(seed)
    issuer = mod.CredentialIssuer.create(n_attrs=3, rng=rng)
    user = mod.CredentialUser(issuer.public, [21, 7, 1999], rng)
    rec, req = user.request_credential()
    issued = issuer.blind_issue(req)
    cred = user.finish(rec, issued)
    return issuer, [req, issued, user.present(cred, b"m1"),
                    user.present(cred, b"m2", disclose=[0, 2])]


def test_credential_bytes_equal_across_packages():
    issuer, port = _lifecycle(cr, 0xC4ED)
    ref_issuer, ref = _lifecycle(ref_cr, 0xC4ED)
    # dataclasses of two packages: equal field by field (their reprs), and
    # the presentations equal bytes
    assert [repr(x) for x in port] == [repr(x) for x in ref]
    assert port[2:] == ref[2:] and isinstance(port[2], bytes)
    assert repr(issuer.public) == repr(ref_issuer.public)
    for mod, pub in ((cr, ref_issuer.public), (ref_cr, issuer.public)):
        verifier = mod.CredentialVerifier(pub)
        assert verifier.verify(port[2], b"m1") == {}
        assert verifier.verify(ref[3], b"m2", expect_disclosed={0: 21, 2: 1999}) == {
            0: 21, 2: 1999}
        with pytest.raises(ValueError):
            verifier.verify(port[3], b"m1")
