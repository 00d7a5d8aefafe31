"""PyTorch port, the sign plane: `crypto/sign.py` (host copy) and
`crypto/batch_sign.py:BatchedSchnorrVerifier`, against the JAX package's
batched verifier and both packages' host `PublicKey.verify`.

The port runs on the CPU here (device="cpu": the plain torch versions of
the G1 kernels). Rows cover every class of the reference's differential
test: valid signatures, bit-flipped `c` and `z`, a flipped message, a
wrong public key, an unparsable blob and a bool challenge (both None)."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch_sign as ref_bs, sign as ref_sign
from fabric_token_sdk_tpu_torch.crypto import batch_sign as bs, sign
from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
from fabric_token_sdk_tpu_torch.parallel import MeshConfig, make_mesh
from fabric_token_sdk_tpu_torch.utils import metrics as mx

# The plain versions are many small tensor ops: one intra-op thread runs
# them faster than several and leaves the other test workers their cores.
torch.set_num_threads(1)


def _host_ok(sign_mod, pk_point, msg, sig):
    try:
        sign_mod.PublicKey(pk_point).verify(msg, sig)
        return True
    except ValueError:
        return False


@pytest.fixture(scope="module")
def rows():
    """(rows, expected verdicts): 4 valid, c flipped, z flipped, message
    flipped, wrong pk, an unparsable blob, a bool c."""
    rng = random.Random(0x51)
    keys = [sign.keygen(rng) for _ in range(3)]
    out = []
    for i in range(4):
        k = keys[i % 3]
        out.append((k.public.point, b"pay-%d" % i, k.sign(b"pay-%d" % i, rng)))
    d = loads(keys[0].sign(b"m-c", rng))
    d["c"] ^= 1
    out.append((keys[0].public.point, b"m-c", dumps(d)))
    d = loads(keys[1].sign(b"m-z", rng))
    d["z"] ^= 1 << 7
    out.append((keys[1].public.point, b"m-z", dumps(d)))
    out.append((keys[2].public.point, b"other-message", keys[2].sign(b"m-msg", rng)))
    out.append((keys[1].public.point, b"m-pk", keys[0].sign(b"m-pk", rng)))
    out.append((keys[0].public.point, b"m-junk", b"\x00junk"))
    d = loads(keys[2].sign(b"m-bool", rng))
    d["c"] = True
    out.append((keys[2].public.point, b"m-bool", dumps(d)))
    expect = [True] * 4 + [False] * 4 + [None, None]
    return out, expect


def test_verdicts_match_reference_batched_and_both_hosts(rows):
    rws, expect = rows
    before = mx.REGISTRY.counter("batch.sign.rows").value
    got = bs.BatchedSchnorrVerifier(device="cpu").verify(rws)
    assert got == expect
    assert mx.REGISTRY.counter("batch.sign.rows").value - before == 8  # parsed rows only
    assert got == ref_bs.BatchedSchnorrVerifier().verify(rws)
    for (pk, msg, sig), v in zip(rws[:8], got[:8]):
        assert v == _host_ok(sign, pk, msg, sig) == _host_ok(ref_sign, pk, msg, sig)


def test_verdicts_do_not_depend_on_the_mesh(rows):
    """Bound to the logical (2, 2) mesh the rows run over its 2 row
    groups (a gather msm, a g1_mul and a g1_sub each); the verdicts are
    the unbound ones. A MeshConfig, which names no device, is refused."""
    rws, expect = rows
    mesh = make_mesh(4, mp=2, devices=["cpu"] * 4)
    v = bs.BatchedSchnorrVerifier(device="cpu", mesh=mesh)
    before = mx.REGISTRY.counter("stages.calls").value
    assert v.verify(rws) == expect
    assert mx.REGISTRY.counter("stages.calls").value - before == 3 * 2
    with pytest.raises(TypeError):
        bs.BatchedSchnorrVerifier(device="cpu", mesh=MeshConfig.build(4, mp=2)).verify(rws)


def test_empty_and_unparsable_batches():
    v = bs.BatchedSchnorrVerifier(device="cpu")
    assert v.table.table.device.type == "cpu" and v.table.nbases == 1
    assert v.verify([]) == []
    k = sign.keygen(random.Random(3))
    assert v.verify([(k.public.point, b"m", b"\x00"), (k.public.point, b"m", dumps({"c": 1}))]) \
        == [None, None]


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bs.BatchedSchnorrVerifier()


def test_sign_bytes_equal_reference_for_one_seed():
    k = sign.keygen(random.Random(0x5166))
    ref_k = ref_sign.keygen(random.Random(0x5166))
    assert k.sk == ref_k.sk and k.public.to_bytes() == ref_k.public.to_bytes()
    sig = k.sign(b"block 7", random.Random(8))
    assert sig == ref_k.sign(b"block 7", random.Random(8))
    ref_k.public.verify(b"block 7", sig)
    k.public.verify(b"block 7", sig)
    d = loads(sig)
    com = sign.response_commitment(k.public.point, d["c"], d["z"])
    assert com == ref_sign.response_commitment(k.public.point, d["c"], d["z"])
    assert sign.challenge(k.public.point, com, b"block 7") == d["c"]
    with pytest.raises(ValueError):
        k.public.verify(b"tampered", sig)
    assert sign.verify_many([(k.public.point, b"block 7", sig), (k.public.point, b"x", sig)]) \
        == [True, False]
