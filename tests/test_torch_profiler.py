"""PyTorch port, the host-path profiler and the parse caches: mirrors of
the sub-leg unit tests of `tests/test_profiler.py` (zero cost outside a
window, exclusive sub-leg timing, windows and totals), the legs' cover
of a validation run through `RequestValidator`, the metrics core's
histogram, and `BytesCache` hits, misses and disabled capacity."""

import random
import time

import pytest

from fabric_token_sdk_tpu_torch.api.request import TokenRequest
from fabric_token_sdk_tpu_torch.api.tms import ManagementService
from fabric_token_sdk_tpu_torch.api.wallet import IssuerWallet, OwnerWallet, WalletRegistry
from fabric_token_sdk_tpu_torch.crypto import serialization as ser, sign
from fabric_token_sdk_tpu_torch.drivers.fabtoken import FabTokenDriver, FabTokenPublicParams
from fabric_token_sdk_tpu_torch.models.token import ID
from fabric_token_sdk_tpu_torch.utils import metrics as mx
from fabric_token_sdk_tpu_torch.utils import profiler


def test_leg_is_passthrough_without_collector():
    before_totals = profiler.leg_totals()
    before_count = mx.REGISTRY.histogram("ledger.host.unmarshal.seconds").count
    with profiler.leg("unmarshal"):
        pass
    assert profiler.leg_totals() == before_totals
    assert mx.REGISTRY.histogram("ledger.host.unmarshal.seconds").count == before_count


def test_nested_legs_bill_exclusively():
    with profiler.collect() as legs:
        with profiler.leg("conservation"):
            time.sleep(0.02)
            with profiler.leg("sig_verify"):
                time.sleep(0.03)
            time.sleep(0.01)
    assert legs["sig_verify"] >= 0.03
    assert 0.02 <= legs["conservation"] < 0.06
    assert legs["conservation"] + legs["sig_verify"] < 0.09


def test_collect_windows_restore_and_totals_accumulate():
    t0 = profiler.leg_totals().get("input_match", 0.0)
    with profiler.collect() as outer:
        with profiler.leg("input_match"):
            pass
        with profiler.collect() as inner:
            with profiler.leg("input_match"):
                pass
        assert "input_match" in inner
    assert "input_match" in outer
    assert profiler.leg_totals()["input_match"] >= t0
    before = profiler.leg_totals()
    with profiler.leg("input_match"):
        pass
    assert profiler.leg_totals() == before


def test_validation_sublegs_cover_host_time():
    """The port's counterpart of the reference's breakdown-coverage test
    (which needs the network services): a fabtoken issue and transfer
    validated in a `collect()` window. The exclusive legs never sum past
    the window's wall time, explain most of it, and each timed leg adds
    to its `ledger.host.<leg>.seconds` histogram."""
    rng = random.Random(7)
    driver = FabTokenDriver(FabTokenPublicParams())
    alice = OwnerWallet("alice", anonymous=False, rng=rng)
    bob = OwnerWallet("bob", anonymous=False, rng=rng)
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    driver.pp.add_issuer(issuer.identity)
    tms = ManagementService(
        driver, WalletRegistry(owners={"alice": alice, "bob": bob},
                               issuers={"issuer": issuer}), rng=rng)
    req = tms.new_request("tx1")
    tms.add_issue(req, issuer, "USD", [12], [alice.recipient_identity()], anonymous=False)
    tms.sign_issues(req)
    v = tms.validator()
    (_, outs), = v.validate(req, lambda i: None).outputs
    req2 = tms.new_request("tx2")
    tms.add_transfer(req2, [ID("tx1", 0)], [outs[0]], req.issues[0].outputs_metadata,
                     "USD", [7, 5], [bob.recipient_identity(), alice.recipient_identity()])
    tms.sign_transfers(req2)
    ledger = {ID("tx1", 0): outs[0]}
    raws = (req.to_bytes(), req2.to_bytes())

    hists = {n: mx.histogram(f"ledger.host.{n}.seconds") for n in profiler.LEGS}
    before = {n: h.count for n, h in hists.items()}
    t0 = time.perf_counter()
    with profiler.collect() as legs:
        for raw in raws:
            v.validate(TokenRequest.from_bytes(raw), ledger.__getitem__)
    wall = time.perf_counter() - t0
    assert {"unmarshal", "sig_verify", "conservation", "input_match"} <= set(legs)
    assert set(legs) <= set(profiler.LEGS)
    assert sum(legs.values()) <= wall
    assert sum(legs.values()) / wall > 0.5, (legs, wall)
    for n, h in hists.items():
        assert (h.count > before[n]) == (n in legs)


def test_histogram_buckets_and_registry():
    h = mx.histogram("test.torch.hist")
    assert mx.histogram("test.torch.hist") is h  # get-or-create
    assert h.buckets == mx.DEFAULT_BUCKETS and h.count == 0
    for v in (0.0005, 0.001, 0.003, 0.003, 1000.0):
        h.observe(v)
    assert h.count == 5
    assert h._counts[:2] == [2, 2]  # <= 0.001 and (0.001, 0.005]
    assert h._counts[-1] == 1  # past the last bound: the +Inf bucket
    assert sum(h._counts) == 5


def test_bytes_cache_hits_misses_and_disabled(monkeypatch):
    calls = []

    def parse(raw):
        calls.append(raw)
        if raw == b"bad":
            raise ValueError("bad bytes")
        return {"v": raw}

    hits, misses = (mx.REGISTRY.counter(f"parse.cache.{k}") for k in ("hits", "misses"))
    cache = ser.BytesCache(parse, capacity=2)
    h0, m0 = hits.value, misses.value
    a = cache.lookup(b"a")
    assert cache.lookup(b"a") is a  # shared, parsed once
    cache.lookup(b"b")
    cache.lookup(b"c")  # evicts a (LRU)
    assert len(cache) == 2
    cache.lookup(b"a")
    assert calls == [b"a", b"b", b"c", b"a"]
    assert (hits.value - h0, misses.value - m0) == (1, 4)
    for _ in range(2):  # failures re-raise and are never cached
        with pytest.raises(ValueError):
            cache.lookup(b"bad")
    assert calls.count(b"bad") == 2 and len(cache) == 2

    monkeypatch.setenv("FTS_PARSE_CACHE", "0")
    off = ser.BytesCache(parse)
    h0, m0 = hits.value, misses.value
    off.lookup(b"z")
    off.lookup(b"z")
    assert len(off) == 0 and (hits.value, misses.value) == (h0, m0)
    assert calls.count(b"z") == 2
    monkeypatch.setenv("FTS_PARSE_CACHE", "5")
    off.clear()  # the env capacity re-resolves after clear
    assert off.capacity == 5
    raw = ser.dumps({"k": 1})
    assert ser.loads_cached(raw) is ser.loads_cached(raw)
    ser.parse_caches_clear()
