"""PyTorch port, the host-path profiler and the parse caches: mirrors of
the sub-leg unit tests of `tests/test_profiler.py` (zero cost outside a
window, exclusive sub-leg timing, windows and totals), the legs' cover
of a validation run through `RequestValidator`, the metrics core's
histogram, and `BytesCache` hits, misses and disabled capacity; and the
sampling profiler's cases (off means no thread, the lifecycle, a bounded
table, roles, verdicts unchanged under sampling), with `hz`/`max_stacks`
as arguments where the reference reads `FTS_PROF_HZ`/`FTS_PROF_MAX_STACKS`."""

import random
import threading
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


@pytest.fixture(autouse=True)
def _sampler_off():
    yield
    profiler.stop()


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


# ------------------------------------------------------------ the sampling profiler


def test_off_means_zero_profiler_threads(monkeypatch):
    """Off by default and at hz 0: no sampler thread. The reference's
    `FTS_PROF_HZ` is not read: set, it starts nothing."""
    assert profiler.start() is None
    assert profiler.active() is None
    assert profiler.start(hz=0) is None
    monkeypatch.setenv("FTS_PROF_HZ", "200")
    monkeypatch.setenv("FTS_PROF_MAX_STACKS", "1")
    assert profiler.start() is None
    assert profiler.SamplingProfiler().max_stacks == profiler.DEFAULT_MAX_STACKS == 2000
    assert not any(t.name.startswith("fts-prof") for t in threading.enumerate())


def test_start_stop_lifecycle():
    p = profiler.start(hz=200.0)
    assert p is not None and p.running()
    assert any(t.name == "fts-prof" for t in threading.enumerate())
    assert profiler.start(hz=200.0) is p  # idempotent: the live sampler
    stopped = profiler.stop()
    assert stopped is p and not p.running()
    assert profiler.active() is None
    assert profiler.stop() is None


def _parked_thread(name, release, role=None, depth=0):
    """A thread parked `depth` recursion frames deep: distinct depths give
    distinct collapsed stacks."""
    ready = threading.Event()

    def park(d):
        if d > 0:
            return park(d - 1)
        if role:
            profiler.set_thread_role(role)
        ready.set()
        release.wait(timeout=30)

    t = threading.Thread(target=park, args=(depth,), name=name, daemon=True)
    t.start()
    ready.wait(timeout=10)
    return t


def test_sampler_table_is_bounded_and_drops_are_counted():
    release = threading.Event()
    threads = [_parked_thread(f"park-{i}", release, depth=i) for i in range(3)]
    try:
        dropped0 = mx.REGISTRY.counter("prof.dropped").value
        p = profiler.SamplingProfiler(hz=0, max_stacks=1)
        p.sample()
        assert p.stack_count() == 1
        assert p.dropped >= 1 and mx.REGISTRY.counter("prof.dropped").value - dropped0 >= 1
        assert p.samples == 1
        p.sample()  # a known stack keeps counting at the cap
        assert p.stack_count() == 1
        assert sum(p.collapsed().values()) >= 2
    finally:
        release.set()
        for t in threads:
            t.join(timeout=10)


def test_roles_registration_and_name_classification():
    release = threading.Event()
    threads = [_parked_thread("worker-x", release, role="client"),
               _parked_thread("fts-block-commit", release),
               _parked_thread("fts-commit-host_0", release)]
    try:
        p = profiler.SamplingProfiler(hz=0, max_stacks=100)
        p.sample()
        assert p.collapsed(role="client"), p.collapsed()
        # both named threads (other tests' engine threads may be alive too)
        parked = {k: v for k, v in p.collapsed(role="commit-worker").items()
                  if "test_torch_profiler:park" in k}
        assert sum(parked.values()) == 2, p.collapsed()
        for key in p.collapsed(role="client"):  # flamegraph-shaped
            assert key.startswith("client;")
            assert ":" in key.split(";", 1)[1]
        # the stack heuristic, where neither registration nor name applies
        assert profiler._classify(-1, "t", [("/x/remote.py", "handle")]) == "remote-handler"
        assert profiler._classify(-1, "t", [("/x/orderer.py", "flush")]) == "stage-a-driver"
        assert profiler._classify(-1, "t", [("/x/pipeline.py", "submit")]) == "stage-a-driver"
        assert profiler._classify(-1, "t", [("/x/other.py", "run")]) == "other"
    finally:
        release.set()
        for t in threads:
            t.join(timeout=10)


def _run_scenario():
    """A fabtoken issue, then two transfers of which the second
    double-spends, on a `Network` on the CPU: the statuses and the last
    block's breakdown."""
    from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
    from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
    from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction

    pp = FabTokenPublicParams()
    network = Network(RequestValidator(FabTokenDriver(pp)), policy=BlockPolicy(max_block_txs=8),
                      device="cpu")
    parties = {name: Party(name, FabTokenDriver(pp), network)
               for name in ("issuer-node", "alice-node", "bob-node")}
    parties["issuer-node"].new_issuer_wallet("issuer")
    alice = parties["alice-node"].new_owner_wallet("alice", anonymous=False)
    bob = parties["bob-node"].new_owner_wallet("bob", anonymous=False)
    tx = Transaction(parties["issuer-node"], "seed")
    tx.issue("issuer", "USD", [5], [alice.recipient_identity()], anonymous=False)
    tx.collect_endorsements(None)
    tx.submit()
    alice_p = parties["alice-node"]
    tid = alice_p.vault.token_ids()[0]

    def spend(anchor):
        req = alice_p.tms.new_request(anchor)
        tokens, metas = alice_p.vault.get_many([tid])
        alice_p.tms.add_transfer(req, [tid], tokens, metas, "USD", [5],
                                 [bob.recipient_identity()])
        alice_p.tms.sign_transfers(req)
        return req.to_bytes()

    events = network.submit_many([spend("pay-ok"), spend("pay-dup")])
    return [e.status.value for e in events], network.health()["last_block"]["breakdown"]


def test_sampler_never_perturbs_verdicts():
    base_statuses, base_bd = _run_scenario()
    assert base_statuses == ["Valid", "Invalid"]
    p = profiler.start(hz=500.0)
    assert p is not None
    try:
        prof_statuses, prof_bd = _run_scenario()
    finally:
        profiler.stop()
    assert prof_statuses == base_statuses
    assert p.samples > 0
    for leg_name in profiler.LEGS:  # the same legs, by key
        assert (f"host_{leg_name}_s" in base_bd) == (f"host_{leg_name}_s" in prof_bd)
