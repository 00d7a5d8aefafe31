"""PyTorch port, the client state plane against the JAX package.

Port mirrors of `tests/test_state_plane.py`: the vault's stores
(`InMemoryTokenStore`, the crash-safe `PersistentTokenStore` with its
journal, snapshot compaction, torn-tail recovery and fault sites), the
(type, owner) selection index, the sharded locker and the selector (its
order, self-hold, deadline budget and fault site), and the ttxdb
integrity fixes. Each differential case runs the same deltas and
selections through both packages and compares what they return, what
they leave on disk (journal and snapshot bytes) and the counters they
move; a journal written by either package recovers in the other.

Contention is pinned by a fixed schedule (one tx holds the tokens, a
second selector sees busy, retries, then times out, or succeeds after an
unlock inside its own backoff), in place of the reference stress test's
scheduling-dependent counter asserts; the free-running threads remain
only for the invariants. fabtoken outputs (clear text, no randomness)
stand for tokens. The SIGKILL chaos case (marked slow in the reference)
has no port counterpart yet.
"""

import importlib
import inspect
import os
import struct
import threading
import time
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(1)

REF, PORT = "fabric_token_sdk_tpu", "fabric_token_sdk_tpu_torch"
OWNER = b"state-test-owner"


def _pkg(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root, fab=m("drivers.fabtoken"), token=m("models.token"),
        vault=m("services.vault"), store=m("services.vault.store"),
        selector=m("services.selector"), selector_mod=m("services.selector.selector"),
        ttxdb=m("services.ttxdb.db"), request=m("api.request"),
        ledger=m("services.network.ledger"), faults=m("utils.faults"), mx=m("utils.metrics"))


PKGS = {root: _pkg(root) for root in (REF, PORT)}
S = PKGS[PORT]


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    for P in PKGS.values():
        P.faults.clear()


def both(scenario, *args):
    """Run `scenario(P, *args)` in each package; assert equal results."""
    got = {root: scenario(P, *args) for root, P in PKGS.items()}
    assert got[PORT] == got[REF]
    return got[PORT]


def ctr(P, name):
    return P.mx.REGISTRY.counter(name).value


class Counters:
    """Deltas of some counters of package P since construction."""

    def __init__(self, P, *names):
        self.P, self.base = P, {n: ctr(P, n) for n in names}

    def __call__(self):
        return {n: ctr(self.P, n) - v for n, v in self.base.items()}


def driver(P):
    return P.fab.FabTokenDriver(P.fab.FabTokenPublicParams())


def synth(P, drv, tx, qty, index=0, owner=OWNER, token_type="USD"):
    tid = P.token.ID(tx, index)
    out = P.token.Token(P.token.Owner(owner), token_type, hex(qty)).to_bytes()
    return P.store.decoded_token(drv.output_to_unspent, tid, out, None)


def mk_vault(P, store=None, drv=None):
    drv = drv or driver(P)
    return P.vault.Vault(drv, lambda ident: ident == OWNER, store=store), drv


def fill(P, vault, drv, quantities, tx_prefix="t", token_type="USD"):
    vault.store.apply(P.vault.VaultDelta("fill", stores=[
        synth(P, drv, f"{tx_prefix}{i}", q, token_type=token_type)
        for i, q in enumerate(quantities)]))


def keys(ids):
    return [i.key() for i in ids]


def recover(P, path, drv=None, **kw):
    return P.vault.Vault.recover(path, drv or driver(P), lambda ident: ident == OWNER, **kw)


def view(vault):
    return sorted((st.id.key(), st.output, st.metadata) for st in vault.store.tokens())


# ===================================================================
# Store and index
# ===================================================================


def test_bucket_orders_and_compacts_like_reference():
    def run(P):
        b = P.store._Bucket()
        seen = []
        for i, q in enumerate([5, 50, 1, 30, 7, 42, 9, 3, 11, 2]):
            b.add(f"k{i}", q)
        seen.append(list(b.merged()))
        snap = b.merged()
        b.add("k10", 100)
        assert b.merged() is not snap
        seen.append(list(b.merged()))
        b.discard("k10")
        b.discard("k1")
        seen.append((list(b.merged()), b._stale))
        for i in range(9):
            b.discard(f"k{i}")
        seen.append((len(b), list(b.merged())))
        return seen

    seen = both(run)
    assert [-nq for nq, _ in seen[0]] == sorted([5, 50, 1, 30, 7, 42, 9, 3, 11, 2], reverse=True)
    assert seen[1][0] == (-100, "k10")
    assert seen[2][0][0] == (-42, "k5") and seen[2][1] == 0  # the dead prefix trimmed
    assert seen[3] == (1, [(-2, "k9")])


def test_store_index_and_cert_drop_like_reference():
    def run(P):
        drv = driver(P)
        store = P.store.InMemoryTokenStore()
        store.apply(P.vault.VaultDelta("a", stores=[
            synth(P, drv, "a", 10), synth(P, drv, "b", 40),
            synth(P, drv, "c", 25, token_type="EUR")]))
        store.apply(P.vault.VaultDelta("", certs=[(P.token.ID("b", 0).key(), b"cert-b")]))
        out = [list(store.candidates("USD")), list(store.candidates("EUR")),
               list(store.candidates("JPY")), list(store.candidates("USD", OWNER)),
               list(store.candidates("USD", b"nobody")), store.certification("b.0")]
        stats = store.apply(P.vault.VaultDelta("spend", spends=["b.0"]))
        return out + [stats, store.certification("b.0"), store.cert_count(),
                      store.get("b.0"), len(store), [st.id.key() for st in store.tokens()]]

    out = both(run)
    assert [q for q, _ in out[0]] == [40, 10] and [q for q, _ in out[1]] == [25]
    assert out[2] == [] and out[3] == out[0] and out[4] == [] and out[5] == b"cert-b"
    assert out[6] == {"spent": 1, "stored": 0, "certs_dropped": 1}
    assert out[7:11] == [None, 0, None, 2]


def test_vault_on_finality_like_reference():
    """Issue, certify, spend (the certification dropped and counted), and
    an INVALID event that changes nothing: the same vault in both."""
    def run(P):
        req_mod, led = P.request, P.ledger
        ID = P.token.ID
        vault, drv = mk_vault(P)
        c = Counters(P, "vault.certs.dropped", "vault.tokens.stored", "vault.tokens.spent")
        outcome = drv.issue(OWNER, "USD", [10, 5], [OWNER, OWNER])
        req = req_mod.TokenRequest(anchor="issue")
        req.issues.append(req_mod.IssueRecord(
            action=outcome.action_bytes, issuer=OWNER, outputs_metadata=outcome.metadata,
            receivers=[OWNER, OWNER]))
        vault.on_finality(led.FinalityEvent("issue", led.TxStatus.VALID), req)
        seen = [vault.balance("USD"), keys(vault.token_ids()),
                vault.get_many([ID("issue", 0)])]
        vault.store_certification(ID("issue", 0), b"c0")
        seen.append(vault.certification(ID("issue", 0)))
        tout = drv.transfer([ID("issue", 0)], [outcome.outputs[0]], [outcome.metadata[0]],
                            "USD", [10], [OWNER])
        treq = req_mod.TokenRequest(anchor="spend")
        treq.transfers.append(req_mod.TransferRecord(
            action=tout.action_bytes, input_ids=[ID("issue", 0)], senders=[OWNER],
            outputs_metadata=tout.metadata, receivers=[OWNER]))
        vault.on_finality(led.FinalityEvent("spend", led.TxStatus.VALID), treq)
        seen += [vault.balance("USD"), vault.certification(ID("issue", 0)), keys(vault.token_ids())]
        vault.on_finality(led.FinalityEvent("spend2", led.TxStatus.INVALID), treq)
        seen += [vault.balance("USD"), [(t.id.key(), t.quantity) for t in vault.iter_unspent("USD")],
                 c()]
        return seen

    seen = both(run)
    assert seen[0] == 15 and seen[1] == ["issue.0", "issue.1"] and seen[3] == b"c0"
    assert seen[4] == 15 and seen[5] is None and seen[6] == ["issue.1", "spend.0"]
    assert seen[7] == 15
    assert seen[9] == {"vault.certs.dropped": 1, "vault.tokens.stored": 3,
                       "vault.tokens.spent": 1}


# ===================================================================
# Persistent store: journal, snapshot, recovery
# ===================================================================


def _journal_run(P, path, snapshot_every):
    drv = driver(P)
    store = P.store.PersistentTokenStore(path, snapshot_every=snapshot_every)
    vault, _ = mk_vault(P, store=store, drv=drv)
    fill(P, vault, drv, [10, 20, 30])
    vault.store_certification(P.token.ID("t2", 0), b"cert-30")
    store.apply(P.vault.VaultDelta("spend", spends=["t0.0"]))
    for i in range(3):
        store.apply(P.vault.VaultDelta(f"e{i}", stores=[synth(P, drv, f"e{i}", i + 1)]))
    store.close()


def _read(path):
    return open(path, "rb").read() if os.path.exists(path) else None


@pytest.mark.parametrize("snapshot_every", [0, 4])
def test_persistent_store_bytes_and_cross_recovery(tmp_path, snapshot_every):
    """The same deltas leave byte-identical journals and snapshots in both
    packages, and each package recovers the other's files to the same
    vault (tokens, balance, certifications), which keeps journaling."""
    paths = {root: str(tmp_path / f"{i}.wal") for i, root in enumerate(PKGS)}
    snaps0 = {root: ctr(P, "vault.snapshots") for root, P in PKGS.items()}
    for root, P in PKGS.items():
        _journal_run(P, paths[root], snapshot_every)
    assert _read(paths[PORT]) == _read(paths[REF])
    assert _read(paths[PORT] + ".snap") == _read(paths[REF] + ".snap")
    assert (_read(paths[PORT] + ".snap") is not None) == bool(snapshot_every)
    assert {r: ctr(P, "vault.snapshots") - snaps0[r] for r, P in PKGS.items()} == {
        REF: 1 if snapshot_every else 0, PORT: 1 if snapshot_every else 0}
    views = {}
    for reader, P in PKGS.items():
        for writer in PKGS:
            v = recover(P, paths[writer])
            views[reader, writer] = (view(v), v.balance("USD"),
                                     v.certification(P.token.ID("t2", 0)),
                                     v.certification(P.token.ID("t0", 0)))
            v.store.close()
    assert len(set(map(repr, views.values()))) == 1
    assert views[PORT, REF][1] == 56 and views[PORT, REF][2] == b"cert-30"
    assert views[PORT, REF][3] is None
    # the port keeps journaling to a file the reference wrote
    v = recover(S, paths[REF])
    v.store.apply(S.vault.VaultDelta("more", stores=[synth(S, driver(S), "t9", 9)]))
    v.store.close()
    back = recover(PKGS[REF], paths[REF])
    assert back.balance("USD") == 65
    back.store.close()


def test_vault_recover_truncates_torn_tail_like_reference(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.root}.wal")
        drv = driver(P)
        store = P.store.PersistentTokenStore(path, snapshot_every=0)
        vault, _ = mk_vault(P, store=store, drv=drv)
        fill(P, vault, drv, [7, 8])
        store.close()
        with open(path, "ab") as fh:
            fh.write(struct.pack(">II", 1 << 20, 0) + b"torn")
        c = Counters(P, "wal.torn_tails", "vault.recoveries", "vault.replayed.events")
        v2 = recover(P, path, drv)
        seen = [v2.balance("USD"), c(), os.path.getsize(path)]
        v2.store.apply(P.vault.VaultDelta("new", stores=[synth(P, drv, "n", 1)]))
        v2.store.close()
        v3 = recover(P, path, drv)
        seen += [v3.balance("USD"), view(v3)]
        v3.store.close()
        return seen

    seen = both(run)
    assert seen[0] == 15 and seen[3] == 16
    assert seen[1] == {"wal.torn_tails": 1, "vault.recoveries": 1, "vault.replayed.events": 1}


def test_vault_snapshot_compaction_and_idempotent_replay_like_reference(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.root}.wal")
        drv = driver(P)
        c = Counters(P, "vault.snapshots")
        store = P.store.PersistentTokenStore(path, snapshot_every=4)
        vault, _ = mk_vault(P, store=store, drv=drv)
        for i in range(6):
            store.apply(P.vault.VaultDelta(f"e{i}", stores=[synth(P, drv, f"t{i}", i + 1)]))
        store.apply(P.vault.VaultDelta("spend", spends=["t0.0"]))
        seen = [c(), os.path.exists(path + ".snap"), view(vault), vault.balance("USD")]
        store.close()
        v2 = recover(P, path, drv)
        seen += [view(v2), v2.balance("USD")]
        # a snapshot that covers the whole journal, the journal not reset:
        # the replay on top is idempotent
        with open(path + ".snap", "wb") as fh:
            fh.write(v2.store._snapshot_bytes())
        v2.store.close()
        v3 = recover(P, path, drv)
        seen += [view(v3), v3.balance("USD")]
        v3.store.close()
        return seen

    seen = both(run)
    assert seen[0] == {"vault.snapshots": 1} and seen[1]
    assert seen[2] == seen[4] == seen[6] and seen[3] == seen[5] == seen[7] == 20


def test_vault_append_failure_degrades_loudly(tmp_path):
    """An armed `vault.append` fault (the port's `utils.faults`): the
    append fails loudly, the in-memory view applies, and recovery shows
    exactly the durable set; the same in both packages."""
    def run(P):
        path = str(tmp_path / f"{P.root}.wal")
        drv = driver(P)
        store = P.store.PersistentTokenStore(path, snapshot_every=0)
        vault, _ = mk_vault(P, store=store, drv=drv)
        fill(P, vault, drv, [10])
        c = Counters(P, "vault.append_failures", "faults.injected.vault.append", "vault.appends")
        n0 = len(P.mx.FLIGHT)
        P.faults.arm("vault.append", "error", count=1)
        store.apply(P.vault.VaultDelta("lost", stores=[synth(P, drv, "lost", 5)]))
        events = [(e["kind"], e.get("tx")) for e in P.mx.FLIGHT.tail(len(P.mx.FLIGHT) - n0)]
        seen = [c(), vault.balance("USD"), ("vault.append_failed", "lost") in events]
        store.apply(P.vault.VaultDelta("kept", stores=[synth(P, drv, "kept", 3)]))
        store.close()
        v2 = recover(P, path, drv)
        seen += [v2.get(P.token.ID("lost", 0)), v2.get(P.token.ID("kept", 0)) is not None,
                 v2.balance("USD")]
        v2.store.close()
        return seen

    seen = both(run)
    assert seen[0] == {"vault.append_failures": 1, "faults.injected.vault.append": 1,
                       "vault.appends": 0}
    assert seen[1:] == [15, True, None, True, 13]


def test_vault_snapshot_and_recover_fault_sites(tmp_path):
    def run(P):
        path = str(tmp_path / f"{P.root}.wal")
        drv = driver(P)
        store = P.store.PersistentTokenStore(path, snapshot_every=2)
        vault, _ = mk_vault(P, store=store, drv=drv)
        c = Counters(P, "vault.snapshot_failures")
        P.faults.arm("vault.snapshot", "error", count=1)
        fill(P, vault, drv, [1])
        store.apply(P.vault.VaultDelta("x", stores=[synth(P, drv, "x", 2)]))
        seen = [c(), os.path.exists(path + ".snap"), vault.balance("USD")]
        store.close()
        P.faults.clear()
        P.faults.arm("vault.recover", "error", count=1)
        with pytest.raises(P.faults.FaultInjected):
            recover(P, path, drv)
        P.faults.clear()
        v2 = recover(P, path, drv)
        seen.append(v2.balance("USD"))
        v2.store.close()
        return seen

    assert both(run) == [{"vault.snapshot_failures": 1}, False, 3, 3]


def test_environment_knobs_are_not_ported(tmp_path, monkeypatch):
    """`FTS_VAULT_SNAPSHOT_EVERY`, `FTS_SELECTOR_SHARDS` and
    `FTS_SELECTOR_DEADLINE_S` are arguments in the port (256, 16, None);
    the reference reads the environment. The port's vault journal always
    fsyncs: neither the store nor `Vault.recover` takes the reference's
    `sync`, and `Vault.recover` takes no `snapshot_every`."""
    monkeypatch.setenv("FTS_VAULT_SNAPSHOT_EVERY", "3")
    monkeypatch.setenv("FTS_SELECTOR_SHARDS", "2")
    monkeypatch.setenv("FTS_SELECTOR_DEADLINE_S", "0.5")
    got = {}
    for root, P in PKGS.items():
        store = P.store.PersistentTokenStore(str(tmp_path / f"{root}.wal"))
        vault, _ = mk_vault(P, store=store)
        mgr = P.selector.SelectorManager(vault)
        got[root] = (store.snapshot_every, store._wal.sync, mgr.locker._n,
                     mgr.new_selector("t").deadline_s)
        store.close()
    assert got[PORT] == (256, True, 16, None)
    assert got[REF] == (3, True, 2, 0.5)
    params = {f.__qualname__: list(inspect.signature(f).parameters) for f in (
        S.store.PersistentTokenStore.__init__, S.store.PersistentTokenStore.recover,
        S.vault.Vault.recover)}
    assert params == {"PersistentTokenStore.__init__": ["self", "path", "snapshot_every"],
                      "PersistentTokenStore.recover": ["path", "decode"],
                      "Vault.recover": ["path", "driver", "owns_identity"]}


# ===================================================================
# Selector
# ===================================================================


def test_sharded_locker_like_reference():
    def run(P):
        lk = P.selector.ShardedLocker(shards=4)
        ids = [P.token.ID(f"s{i}", 0) for i in range(32)]
        seen = [all(lk.try_lock(i, "txA") for i in ids), lk.locked_count(),
                lk.try_lock(ids[0], "txB"), lk.holder(ids[0]), lk.is_locked(ids[5])]
        lk.unlock(ids[5])
        seen += [lk.is_locked(ids[5]), lk.try_lock(ids[5], "txB")]
        lk.unlock_by_tx("txA")
        seen += [lk.locked_count(), lk.holder(ids[5])]
        lk.unlock_by_tx("txB")
        return seen + [lk.locked_count()]

    assert both(run) == [True, 32, False, "txA", True, False, True, 1, "txB", 0]


def test_selector_walks_candidates_not_vault_like_reference():
    def run(P):
        scanned = []
        for n_tokens in (100, 10_000):
            vault, drv = mk_vault(P)
            vault.store.apply(P.vault.VaultDelta("fill", stores=[
                synth(P, drv, f"t{i}", 10) for i in range(n_tokens)]))
            mgr = P.selector.SelectorManager(vault)
            c = Counters(P, "selector.scanned")
            ids, total = mgr.new_selector("tx").select(30, "USD")
            scanned.append((keys(ids), total, c()["selector.scanned"]))
            mgr.unlock_by_tx("tx")
        return scanned

    scanned = both(run)
    assert [s[2] for s in scanned] == [3, 3] and scanned[0][1] == 30


def test_selector_order_and_type_isolation_like_reference():
    """Largest first, ties by key; a later tx skips what an earlier one
    holds; another type is never touched: the same picks in both."""
    def run(P):
        vault, drv = mk_vault(P)
        fill(P, vault, drv, [5, 100, 7, 100, 55, 55], tx_prefix="usd")
        fill(P, vault, drv, [1000], tx_prefix="eur", token_type="EUR")
        mgr = P.selector.SelectorManager(vault)
        picks = [mgr.new_selector("tx").select(90, "USD"),
                 mgr.new_selector("tx2").select(150, "USD"),
                 mgr.new_selector("tx3").select(60, "USD")]
        with pytest.raises(P.selector.InsufficientFunds) as e:
            mgr.new_selector("tx4").select(2000, "EUR")
        return [(keys(ids), total) for ids, total in picks] + [str(e.value)]

    got = both(run)
    assert got[:3] == [(["usd1.0"], 100), (["usd3.0", "usd4.0"], 155),
                       (["usd5.0", "usd2.0"], 62)]
    assert got[3] == "insufficient funds: need 2000 of [EUR]"


def test_selector_self_hold_semantics_like_reference():
    def run(P):
        vault, drv = mk_vault(P)
        fill(P, vault, drv, [100, 10, 10])
        mgr = P.selector.SelectorManager(vault)
        c = Counters(P, "selector.self_held", "selector.retry", "selector.insufficient_funds")
        ids, total = mgr.new_selector("T").select(100, "USD")
        ids2, total2 = mgr.new_selector("T").select(15, "USD")
        with pytest.raises(P.selector.InsufficientFunds):
            mgr.new_selector("T").select(5, "USD")
        seen = [keys(ids), total, sorted(keys(ids2)), total2, c()]
        mgr.unlock_by_tx("T")
        return seen + [mgr.locker.locked_count()]

    got = both(run)
    assert got[:4] == [["t0.0"], 100, ["t1.0", "t2.0"], 20]
    assert got[4] == {"selector.self_held": 4, "selector.retry": 0,
                      "selector.insufficient_funds": 1}
    assert got[5] == 0


def test_selector_deadline_budget():
    vault, drv = mk_vault(S)
    fill(S, vault, drv, [10])
    mgr = S.selector.SelectorManager(vault)
    assert mgr.new_selector("holder").select(10, "USD")[1] == 10
    c = Counters(S, "selector.timeout")
    t0 = time.monotonic()
    with pytest.raises(S.selector.SelectorTimeout):
        mgr.new_selector("waiter", retries=10**9, backoff_s=0.01, deadline_s=0.25).select(10, "USD")
    assert 0.25 <= time.monotonic() - t0 < 5.0
    assert c() == {"selector.timeout": 1}
    with pytest.raises(S.selector.SelectorTimeout):
        mgr.new_selector("w2", retries=2, backoff_s=0.001).select(10, "USD")
    mgr.unlock_by_tx("holder")
    assert mgr.locker.locked_count() == 0


def _contention(P, monkeypatch, release):
    """One tx holds both tokens; a second selector (3 retries) walks them.
    Its backoff sleeps are recorded, not slept, and `release` decides
    whether the first sleep unlocks the holder: a fixed schedule, the
    same in both packages, with no second thread."""
    vault, drv = mk_vault(P)
    fill(P, vault, drv, [5, 5])
    mgr = P.selector.SelectorManager(vault)
    held, total = mgr.new_selector("holder").select(10, "USD")
    sleeps = []

    def sleep(s):
        sleeps.append(round(s, 6))
        if release and len(sleeps) == 1:
            mgr.unlock_by_tx("holder")

    monkeypatch.setattr(P.selector_mod, "time",
                        SimpleNamespace(monotonic=time.monotonic, sleep=sleep))
    c = Counters(P, "selector.lock.busy", "selector.retry", "selector.timeout",
                 "selector.lock.acquired")
    waiter = mgr.new_selector("waiter", retries=3, backoff_s=0.01)
    try:
        ids, got = waiter.select(10, "USD")
        outcome = (keys(ids), got)
    except P.selector.SelectorTimeout as e:
        outcome = str(e)
    seen = [keys(held), outcome, sleeps, c(), mgr.locker.locked_count()]
    mgr.unlock_by_tx("waiter")
    mgr.unlock_by_tx("holder")
    return seen + [mgr.locker.locked_count(), vault.balance("USD")]


def test_selector_contention_fixed_schedule_times_out(monkeypatch):
    got = both(_contention, monkeypatch, False)
    assert got[1] == "token selection timed out: tokens busy for [USD]"
    assert got[2] == [0.01, 0.02]  # two backoffs, then the third pass gives up
    assert got[3] == {"selector.lock.busy": 6, "selector.retry": 2, "selector.timeout": 1,
                      "selector.lock.acquired": 0}
    assert got[4] == 2 and got[5:] == [0, 10]


def test_selector_contention_fixed_schedule_succeeds_after_unlock(monkeypatch):
    got = both(_contention, monkeypatch, True)
    assert got[1] == (["t0.0", "t1.0"], 10)
    assert got[2] == [0.01]
    assert got[3] == {"selector.lock.busy": 2, "selector.retry": 1, "selector.timeout": 0,
                      "selector.lock.acquired": 2}
    assert got[4] == 2 and got[5:] == [0, 10]


def test_selector_free_running_threads_keep_the_invariants():
    """Six spender threads race over 60 one-unit tokens: no token is held
    by two txs at once, nothing leaks, the vault is unchanged. Whether a
    given run meets contention depends on the scheduler, so it is not
    asserted here (the fixed schedules above pin it)."""
    vault, drv = mk_vault(S)
    fill(S, vault, drv, [1] * 60)
    mgr = S.selector.SelectorManager(vault)
    in_use, guard, errors = set(), threading.Lock(), []

    def spender(widx):
        try:
            for k in range(8):
                tx = f"s{widx}-{k}"
                ids, total = mgr.new_selector(tx, deadline_s=20.0, backoff_s=0.002).select(
                    15, "USD")
                assert total >= 15
                ks = set(keys(ids))
                with guard:
                    assert not in_use & ks, f"double-selected {in_use & ks}"
                    in_use.update(ks)
                time.sleep(0.001)
                with guard:
                    in_use.difference_update(ks)
                mgr.unlock_by_tx(tx)
                assert all(mgr.locker.holder(i) is None for i in ids)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=spender, args=(w,), daemon=True) for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert mgr.locker.locked_count() == 0
    assert vault.balance("USD") == 60


def test_selector_lock_fault_site():
    vault, drv = mk_vault(S)
    fill(S, vault, drv, [5])
    mgr = S.selector.SelectorManager(vault)
    c = Counters(S, "faults.injected.selector.lock")
    S.faults.arm("selector.lock", "delay", delay_s=0.01, count=2)
    ids, total = mgr.new_selector("tx").select(5, "USD")
    assert total == 5 and c()["faults.injected.selector.lock"] >= 1
    mgr.unlock_by_tx("tx")


# ===================================================================
# ttxdb
# ===================================================================


def _rows(db):
    conn = db._conn
    return ([r[:7] for r in conn.execute("SELECT * FROM transactions ORDER BY rowid")],
            list(conn.execute("SELECT * FROM movements ORDER BY rowid")))


def test_ttxdb_pk_upsert_index_wal_like_reference(tmp_path):
    def run(P):
        db = P.ttxdb.TransactionDB(str(tmp_path / f"{P.root}.db"))
        TxType, Dir = P.ttxdb.TxType, P.ttxdb.MovementDirection
        seen = [db._conn.execute("PRAGMA journal_mode").fetchone()[0]]
        db.add_transaction("tx1", TxType.TRANSFER, "alice", "bob", "USD", 7)
        db.set_status("tx1", "Confirmed")
        db.add_transaction("tx1", TxType.TRANSFER, "alice", "bob", "USD", 7)
        seen += [len(db.transactions()), db.status("tx1")]
        db.set_status("tx1", "Confirmed")
        plan = db._conn.execute(
            "EXPLAIN QUERY PLAN SELECT amount FROM movements WHERE "
            "wallet_eid=? AND direction=? AND status='Confirmed'", ("alice", "Sent")).fetchall()
        seen.append(any("mov_wallet_idx" in str(row) for row in plan))
        db.add_movement("tx1", "alice", "USD", 7, Dir.SENT, "Confirmed")
        db.add_movement("tx1", "bob", "USD", 7, Dir.RECEIVED, "Confirmed")
        db.add_movement("tx2", "bob", "USD", 2, Dir.SENT, "Pending")
        db.add_transaction("big", TxType.ISSUE, "i", "", "USD", 1 << 70)
        seen += [db.status("tx1"), db.payments("alice", "USD"), db.holdings("bob", "USD"),
                 db.holdings("bob"), db.payments("alice", "EUR"),
                 [r.amount for r in db.transactions()], _rows(db)]
        P.ttxdb.TransactionDB().add_transaction("m", TxType.ISSUE, "i", "", "USD", 1)
        return seen

    seen = both(run)
    assert seen[:4] == ["wal", 1, "Pending", True]
    assert seen[4:9] == ["Confirmed", 7, 7, 7, 0]
    assert seen[9] == [7, 1 << 70]


# ===================================================================
# A Party with the crash-safe vault, end to end
# ===================================================================


def test_party_persistent_vault_end_to_end_like_reference(tmp_path):
    """A `Party(vault_path=...)` runs an issue and a transfer over a
    fabtoken `Network` (the port's on the CPU), is rebuilt on the same
    path and gives back its tokens; both packages write the same journal
    bytes, and each recovers the other's."""
    import random

    def run(P):
        m = lambda name: importlib.import_module(f"{P.root}.{name}")  # noqa: E731
        rng = random.Random(5)
        pp = P.fab.FabTokenPublicParams()
        mk = lambda: P.fab.FabTokenDriver(pp)  # noqa: E731
        aw = m("api.wallet").AuditorWallet("auditor", m("crypto.sign").keygen(rng))
        kw = {"device": "cpu"} if P.root == PORT else {}
        net = m("services.network").Network(m("api.validator").RequestValidator(
            mk(), aw.identity), **kw)
        path = str(tmp_path / f"{P.root}-alice.wal")
        Party, Transaction = m("services.ttx").Party, m("services.ttx").Transaction
        issuer_p = Party("issuer-node", mk(), net, auditor_identity=aw.identity, rng=rng)
        alice_p = Party("alice-node", mk(), net, auditor_identity=aw.identity, rng=rng,
                        vault_path=path)
        issuer = issuer_p.new_issuer_wallet("issuer")
        pp.add_issuer(issuer.identity)
        alice = alice_p.new_owner_wallet("alice", anonymous=False)
        auditor = m("services.auditor").AuditorService(mk(), aw)
        tx = Transaction(issuer_p, "tx-issue")
        tx.issue("issuer", "USD", [10, 5], [alice.recipient_identity()] * 2, anonymous=False)
        tx.collect_endorsements(auditor)
        tx.submit()
        tx2 = Transaction(alice_p, "tx-self")
        tx2.transfer("alice", "USD", [12], [alice.recipient_identity()])
        tx2.collect_endorsements(auditor)
        tx2.submit()
        seen = [alice_p.balance("USD"), keys(alice_p.vault.token_ids())]
        alice_p.vault.store.close()
        again = Party("alice-node", mk(), net, auditor_identity=aw.identity, vault_path=path)
        seen += [again.balance("USD"), keys(again.vault.token_ids()), _read(path)]
        again.vault.store.close()
        return seen

    seen = both(run)
    assert seen[0] == seen[2] == 15
    assert seen[1] == seen[3] == ["tx-self.0", "tx-self.1"]
    for reader, P in PKGS.items():
        for writer in PKGS:
            v = P.vault.Vault.recover(str(tmp_path / f"{writer}-alice.wal"), driver(P),
                                      lambda ident: True)
            assert keys(v.token_ids()) == ["tx-self.0", "tx-self.1"]
            assert v.balance("USD") == 15
            v.store.close()
