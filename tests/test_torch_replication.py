"""PyTorch port, the replicated ledger plane: WAL shipping, fencing epochs,
promotion and client failover, against the JAX package.

Port mirrors of the 17 tests of `tests/test_replication.py:118-664` and
of its kill-the-leader soak (`slow`, `chaos`), on fabtoken ledgers on
the CPU. The reference's environment knobs are arguments here
(`lease_s`, `auto_promote`, the shipper's `ship_timeout_s`, `queue_max`
and `heartbeat_s`, the client's `endpoints=`), and `FTS_REPL=0` has no
counterpart: a node that wants no replication does not attach. Added:
the two packages replicate each other (a port follower bootstraps from
and streams a JAX leader, a JAX follower a port leader), with journals
and epoch files byte-identical to a single-package pair's, and one
scenario run in both packages gives equal journals, statuses and epoch
files. Waits poll conditions up to deadlines."""

import os
import select
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest
import torch

from torch_remote_cases import PORT, REF, Kit, counter, fab_net, journal, raw_rpc, wait

torch.set_num_threads(1)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
replication = PORT.services_network_replication
remote = PORT.services_network_remote
LedgerServer, RemoteNetwork, RemoteError = (
    remote.LedgerServer, remote.RemoteNetwork, remote.RemoteError)
WriteAheadLog = PORT.services_network_wal.WriteAheadLog
faults = PORT.utils_faults
VALID = PORT.services_network_ledger.TxStatus.VALID


def _counter(name):
    return counter(PORT, name)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.clear()


# ===================================================================
# replay_iter: the follower-tailing / recovery-streaming primitive
# ===================================================================


def test_replay_iter_stream_offsets_and_resume(tmp_path):
    wal = WriteAheadLog(tmp_path / "t.wal")
    payloads = [b"alpha", b"", b"\x00" * 512, b"tail"]
    for p in payloads:
        wal.append(p)
    got = list(wal.replay_iter())
    assert [p for _off, p in got] == payloads
    offsets = [off for off, _p in got]
    assert offsets == sorted(set(offsets))
    assert offsets[-1] == os.path.getsize(wal.path)
    for i, (off, _p) in enumerate(got):
        assert [p for _o, p in wal.replay_iter(off)] == payloads[i + 1:]
    assert wal.replay() == payloads
    wal.close()
    # the JAX package reads the same journal identically
    assert REF.services_network_wal.WriteAheadLog(tmp_path / "t.wal").replay() == payloads


def test_replay_iter_stale_scan_never_truncates_live_journal(tmp_path):
    wal = WriteAheadLog(tmp_path / "t.wal")
    wal.append(b"one")
    wal.append(b"two-a-longer-record")
    stale = wal.replay_iter()
    next(stale)
    wal.reset()
    wal.append(b"a")
    wal.append(b"b" * 64)
    torn_before = _counter("wal.torn_tails")
    list(stale)
    assert _counter("wal.torn_tails") == torn_before
    assert wal.replay() == [b"a", b"b" * 64]
    wal.close()


def test_replay_iter_truncates_torn_tail(tmp_path):
    path = tmp_path / "t.wal"
    wal = WriteAheadLog(path)
    wal.append(b"one")
    wal.append(b"two")
    good_size = os.path.getsize(path)
    before = _counter("wal.torn_tails")
    with open(path, "ab") as fh:
        fh.write(struct.pack(">II", 4096, 0xDEAD) + b"fragment")
    assert [p for _o, p in wal.replay_iter()] == [b"one", b"two"]
    assert _counter("wal.torn_tails") - before == 1
    assert os.path.getsize(path) == good_size
    wal.append(b"three")
    assert wal.replay() == [b"one", b"two", b"three"]
    wal.close()


# ===================================================================
# degrade-only: followerless replication is a no-op
# ===================================================================


def test_attach_is_degrade_only(tmp_path):
    kit = Kit(PORT)
    net = fab_net(PORT, tmp_path / "off.wal", kit.pp)
    # zero followers: nothing attaches (FTS_REPL=0 has no counterpart: a
    # node that wants no replication does not attach)
    assert replication.attach_leader(net, []) is None
    assert net.repl is None
    assert not hasattr(replication, "_enabled")
    req = kit.issue("solo-1")
    assert net.submit(req).status == VALID
    twin = fab_net(PORT, tmp_path / "twin.wal", kit.pp)
    assert twin.submit(req).status == VALID
    rec_a, rec_b = journal(PORT, tmp_path / "off.wal"), journal(PORT, tmp_path / "twin.wal")
    assert len(rec_a) == len(rec_b) == 1 and rec_a == rec_b
    # and the JAX ledger journals the same record for the same request
    ref_net = fab_net(REF, tmp_path / "ref.wal", Kit(REF).pp)
    assert ref_net.submit(req).status.value == "Valid"
    assert journal(REF, tmp_path / "ref.wal") == rec_a
    plain = PORT.services_network_ledger.Network(kit.validator(), device="cpu")
    with pytest.raises(replication.ReplicationError):
        replication.attach_leader(plain, [("127.0.0.1", 1)])
    with pytest.raises(replication.ReplicationError):
        replication.attach_follower(plain)
    state = replication.attach_follower(plain, epoch_path=str(tmp_path / "plain.epoch"))
    assert state is not None
    state.close()


def test_knobs_are_arguments_with_the_reference_defaults(tmp_path, monkeypatch):
    """The reference's FTS_REPL_* variables are read nowhere: setting them
    changes nothing, and the arguments default to the reference's
    defaults."""
    for name, value in (("FTS_REPL", "0"), ("FTS_REPL_LEASE_S", "0.01"),
                        ("FTS_REPL_SHIP_TIMEOUT_S", "0.01"), ("FTS_REPL_QUEUE_MAX", "1"),
                        ("FTS_REPL_HEARTBEAT_S", "0.01"), ("FTS_REPL_AUTO_PROMOTE", "1")):
        monkeypatch.setenv(name, value)
    net = fab_net(PORT, tmp_path / "f.wal")
    state = replication.attach_follower(net)
    try:
        assert state is not None and state.lease_s == replication.DEFAULT_LEASE_S == 3.0
        assert state._watchdog is None  # no auto-promotion unless asked
    finally:
        state.close()
    leader = fab_net(PORT, tmp_path / "l.wal")
    lstate = replication.attach_leader(leader, [("127.0.0.1", 1)])
    try:
        link = lstate.shipper._links[0]
        assert lstate.shipper.ship_timeout_s == replication.DEFAULT_SHIP_TIMEOUT_S == 5.0
        assert link._queue.maxsize == replication.DEFAULT_QUEUE_MAX == 128
        assert link.heartbeat_s == replication.DEFAULT_HEARTBEAT_S == 0.5
    finally:
        lstate.close()
    ref = REF.services_network_replication
    assert (ref.DEFAULT_LEASE_S, ref.DEFAULT_SHIP_TIMEOUT_S, ref.DEFAULT_QUEUE_MAX,
            ref.DEFAULT_HEARTBEAT_S) == (3.0, 5.0, 128, 0.5)


# ===================================================================
# shipping: catch-up, streaming, lag, promotion
# ===================================================================


def _ship_catchup(P, tmp_path):
    """The reference's catch-up scenario in package P: two commits before
    the follower exists, catch-up, one live delta, promotion over the
    wire, a submit on the promoted node. Returns the follower's journal,
    statuses and epoch file."""
    kit = Kit(P)
    wal_l, wal_f = tmp_path / f"{P.root}-leader.wal", tmp_path / f"{P.root}-follower.wal"
    leader_net = fab_net(P, wal_l, kit.pp)
    follower_net = fab_net(P, wal_f, kit.pp)
    rep = P.services_network_replication
    rem = P.services_network_remote
    for i in range(2):
        assert leader_net.submit(kit.issue(f"pre-{i}")).status.value == "Valid"
    follower_srv = rem.LedgerServer(network=follower_net).start()
    leader_srv = rem.LedgerServer(network=leader_net).start()
    applied_before = counter(P, "repl.applied.records")
    try:
        rep.attach_follower(follower_net)
        state = rep.attach_leader(leader_net, [follower_srv.address], heartbeat_s=0.1)
        assert state is not None and leader_net.repl is state
        wait(lambda: follower_net.height() == leader_net.height(), what="follower catch-up")
        assert leader_net.submit(kit.issue("live-0")).status.value == "Valid"
        wait(lambda: follower_net.height() == leader_net.height(), what="live delta")
        assert counter(P, "repl.applied.records") - applied_before == 3
        assert follower_net.status("pre-0").status.value == "Valid"
        assert follower_net.status("live-0").status.value == "Valid"
        lh = leader_srv.network.health()["repl"]
        assert lh["role"] == "leader" and lh["lag"] == 0
        assert lh["followers"][0]["state"] == "streaming"
        fh = follower_net.health()["repl"]
        assert fh["role"] == "follower" and fh["lag"] == 0
        assert fab_net(P, tmp_path / f"{P.root}-alone.wal", kit.pp).health()["repl"] is None
        health = leader_srv.network.health()
        client = rem.RemoteNetwork(follower_srv.address, timeout=5, retries=2, backoff_s=0.01)
        promotions_before = counter(P, "repl.promotions")
        assert client.promote() == 1
        assert client.promote() == 1  # idempotent on a leader
        assert counter(P, "repl.promotions") - promotions_before == 1
        epoch_file = str(wal_f) + ".epoch"
        assert rep._load_epoch(epoch_file) == 1
        assert client.submit(kit.issue("post-promo")).status.value == "Valid"
        client.close()
    finally:
        leader_srv.stop()
        follower_srv.stop()
    with open(epoch_file, "rb") as fh_:
        epoch_bytes = fh_.read()
    return journal(P, wal_f), [follower_net.status(t).status.value for t in
                               ("pre-0", "pre-1", "live-0", "post-promo")], epoch_bytes, health


def test_ship_catchup_health_and_promotion(tmp_path):
    port = _ship_catchup(PORT, tmp_path)
    ref = _ship_catchup(REF, tmp_path)
    # the same scenario in both packages: equal journals, statuses and
    # epoch files (b"1")
    assert port[:3] == ref[:3]
    assert port[2] == b"1"
    # the JAX package's `ftstop` renders the port node's repl column
    sys.path.insert(0, os.path.join(REPO_ROOT, "cmd"))
    try:
        import ftstop
    finally:
        sys.path.pop(0)
    row = ftstop.format_row(port[3], {"counters": {}, "gauges": {}, "histograms": {}},
                            None, None)
    assert "repl=leader@e0 lag=0" in row


def test_acked_commit_is_on_follower_before_submit_returns(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    try:
        replication.attach_follower(follower_net)
        replication.attach_leader(leader_net, [follower_srv.address])
        wait(lambda: leader_net.repl.shipper.link_states()[0]["state"] == "streaming",
             what="link streaming")
        for i in range(3):
            assert leader_net.submit(kit.issue(f"sync-{i}")).status == VALID
            # no wait: the acked block is already on the follower
            assert follower_net.height() == leader_net.height()
            assert follower_net.status(f"sync-{i}").status == VALID
    finally:
        follower_srv.stop()
        leader_net.repl.close()


def test_snapshot_bootstrap_for_compacted_leader(tmp_path):
    """A leader whose journal no longer covers history (snapshot_every=1)
    bootstraps a fresh follower by snapshot. The order of events is
    pinned: the link's catch-up runs once, on its first connection, after
    the three commits (heartbeat_s is long, so no second catch-up can
    race the first), and the wait is on the link reaching `streaming`."""
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp, snapshot_every=1)
    for i in range(3):
        assert leader_net.submit(kit.issue(f"c-{i}")).status == VALID
    assert WriteAheadLog(tmp_path / "leader.wal").replay() == []  # compacted
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    boots_before = _counter("repl.bootstraps")
    sent_before = _counter("repl.bootstraps.sent")
    try:
        replication.attach_follower(follower_net)
        state = replication.attach_leader(leader_net, [follower_srv.address], heartbeat_s=60.0)
        wait(lambda: state.shipper.link_states()[0]["state"] == "streaming",
             what="snapshot bootstrap")
        assert follower_net.height() == leader_net.height() == 3
        assert _counter("repl.bootstraps") - boots_before == 1
        assert _counter("repl.bootstraps.sent") - sent_before == 1
        assert follower_net.status("c-2").status == VALID
        assert follower_net.snapshot() == leader_net.snapshot()
    finally:
        follower_srv.stop()
        leader_net.repl.close()


# ===================================================================
# fencing: stale appends refused, zombies demoted — never merged
# ===================================================================


def test_fencing_rejects_stale_frames_and_demotes_zombies(tmp_path):
    kit = Kit(PORT)
    node_net = fab_net(PORT, tmp_path / "node.wal", kit.pp)
    node_srv = LedgerServer(network=node_net).start()
    try:
        state = replication.attach_follower(node_net)
        state.promote(reason="test")
        stale_before = _counter("repl.stale_rejected")
        resp = raw_rpc(node_srv.address, {"op": "repl.ship", "epoch": 0,
                                          "record": b"junk".hex()})
        assert resp["ok"] is False and resp["error_class"] == "StaleEpoch"
        assert resp["epoch"] == 1
        assert _counter("repl.stale_rejected") - stale_before == 1
        resp = raw_rpc(node_srv.address, {"op": "repl.ship", "epoch": 1,
                                          "record": b"junk".hex()})
        assert resp["ok"] is False and resp["error_class"] == "StaleEpoch"
        height_before = node_net.height()
        zombie_net = fab_net(PORT, tmp_path / "zombie.wal", kit.pp)
        assert zombie_net.submit(kit.issue("z-0")).status == VALID
        demotions_before = _counter("repl.demotions")
        zombie_state = replication.attach_leader(zombie_net, [node_srv.address])
        wait(lambda: zombie_state.role == "follower", what="zombie self-demotion")
        assert _counter("repl.demotions") - demotions_before == 1
        assert zombie_state.epoch >= 1
        wait(lambda: zombie_state.shipper.link_states()[0]["state"] == "fenced",
             what="the zombie's link fenced")
        assert node_net.height() == height_before
        assert node_net.status("z-0") is None
        zombie_state.close()
    finally:
        node_srv.stop()


def test_fenced_leader_adopts_fencers_actual_epoch(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    try:
        replication.attach_follower(follower_net)
        state = replication.attach_leader(leader_net, [follower_srv.address], heartbeat_s=60.0)
        wait(lambda: state.shipper.link_states()[0]["state"] == "streaming",
             what="link streaming")
        fstate = follower_net.repl
        for _ in range(4):
            fstate.promote(reason="cycle")
            fstate.demote(0, "cycle")
        fstate.promote(reason="final")
        assert fstate.epoch == 5
        assert leader_net.submit(kit.issue("fence")).status == VALID  # degrade-only
        wait(lambda: state.role == "follower", what="zombie demotion")
        assert state.epoch == 5
        with open(str(tmp_path / "leader.wal") + ".epoch", "rb") as fh:
            assert fh.read() == b"5"
    finally:
        follower_srv.stop()
        state.close()


def test_auto_promote_lease_watchdog(tmp_path):
    net = fab_net(PORT, tmp_path / "f.wal")
    promotions_before = _counter("repl.promotions")
    state = replication.attach_follower(net, auto_promote=True, lease_s=0.3)
    try:
        wait(lambda: state.role == "leader", timeout=5.0, what="lease-expiry auto-promotion")
        assert _counter("repl.promotions") - promotions_before == 1
        assert state.epoch == 1
        reborn = replication.attach_follower(net)
        assert reborn.epoch == 1
        reborn.close()
    finally:
        state.close()


# ===================================================================
# degrade-only under misbehaving followers
# ===================================================================


def test_hung_follower_never_stalls_commit(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    try:
        replication.attach_follower(follower_net)
        replication.attach_leader(leader_net, [follower_srv.address], ship_timeout_s=0.3)
        wait(lambda: leader_net.repl.shipper.link_states()[0]["state"] == "streaming",
             what="link streaming")
        timeouts_before = _counter("repl.ship.ack_timeouts")
        faults.arm("repl.ship", "hang", count=1, delay_s=5.0)
        t0 = time.monotonic()
        ev = leader_net.submit(kit.issue("hung-0"))
        wall = time.monotonic() - t0
        assert ev.status == VALID
        assert wall < 3.0, f"commit stalled {wall:.1f}s behind a hung link"
        assert _counter("repl.ship.ack_timeouts") - timeouts_before >= 1
        faults.clear()
        wait(lambda: follower_net.height() == leader_net.height(),
             what="post-hang convergence")
    finally:
        faults.clear()
        follower_srv.stop()
        leader_net.repl.close()


def test_dead_follower_never_stalls_commit(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead_addr = s.getsockname()
    state = replication.attach_leader(leader_net, [dead_addr], ship_timeout_s=0.3, queue_max=2)
    try:
        dropped_before = _counter("repl.ship.dropped")
        unsynced_before = _counter("repl.ship.unsynced")
        t0 = time.monotonic()
        for i in range(4):
            assert leader_net.submit(kit.issue(f"dead-{i}")).status == VALID
        wall = time.monotonic() - t0
        assert wall < 5.0, f"commits stalled {wall:.1f}s behind a dead link"
        assert _counter("repl.ship.dropped") - dropped_before >= 2
        assert _counter("repl.ship.unsynced") - unsynced_before >= 4
        assert state.shipper.link_states()[0]["state"] != "streaming"
    finally:
        state.close()


def test_node_stopped_follower_ends_link_cleanly(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    replication.attach_follower(follower_net)
    state = replication.attach_leader(leader_net, [follower_srv.address], heartbeat_s=0.05)
    try:
        wait(lambda: state.shipper.link_states()[0]["state"] == "streaming",
             what="link streaming")
        stopped_before = _counter("repl.link.node_stopped")
        follower_srv.stop()
        wait(lambda: state.shipper.link_states()[0]["state"] == "stopped",
             what="clean link stop")
        assert _counter("repl.link.node_stopped") - stopped_before == 1
        # the link thread has exited for good: no reconnect storm
        link = state.shipper._links[0]
        link._thread.join(timeout=5.0)
        assert not link._thread.is_alive()
        errors_before = _counter("repl.link.errors")
        assert leader_net.submit(kit.issue("after-stop")).status == VALID
        assert _counter("repl.link.errors") == errors_before
    finally:
        state.close()


# ===================================================================
# typed answers + client failover
# ===================================================================


def test_follower_submit_rejected_typed_not_leader(tmp_path):
    kit = Kit(PORT)
    follower_net = fab_net(PORT, tmp_path / "f.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    try:
        replication.attach_follower(follower_net)
        nl_before = _counter("remote.dispatch.not_leader")
        req = kit.issue("nope")
        resp = raw_rpc(follower_srv.address, {"op": "submit", "request": req.hex()})
        assert resp["ok"] is False and resp["error_class"] == "NotLeader"
        assert _counter("remote.dispatch.not_leader") == nl_before + 1
        client = RemoteNetwork(follower_srv.address, timeout=5, retries=1, backoff_s=0.01)
        with pytest.raises(RemoteError) as exc:
            client.submit(req)
        assert exc.value.error_class == "NotLeader"
        client.close()
        assert follower_net.status("nope") is None
    finally:
        follower_srv.stop()


def test_repl_ops_on_standalone_answer_typed(tmp_path):
    srv = LedgerServer(network=fab_net(PORT, tmp_path / "s.wal")).start()
    try:
        resp = raw_rpc(srv.address, {"op": "repl.ship", "epoch": 0, "record": b"x".hex()})
        assert resp["ok"] is False and resp["error_class"] == "ReplicationDisabled"
        resp = raw_rpc(srv.address, {"op": "promote"})
        assert resp["ok"] is False and resp["error_class"] == "ReplicationDisabled"
    finally:
        srv.stop()


def test_parse_endpoints_and_arguments(tmp_path, monkeypatch):
    """The client takes the cluster as `endpoints=` (order = initial
    preference), and FTS_REMOTE_ENDPOINTS is read nowhere."""
    srv = LedgerServer(network=fab_net(PORT, tmp_path / "s.wal")).start()
    try:
        host, port = srv.address
        client = RemoteNetwork(endpoints=[(host, port), (host, port + 1)],
                               timeout=5, retries=1, backoff_s=0.01)
        assert client.endpoints == [(host, port), (host, port + 1)]
        assert client.address == (host, port)
        assert client.height() == 0
        client.close()
        monkeypatch.setenv("FTS_REMOTE_ENDPOINTS", f"{host}:{port}")
        with pytest.raises(ValueError):
            RemoteNetwork()
    finally:
        srv.stop()


def test_client_failover_rides_exactly_once(tmp_path):
    kit = Kit(PORT)
    leader_net = fab_net(PORT, tmp_path / "leader.wal", kit.pp)
    follower_net = fab_net(PORT, tmp_path / "follower.wal", kit.pp)
    follower_srv = LedgerServer(network=follower_net).start()
    leader_srv = LedgerServer(network=leader_net).start()
    replication.attach_follower(follower_net)
    replication.attach_leader(leader_net, [follower_srv.address])
    client = RemoteNetwork(endpoints=[leader_srv.address, follower_srv.address],
                           timeout=5, retries=8, backoff_s=0.05)
    try:
        assert client.submit(kit.issue("pre-kill")).status == VALID
        wait(lambda: follower_net.height() == leader_net.height(),
             what="replication of the acked tx")
        switches_before = _counter("remote.failover.switches")
        leader_srv.stop()
        follower_net.repl.promote(reason="test failover")
        assert client.submit(kit.issue("post-kill")).status == VALID
        assert _counter("remote.failover.switches") - switches_before >= 1
        assert client.address == follower_srv.address
        assert client.status("pre-kill").status == VALID
        assert client.status("post-kill").status == VALID
        assert follower_net.height() == 2
    finally:
        client.close()
        follower_srv.stop()


# ===================================================================
# the two packages replicate each other
# ===================================================================


@pytest.mark.parametrize("leader_pkg,follower_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["jax-leader-port-follower", "port-leader-jax-follower"])
def test_cross_package_replication(tmp_path, leader_pkg, follower_pkg):
    """A follower of one package bootstraps from a compacted leader of the
    other (`repl.bootstrap`), streams its live records (`repl.ship`),
    fences its zombie frames and is promoted over the wire by a client of
    the leader's package; its journal and epoch file are byte-identical
    to those of a follower of the leader's own package fed the same
    frames."""
    kit = Kit(leader_pkg)
    leader_net = fab_net(leader_pkg, tmp_path / "leader.wal", kit.pp, snapshot_every=2)
    for i in range(3):  # heights 1-2 compacted into the snapshot, 3 journaled
        assert leader_net.submit(kit.issue(f"x-{i}")).status.value == "Valid"
    followers = {}
    for P in (follower_pkg, leader_pkg):  # the cross pair, then the twin
        net = fab_net(P, tmp_path / f"{P.root}.wal", Kit(P).pp)
        srv = P.services_network_remote.LedgerServer(network=net).start()
        P.services_network_replication.attach_follower(net)
        followers[P.root] = (net, srv)
    rep = leader_pkg.services_network_replication
    state = rep.attach_leader(leader_net, [srv.address for _n, srv in followers.values()],
                              heartbeat_s=0.1)
    try:
        wait(lambda: all(net.height() == 3 for net, _s in followers.values()),
             what="bootstrap and catch-up")
        boots = counter(follower_pkg, "repl.bootstraps")
        assert boots >= 1
        assert leader_net.submit(kit.issue("live")).status.value == "Valid"
        wait(lambda: all(net.height() == 4 for net, _s in followers.values()),
             what="the live record")
        cross, twin = followers[follower_pkg.root][0], followers[leader_pkg.root][0]
        for t in ("x-0", "x-2", "live"):
            assert cross.status(t).status.value == twin.status(t).status.value == "Valid"
        assert journal(follower_pkg, tmp_path / f"{follower_pkg.root}.wal") == journal(
            leader_pkg, tmp_path / f"{leader_pkg.root}.wal")
        # promote the cross follower over the wire with a client of the
        # leader's package; its epoch file is the reference's bytes
        addr = followers[follower_pkg.root][1].address
        client = leader_pkg.services_network_remote.RemoteNetwork(addr, timeout=5, retries=2,
                                                                  backoff_s=0.01)
        assert client.promote() == 1
        client.close()
        with open(str(tmp_path / f"{follower_pkg.root}.wal") + ".epoch", "rb") as fh:
            assert fh.read() == b"1"
        # the old leader is fenced off by the promoted cross follower
        wait(lambda: state.role == "follower", what="the leader fenced")
        assert state.epoch == 1
        with open(str(tmp_path / "leader.wal") + ".epoch", "rb") as fh:
            assert fh.read() == b"1"
        resp = raw_rpc(addr, {"op": "repl.ship", "epoch": 0, "record": b"zombie".hex()})
        assert resp["ok"] is False and resp["error_class"] == "StaleEpoch"
    finally:
        state.close()
        for _net, srv in followers.values():
            srv.stop()


# ===================================================================
# the kill-the-leader chaos soak (slow)
# ===================================================================

_REPL_CHILD = """
import os, sys, threading
sys.path.insert(0, sys.argv[4])
import torch
torch.set_num_threads(1)
from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
from fabric_token_sdk_tpu_torch.drivers.fabtoken import FabTokenDriver, FabTokenPublicParams
from fabric_token_sdk_tpu_torch.services.network import LedgerServer, Network, replication

wal_path, role, peer = sys.argv[1], sys.argv[2], sys.argv[3]
validator = RequestValidator(FabTokenDriver(FabTokenPublicParams()))
net = Network(validator, wal_path=wal_path, device="cpu")
server = LedgerServer(network=net).start()
if role == "follower":
    replication.attach_follower(net)
elif role == "leader":
    host, _, port = peer.rpartition(":")
    replication.attach_leader(net, [(host, int(port))])
print("READY", server.address[1], flush=True)
threading.Event().wait()
"""


def _spawn_repl_node(wal_path, role, peer="-"):
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPL_CHILD, str(wal_path), role, peer, REPO_ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, FTS_BLOCK_BATCHED="0"))
    deadline = time.time() + 60
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"repl child died rc={proc.returncode}:\n{proc.stderr.read()}")
        ready, _, _ = select.select([proc.stdout], [], [], 0.2)
        if ready:
            line = proc.stdout.readline()
            assert line.startswith("READY"), f"unexpected child output {line!r}"
            return proc, int(line.split()[1])
    proc.kill()
    raise AssertionError("repl child never became ready")


@pytest.mark.slow
@pytest.mark.chaos
def test_kill_the_leader_chaos_soak(tmp_path):
    kit = Kit(PORT, seed=0xC0FFEE)
    follower_wal, leader_wal = str(tmp_path / "follower.wal"), str(tmp_path / "leader.wal")
    follower, fport = _spawn_repl_node(follower_wal, "follower")
    leader, lport = _spawn_repl_node(leader_wal, "leader", f"127.0.0.1:{fport}")
    follower_addr = ("127.0.0.1", fport)
    client = RemoteNetwork(endpoints=[("127.0.0.1", lport), follower_addr],
                           timeout=5, retries=12, backoff_s=0.05)
    acked, ack_times, errors = [], [], []
    stop = threading.Event()

    def workload():
        k = 0
        while not stop.is_set():
            anchor = f"chaos-{k}"
            k += 1
            try:
                ev = client.submit(kit.issue(anchor))
            except Exception as e:  # unacked: allowed to be lost
                errors.append(e)
                continue
            if ev.status != VALID:
                errors.append(AssertionError(f"rejected: {ev.message}"))
                stop.set()
                return
            acked.append(anchor)
            ack_times.append(time.monotonic())

    t = threading.Thread(target=workload, daemon=True)
    try:
        t.start()
        wait(lambda: len(acked) >= 3, timeout=60, what="pre-kill acknowledged traffic")
        killed_at = time.monotonic()
        os.kill(leader.pid, signal.SIGKILL)
        leader.wait(timeout=30)
        promoter = RemoteNetwork(follower_addr, timeout=5, retries=5, backoff_s=0.1)
        assert promoter.promote() >= 1
        pre_kill_acks = len(acked)
        wait(lambda: len(acked) >= pre_kill_acks + 3, timeout=90,
             what="post-failover acknowledged traffic")
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        fatal = [e for e in errors if isinstance(e, AssertionError)]
        assert not fatal, fatal[0]
        post = [ts for ts in ack_times if ts > killed_at]
        assert post and post[0] - killed_at < 60.0
        for anchor in acked:
            ev = promoter.status(anchor)
            assert ev is not None and ev.status == VALID, anchor
        resp = raw_rpc(follower_addr, {"op": "repl.ship", "epoch": 0,
                                       "record": b"zombie".hex()})
        assert resp["ok"] is False and resp["error_class"] == "StaleEpoch"
        assert promoter.ops_metrics()["counters"].get("repl.stale_rejected", 0) >= 1
        promoter.close()
    finally:
        stop.set()
        client.close()
        for proc in (leader, follower):
            if proc.poll() is None:
                proc.kill()
        follower.wait(timeout=30)
    recovered = PORT.services_network_ledger.Network.recover(kit.validator(), follower_wal,
                                                             device="cpu")
    seen = {}
    for block in recovered._blocks:
        for txid in block.txs:
            seen[txid] = seen.get(txid, 0) + 1
    assert not {t: n for t, n in seen.items() if n > 1}
    for anchor in acked:
        assert recovered.status(anchor).status == VALID, anchor
