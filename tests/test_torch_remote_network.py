"""PyTorch port, the remote ledger node and its client, against the JAX
package.

Port mirrors of `tests/test_remote_network.py` (remote parties across
the wire, snapshot restore) and of the remote cases of
`tests/test_recovery.py:409-549` (retries through dropped connections,
exactly-once submit across a dropped answer, typed dispatch errors, the
frame cap, listener crash isolation, a server restarted on its port from
a snapshot), on fabtoken ledgers on the CPU (`device="cpu"`, passed
explicitly: a server's device defaults to the card). The flows that run
in both packages from one seed give equal statuses, heights, balances
and ledgers. Added: a `DevicePlaneError` of a port server's card-rule
plane reaches the remote client typed, unretried, with nothing
committed; the wire both ways (a port client against a JAX server, a
JAX client against a port server); the server's default device; the
reference's `FTS_REMOTE_*` knobs as arguments and constants."""

import dataclasses
import functools
import importlib
import random
import socket

import pytest
import torch

from torch_network_cases import build_both, network, policy
from torch_network_cases import PORT as NPORT, REF as NREF
from torch_remote_cases import PORT, REF, Kit, counter, fab_net

torch.set_num_threads(1)

remote = PORT.services_network_remote
LedgerServer, RemoteNetwork, RemoteError = (
    remote.LedgerServer, remote.RemoteNetwork, remote.RemoteError)
faults = PORT.utils_faults
VALID, INVALID = "Valid", "Invalid"


def mod(P, name):
    return importlib.import_module(f"{P.root}.{name}")


def _counter(name):
    return counter(PORT, name)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.clear()
    NPORT.utils_resilience.reset()


def _server(P, validator, **kw):
    """Package P's server over a fresh ledger (the port's on the CPU)."""
    if P is PORT:
        kw.setdefault("device", "cpu")
    return P.services_network_remote.LedgerServer(validator, **kw).start()


# ------------------------------------------------------------ tests/test_remote_network.py


def _remote_flow(P):
    """The reference's remote ledger flow in package P from one seed:
    issuer, alice and bob each on their own client of one server; issue,
    transfer, a replayed double spend, a spent-token resolve."""
    rng = random.Random(0xA11CE)
    pp = P.drivers_fabtoken.FabTokenPublicParams()
    aw = mod(P, "api.wallet").AuditorWallet("auditor", P.crypto_sign.keygen(rng))
    aw.sign = functools.partial(type(aw).sign, aw, rng=rng)
    auditor = mod(P, "services.auditor").AuditorService(P.drivers_fabtoken.FabTokenDriver(pp), aw)
    server = _server(P, P.api_validator.RequestValidator(P.drivers_fabtoken.FabTokenDriver(pp),
                                                         aw.identity))
    ttx = mod(P, "services.ttx")
    out = {}
    try:
        nets = [P.services_network_remote.RemoteNetwork(server.address) for _ in range(3)]
        issuer_p, alice_p, bob_p = (
            ttx.Party(name, P.drivers_fabtoken.FabTokenDriver(pp), net, aw.identity, rng=rng)
            for name, net in zip(("issuer", "alice", "bob"), nets))
        iw = issuer_p.new_issuer_wallet("issuer")
        pp.add_issuer(iw.identity)
        alice = alice_p.new_owner_wallet("alice", False)
        bob = bob_p.new_owner_wallet("bob", False)
        tx = ttx.Transaction(issuer_p, "mint")
        tx.issue("issuer", "USD", [9], [alice.recipient_identity()], anonymous=False)
        tx.collect_endorsements(auditor)
        tx.submit()
        nets[1].apply_finality(tx.request.to_bytes())
        out["after_issue"] = (alice_p.balance("USD"), nets[1].height(), nets[2].height())
        tx2 = ttx.Transaction(alice_p, "pay")
        tx2.transfer("alice", "USD", [4], [bob.recipient_identity()])
        tx2.collect_endorsements(auditor)
        tx2.submit()
        nets[2].apply_finality(tx2.request.to_bytes())
        out["after_pay"] = (bob_p.balance("USD"), alice_p.balance("USD"))
        replay = dataclasses.replace(tx2.request, anchor="replay")
        auditor.audit(replay)
        ev = nets[1].submit(replay.to_bytes())
        out["replay"] = (ev.status.value, ev.message)
        with pytest.raises(mod(P, "api.driver").ValidationError):
            nets[2].resolve_input(mod(P, "models.token").ID("mint", 0))
        out["requests"] = [tx.request.to_bytes(), tx2.request.to_bytes(), replay.to_bytes()]
        out["snapshot"] = NPORT.crypto_serialization.loads(server.network.snapshot())
        for b in out["snapshot"]["blocks"]:
            b[2] = 0  # block timestamps differ
    finally:
        server.stop()
    return out


def test_remote_ledger_flow():
    port, ref = _remote_flow(PORT), _remote_flow(REF)
    assert port["after_issue"] == (9, 1, 1)
    assert port["after_pay"] == (4, 5)
    assert port["replay"][0] == INVALID
    assert port == ref  # same requests, statuses, balances and ledger


def test_ledger_snapshot_restore():
    kit = Kit(PORT)
    net = fab_net(PORT, pp=kit.pp)
    assert net.submit(kit.issue("mint")).status.value == VALID
    snap = net.snapshot()
    net2 = PORT.services_network_ledger.Network.restore(kit.validator(), snap, device="cpu")
    ID = mod(PORT, "models.token").ID
    assert net2.height() == 1
    assert net2.exists(ID("mint", 0))
    assert net2.status("mint").status.value == VALID
    assert net2.resolve_input(ID("mint", 0)) == net.resolve_input(ID("mint", 0))
    # the JAX package restores the port's snapshot to the same answers
    ref_kit = Kit(REF)
    ref = REF.services_network_ledger.Network.restore(ref_kit.validator(), snap)
    assert ref.height() == 1 and ref.snapshot() == snap


# ------------------------------------------------------------ tests/test_recovery.py:409-549


def _remote_env(**client_kw):
    kit = Kit(PORT)
    server = _server(PORT, kit.validator())
    client_kw.setdefault("timeout", 10)
    client_kw.setdefault("backoff_s", 0.01)
    return kit, server, RemoteNetwork(server.address, **client_kw)


def test_remote_retry_through_connection_drops():
    kit, server, client = _remote_env()
    try:
        faults.arm("remote.send", "drop", count=2)
        before = _counter("remote.retry.attempts")
        assert client.height() == 0
        assert _counter("remote.retry.attempts") - before == 2
        faults.arm("remote.send", "drop")  # unlimited
        ex_before = _counter("remote.retry.exhausted")
        with pytest.raises(ConnectionError):
            client.height()
        assert _counter("remote.retry.exhausted") - ex_before == 1
    finally:
        faults.clear()
        server.stop()


def test_remote_submit_exactly_once_across_recv_drop():
    """The connection drops after the server commits and before the
    client reads the answer: the client adopts the verdict by status()
    and the tx commits exactly once, as in a run without the fault."""
    kit0, server0, client0 = _remote_env()
    try:
        blocks_before = _counter("ledger.blocks.committed")
        assert client0.submit(kit0.issue("mint")).status.value == VALID
        expected_blocks = _counter("ledger.blocks.committed") - blocks_before
        expected = server0.network.snapshot()
    finally:
        server0.stop()
    assert expected_blocks == 1

    kit1, server1, client1 = _remote_env(backoff_s=0.1)
    try:
        blocks_before = _counter("ledger.blocks.committed")
        recovered_before = _counter("remote.submit.recovered")
        assert faults.load_env("remote.recv:drop:1.0:1") == 1
        ev = client1.submit(kit1.issue("mint"))
        assert ev.status.value == VALID and ev.tx_id == "mint"
        assert _counter("ledger.blocks.committed") - blocks_before == expected_blocks
        assert _counter("remote.submit.recovered") - recovered_before == 1
        assert client1.status("mint").status.value == VALID
        got = server1.network.snapshot()
    finally:
        faults.clear()
        server1.stop()
    view = lambda raw: {k: v for k, v in NPORT.crypto_serialization.loads(raw).items()  # noqa: E731
                        if k != "blocks"}
    assert view(got) == view(expected)


def test_remote_dispatch_errors_are_typed():
    kit, server, client = _remote_env()
    try:
        before = _counter("remote.dispatch.errors.resolve")
        with pytest.raises(RemoteError) as ei:
            client._call({"op": "resolve", "tx_id": "x"})  # no "index"
        assert ei.value.error_class == "KeyError" and "index" in str(ei.value)
        assert _counter("remote.dispatch.errors.resolve") - before == 1
        with pytest.raises(RemoteError) as ei:
            client._call({"op": "frobnicate"})
        assert ei.value.error_class == "UnknownOp"
        assert client.height() == 0
    finally:
        server.stop()


def test_remote_frame_cap_client_and_server():
    a, b = socket.socketpair()
    try:
        a.sendall((99 * 1024 * 1024).to_bytes(4, "big"))
        with pytest.raises(remote.FrameTooLarge):
            remote._recv_msg(b)
    finally:
        a.close()
        b.close()
    kit, server, client = _remote_env()
    try:
        before = _counter("remote.frames.rejected")
        s = socket.create_connection(server.address, timeout=10)
        # a server's cap holds a shipped block at its ledger's max_block_txs
        assert server.max_frame == remote.server_max_frame(server.network.policy) == 64 << 20
        s.sendall((96 * 1024 * 1024).to_bytes(4, "big") + b"xx")
        resp = remote._recv_msg(s)
        assert resp == {"ok": False, "error": "frame of 100663296 bytes exceeds cap of 67108864",
                        "error_class": "FrameTooLarge"}
        assert s.recv(1) == b""
        s.close()
        assert _counter("remote.frames.rejected") - before == 1
        assert client.height() == 0
    finally:
        server.stop()
    # the cap is the server's `max_frame` (the reference's
    # FTS_REMOTE_MAX_FRAME): the reference's 16 MiB, or 1 MiB a tx of a
    # block where that is more
    assert remote.DEFAULT_MAX_FRAME == 16 * 1024 * 1024
    block_policy = mod(PORT, "services.network.orderer").BlockPolicy
    assert remote.server_max_frame(block_policy(max_block_txs=8)) == 16 << 20
    assert remote.server_max_frame(block_policy(max_block_txs=100)) == 100 << 20
    kit = Kit(PORT)
    server = _server(PORT, kit.validator(), max_frame=1024)
    try:
        assert server.max_frame == 1024
        s = socket.create_connection(server.address, timeout=10)
        s.sendall((2048).to_bytes(4, "big") + b"x" * 2048)
        resp = remote._recv_msg(s)
        assert resp["error_class"] == "FrameTooLarge" and "cap of 1024" in resp["error"]
        s.close()
        big = RemoteNetwork(server.address, timeout=10)
        with pytest.raises(RemoteError) as ei:  # an ~8 KB issue frame is over the cap
            big._call({"op": "submit", "request": kit.issue("m").hex()})
        assert ei.value.error_class == "FrameTooLarge"
        big.close()
    finally:
        server.stop()


def test_remote_listener_crash_isolation():
    kit, server, client = _remote_env()
    try:
        seen = []

        def boom(event, request):
            raise RuntimeError("listener crashed")

        client.subscribe(boom)
        client.subscribe(lambda e, r: seen.append(e.tx_id))
        before = _counter("remote.listener.errors")
        raw = kit.issue("mint")
        assert client.submit(raw).status.value == VALID
        assert _counter("remote.listener.errors") - before == 1
        assert "mint" in seen
        assert client.apply_finality(raw).status.value == VALID
        assert _counter("remote.listener.errors") - before == 2
    finally:
        server.stop()


def test_remote_snapshot_restore_server_restart():
    kit, server, client = _remote_env()
    port = server.address[1]
    ID = mod(PORT, "models.token").ID
    try:
        client.submit(kit.issue("mint", value=7))
        height = client.height()
        assert height == 1 and client.exists(ID("mint", 0))
        snap = server.network.snapshot()
        server.stop()
        server = LedgerServer(network=PORT.services_network_ledger.Network.restore(
            kit.validator(), snap, device="cpu"), port=port).start()
        connects_before = _counter("remote.connects")
        assert client.height() == height
        assert _counter("remote.connects") - connects_before >= 1
        assert client.status("mint").status.value == VALID
        assert client.exists(ID("mint", 0))
        assert client.resolve_input(ID("mint", 0)) == server.network.resolve_input(ID("mint", 0))
    finally:
        server.stop()


# ------------------------------------------------------------ added: the card's failure rule


def test_device_plane_error_reaches_the_remote_client_typed(monkeypatch):
    """A port server whose sign plane reads the card (as
    `tests/test_torch_device_failure.py` makes it here) fails a block
    whose launch raises: the remote caller gets `RemoteError` with
    `error_class="DevicePlaneError"`, for `submit_many` and for
    `submit` alike, with no retry, no failover probe and nothing of the
    block committed. Once the plane serves again the same requests
    commit with the JAX ledger's statuses."""
    def chain(e):
        return [e.issue("seed", [9])] + [
            e.transfer(f"t{k}", [("seed" if k == 0 else f"t{k - 1}", 0)], [9], to="alice")
            for k in range(2)]

    envs, raws = build_both("fabtoken", chain)
    net = network(NPORT, envs[NPORT.root], policy=policy(NPORT, max_block_txs=16,
                                                           sign_min_batch=1))
    assert net.submit(raws[0]).status.value == VALID  # on the CPU: sign auto is off
    pipe = net._pipeline
    monkeypatch.setattr(pipe, "device", torch.device("cuda"))
    monkeypatch.setattr(pipe, "_load_kernels", lambda: None)
    assert pipe.sign_enabled()
    pipe._sign_verifier = mod(PORT, "crypto.batch_sign").BatchedSchnorrVerifier(device="cpu")
    server = LedgerServer(network=net).start()
    client = RemoteNetwork(server.address, timeout=10, retries=3, backoff_s=0.01)
    try:
        assert client.height() == 1  # connected
        faults.arm("batch.sign", "error", count=2)
        retries0, connects0 = _counter("remote.retry.attempts"), _counter("remote.connects")
        fallbacks0 = _counter("batch.sign.host_fallbacks")
        with pytest.raises(RemoteError) as ei:
            client.submit_many(raws[1:])
        assert ei.value.error_class == "DevicePlaneError"
        with pytest.raises(RemoteError) as ei:
            client.submit(raws[1])
        assert ei.value.error_class == "DevicePlaneError"
        assert not RemoteNetwork._failover_error(ei.value)
        assert _counter("remote.retry.attempts") == retries0  # not retried
        assert _counter("remote.connects") == connects0  # the same connection
        assert client.height() == 1
        assert client.status("t0") is None and client.status("t1") is None
        assert _counter("batch.sign.host_fallbacks") == fallbacks0  # no host re-verification
        # the plane serves again: the same requests commit
        faults.clear()
        NPORT.utils_resilience.reset()
        got = [(e.tx_id, e.status.value, e.message) for e in client.submit_many(raws[1:])]
    finally:
        client.close()
        server.stop()
    ref = network(NREF, envs[NREF.root], policy=policy(NREF, max_block_txs=16))
    ref.submit(raws[0])
    assert got == [(e.tx_id, e.status.value, e.message) for e in ref.submit_many(raws[1:])]
    assert [s for _, s, _ in got] == [VALID, VALID]


# ------------------------------------------------------------ added: the wire both ways


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-jax-server", "jax-client-port-server"])
def test_wire_both_ways(client_pkg, server_pkg):
    """A client of one package against a server of the other gives the
    statuses, heights and answers the same-package pair gives for the
    same request bytes: submit, submit_many, status, exists, resolve,
    height and the ops RPCs."""
    ID = mod(PORT, "models.token").ID

    def run(C, S):
        kit = Kit(S)
        server = _server(S, kit.validator())
        client = C.services_network_remote.RemoteNetwork(server.address, timeout=10)
        try:
            raws = [kit.issue(f"w-{i}", value=i + 1) for i in range(4)]
            ev = client.submit(raws[0])
            evs = client.submit_many(raws[1:] + [raws[0]])  # a replay too
            out = {
                "events": [(ev.tx_id, ev.status.value, ev.message)] + [
                    (e.tx_id, e.status.value, e.message) for e in evs],
                "height": client.height(),
                "status": client.status("w-2").status.value,
                "missing": client.status("nope"),
                "exists": client.exists(mod(C, "models.token").ID("w-3", 0)),
                "resolve": client.resolve_input(mod(C, "models.token").ID("w-1", 0)),
            }
            health = client.ops_health()
            out["health"] = (health["height"], health["txs_final"], health["repl"])
            snap = client.ops_metrics()
            assert snap["counters"]["ledger.blocks.committed"] >= 2
            assert client.ops_flight(4)
        finally:
            client.close()
            server.stop()
        return out

    cross = run(client_pkg, server_pkg)
    same = run(server_pkg, server_pkg)
    assert cross == same
    assert [s for _t, s, _m in cross["events"]] == [VALID] * 4 + [VALID]
    assert cross["height"] == 2 and ID("w-3", 0) is not None


# ------------------------------------------------------------ added: device and knobs


def test_server_device_defaults_to_the_card(monkeypatch):
    """`LedgerServer(validator)` with no device builds its ledger with
    `device=None`, the card: it raises where there is no CUDA;
    `device="cpu"` runs the plain versions; a `network=` keeps its own
    device."""
    kit = Kit(PORT)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LedgerServer(kit.validator())
    made = []

    def recording(validator, **kw):  # the ledger the server builds, on the CPU
        made.append(kw)
        return PORT.services_network_ledger.Network(validator, **dict(kw, device="cpu"))

    monkeypatch.setattr(remote, "Network", recording)
    LedgerServer(kit.validator(), wal_path=None).start().stop()
    assert made == [{"policy": None, "wal_path": None, "device": None}]
    monkeypatch.undo()
    srv = LedgerServer(kit.validator(), device="cpu").start()
    try:
        assert srv.network.device.type == "cpu"
    finally:
        srv.stop()
    net = fab_net(PORT, pp=kit.pp)
    srv = LedgerServer(network=net, device="cuda").start()  # ignored: the network's own
    try:
        assert srv.network is net and net.device.type == "cpu"
    finally:
        srv.stop()


def test_knobs_are_arguments_with_the_reference_defaults(monkeypatch):
    """The reference's FTS_REMOTE_* and FTS_OPS_FLIGHT_N variables are read
    nowhere: the client's arguments and the module constants keep the
    reference's defaults."""
    for name, value in (("FTS_REMOTE_TIMEOUT_S", "1"), ("FTS_REMOTE_RETRIES", "0"),
                        ("FTS_REMOTE_BACKOFF_S", "9"), ("FTS_REMOTE_MAX_FRAME", "8"),
                        ("FTS_OPS_FLIGHT_N", "1")):
        monkeypatch.setenv(name, value)
    kit, server, client = _remote_env()
    try:
        fresh = RemoteNetwork(server.address)
        assert (fresh.timeout, fresh.retries, fresh.backoff_s) == (30.0, 4, 0.05)
        assert remote.DEFAULT_MAX_FRAME == REF.services_network_remote.DEFAULT_MAX_FRAME
        assert fresh.height() == 0  # a frame over 8 bytes is not refused
        for i in range(remote.DEFAULT_FLIGHT_N):
            PORT.utils_metrics.flight("knob.check", i=i)
        tail = fresh.ops_flight()
        assert len(tail) == remote.DEFAULT_FLIGHT_N == 64 and tail[-1]["i"] == 63
        fresh.close()
    finally:
        server.stop()
