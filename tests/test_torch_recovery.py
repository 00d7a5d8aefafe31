"""PyTorch port, WAL durability and crash recovery against the JAX package.

Port mirrors of `tests/test_recovery.py:114-405` (the journal's torn
tails and CRC corruption, `Network.recover` from snapshot plus WAL
suffix, compaction, a crash between the WAL append and the merge, WAL
faults, the append rollback, forked journals, a failed snapshot, the
fault framework), `:586` (an injected device fault degrades to host with
identical verdicts) and `:874` (a hung device plane stays live and
heals, slow and chaos as in the reference). State carried across, in
place of weights: a snapshot written by either package's `Network`
restores in the other's to the same state, and a WAL journal written by
either recovers in the other's; a port follower installs a JAX leader's
snapshot and applies its WAL records (`install_snapshot`, `apply_delta`).
Recovered ledgers are compared with the JAX ledger's exactly
(`torch_network_cases`)."""

import json
import os
import struct
import subprocess
import sys

import pytest
import torch

from torch_network_cases import (
    PORT, REF, assert_same_ledger, build_both, counter, ledger_view, network, networks, policy,
    setup_both, submit_both, submit_many_both,
)

torch.set_num_threads(1)

VALID, INVALID = "Valid", "Invalid"
N = PORT.services_network
faults = PORT.utils_faults
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.clear()


def _recover(P, env, path, **kw):
    if P is PORT:
        kw.setdefault("device", "cpu")
    return P.services_network.Network.recover(env.validator(), path, policy=policy(P), **kw)


def _restore(P, env, raw):
    kw = {"device": "cpu"} if P is PORT else {}
    return P.services_network.Network.restore(env.validator(), raw, policy=policy(P), **kw)


def _seed_and_pay(e, n_tokens=3):
    """A seed issue, (n_tokens - 1) transfers, and a correctly signed
    conflicting spend `dup` of the first token (built before it is
    consumed)."""
    reqs = [e.issue("seed", [5] * n_tokens), e.transfer("dup", [("seed", 0)], [5])]
    return reqs + [e.transfer(f"pay-{i}", [("seed", i)], [5]) for i in range(n_tokens - 1)]


def _port_net(env, tmp_path, **kw):
    wal = str(tmp_path / "ledger.wal")
    kw.setdefault("snapshot_every", 0)
    return network(PORT, env, policy=policy(PORT), wal_path=wal, **kw), wal


# ------------------------------------------------------------------ the journal

def test_wal_append_replay_roundtrip(tmp_path):
    wal = N.WriteAheadLog(tmp_path / "t.wal")
    payloads = [b"alpha", b"", b"\x00" * 1000, b"tail"]
    for p in payloads:
        wal.append(p)
    assert wal.replay() == payloads
    wal.append(b"more")
    assert wal.replay() == payloads + [b"more"]
    wal.close()
    # the JAX package reads the port's journal byte for byte
    assert REF.services_network.WriteAheadLog(tmp_path / "t.wal").replay() == payloads + [b"more"]


def test_wal_torn_tail_truncated(tmp_path):
    path = tmp_path / "t.wal"
    wal = N.WriteAheadLog(path)
    wal.append(b"one")
    wal.append(b"two")
    before = counter(PORT, "wal.torn_tails")
    with open(path, "ab") as fh:  # a header promising more than exists
        fh.write(struct.pack(">II", 4096, 0xDEAD) + b"only-a-fragment")
    assert wal.replay() == [b"one", b"two"]
    assert counter(PORT, "wal.torn_tails") - before == 1
    wal.append(b"three")  # truncated back: clean and appendable again
    assert wal.replay() == [b"one", b"two", b"three"]
    assert counter(PORT, "wal.torn_tails") - before == 1
    wal.close()


def test_wal_crc_corruption_is_a_torn_tail(tmp_path):
    path = tmp_path / "t.wal"
    wal = N.WriteAheadLog(path)
    wal.append(b"good-record")
    wal.append(b"bad-record!")
    with open(path, "r+b") as fh:  # flip one payload byte of the LAST record
        fh.seek(-1, os.SEEK_END)
        last = fh.read(1)
        fh.seek(-1, os.SEEK_END)
        fh.write(bytes([last[0] ^ 0xFF]))
    before = counter(PORT, "wal.torn_tails")
    assert wal.replay() == [b"good-record"]
    assert counter(PORT, "wal.torn_tails") - before == 1
    wal.close()


# ------------------------------------------------------------------ recover and compaction

def test_network_recover_replays_wal(tmp_path):
    envs, raws = build_both("fabtoken", _seed_and_pay)
    env = envs[PORT.root]
    net, wal = _port_net(env, tmp_path)
    ref = network(REF, envs[REF.root], policy=policy(REF))
    for rb in [raws[0]] + raws[2:]:
        assert submit_both({PORT.root: net, REF.root: ref}, rb)[1] == VALID
    net2 = _recover(PORT, env, wal)
    assert net2.height() == net.height() == 3
    assert net2.block(1).txs == ["pay-0"]
    assert ledger_view(PORT, net2) == ledger_view(PORT, net) == ledger_view(REF, ref)
    ID = PORT.models_token.ID
    assert net2.resolve_input(ID("pay-0", 0)) == net.resolve_input(ID("pay-0", 0))
    # the recovered ledger still enforces MVCC
    ev = net2.submit(raws[1])
    assert ev.status.value == INVALID and "already spent" in ev.message


def test_snapshot_compaction_truncates_replayed_prefix(tmp_path):
    envs, raws = build_both("fabtoken", lambda e: _seed_and_pay(e, 4) + [
        e.issue("post", [1])])
    env = envs[PORT.root]
    snaps0 = counter(PORT, "wal.snapshots")
    net, wal = _port_net(env, tmp_path, snapshot_every=2)
    for rb in [raws[0]] + raws[2:5]:
        assert net.submit(rb).status.value == VALID
    assert counter(PORT, "wal.snapshots") - snaps0 == 2  # at heights 2 and 4
    assert os.path.exists(wal + ".snap")
    assert N.WriteAheadLog(wal).replay() == []  # the snapshot covers everything
    net2 = _recover(PORT, env, wal)
    assert net2.height() == 4 and net2.status("pay-2").status.value == VALID
    # post-recovery commits keep journaling and compacting on the same files
    assert net2.submit(raws[5]).status.value == VALID
    net3 = _recover(PORT, env, wal)
    assert net3.height() == 5 and net3.status("post").status.value == VALID
    assert ledger_view(PORT, net3) == ledger_view(PORT, net2)


def test_crash_between_wal_append_and_merge_redoes_block(tmp_path, monkeypatch):
    """A block whose record is fsync'd but whose in-memory merge crashed is
    REDOne on recovery; the submitter re-learns the verdict."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5]),
                                                   e.transfer("pay", [("seed", 0)], [5])])
    env = envs[PORT.root]
    net, wal = _port_net(env, tmp_path)
    net.submit(raws[0])

    def crash(self):
        raise OSError("simulated crash between WAL append and merge")

    monkeypatch.setattr(N.ledger._BlockView, "merge", crash)
    with pytest.raises(OSError):
        net.submit(raws[1])
    assert net.status("pay") is None
    monkeypatch.undo()
    net2 = _recover(PORT, env, wal)
    assert net2.status("pay").status.value == VALID  # redone from the journal
    ID = PORT.models_token.ID
    assert net2.exists(ID("pay", 0)) and not net2.exists(ID("seed", 0))
    assert net2.submit(raws[1]).status.value == VALID  # the idempotent no-op
    assert net2.height() == 2


def test_injected_wal_fault_fails_commit_without_finality(tmp_path):
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5])])
    env = envs[PORT.root]
    net, wal = _port_net(env, tmp_path)
    faults.arm("wal.append", "error", count=1)
    before = counter(PORT, "faults.injected.wal.append")
    with pytest.raises(faults.FaultInjected):
        net.submit(raws[0])
    assert counter(PORT, "faults.injected.wal.append") - before == 1
    assert net.status("seed") is None and net.height() == 0
    assert net.submit(raws[0]).status.value == VALID  # fault expended
    net2 = _recover(PORT, env, wal)
    assert net2.height() == 1 and net2.status("seed").status.value == VALID


def test_failed_wal_append_rolls_back_journal(tmp_path, monkeypatch):
    """An append that fails after its bytes hit the file (fsync ENOSPC)
    rolls the journal back to the pre-append boundary."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5]),
                                                   e.transfer("pay", [("seed", 0)], [5])])
    env = envs[PORT.root]
    net, wal = _port_net(env, tmp_path)
    net.submit(raws[0])

    def flaky_fsync(fd):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(N.wal.os, "fsync", flaky_fsync)
    before = counter(PORT, "wal.append_failures")
    with pytest.raises(OSError):
        net.submit(raws[1])
    monkeypatch.undo()
    assert counter(PORT, "wal.append_failures") - before == 1
    assert not net._wal.poisoned
    assert len(N.WriteAheadLog(wal).replay()) == 1  # the record is GONE
    assert net.submit(raws[1]).status.value == VALID
    net2 = _recover(PORT, env, wal)
    assert net2.height() == 2 and net2.status("pay").status.value == VALID


def test_recover_rejects_forked_journal(tmp_path):
    """Two records journaled at ONE height fail recovery loudly."""
    dumps = PORT.crypto_serialization.dumps
    path = str(tmp_path / "forked.wal")
    wal = N.WriteAheadLog(path)
    rec = {"height": 0, "ts": 0.0, "requests": [], "txs": [["a", "Valid", ""]],
           "consumed": [], "outputs": {}}
    wal.append(dumps(rec))
    wal.append(dumps(rec))
    wal.close()
    envs, _ = build_both("fabtoken", lambda e: [])
    with pytest.raises(N.WALError):
        _recover(PORT, envs[PORT.root], path)
    with pytest.raises(REF.services_network.WALError):
        _recover(REF, envs[REF.root], path)


def test_snapshot_failure_does_not_poison_commit(tmp_path, monkeypatch):
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5])])
    env = envs[PORT.root]
    net, wal = _port_net(env, tmp_path, snapshot_every=1)
    seen = []
    net.subscribe(lambda e, r: seen.append(e.tx_id))

    def broken_compact(self):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(N.Network, "_compact", broken_compact)
    before = counter(PORT, "wal.snapshot_failures")
    assert net.submit(raws[0]).status.value == VALID
    assert counter(PORT, "wal.snapshot_failures") - before == 1
    assert seen == ["seed"]  # listeners ran
    monkeypatch.undo()
    net2 = _recover(PORT, env, wal)
    assert net2.height() == 1 and net2.status("seed").status.value == VALID


def test_faults_env_parse_count_and_kinds():
    before = counter(PORT, "faults.injected.t.site")
    assert faults.load_env("t.site:error:1.0:2") == 1
    for _ in range(2):
        with pytest.raises(faults.FaultInjected):
            faults.fire("t.site")
    faults.fire("t.site")  # count exhausted: no-op
    assert counter(PORT, "faults.injected.t.site") - before == 2
    faults.clear()
    faults.arm("t.drop", "drop", count=1)
    with pytest.raises(ConnectionError):
        faults.fire("t.drop")
    faults.arm("t.delay", "delay", delay_s=0.01)
    faults.fire("t.delay")  # sleeps, returns
    with pytest.raises(ValueError):
        faults.arm("t.bad", "explode")
    with pytest.raises(ValueError):
        faults.load_env("nokind")
    faults.clear()
    faults.fire("t.site")  # disarmed: no-op


# ------------------------------------------------------------------ state carried across packages

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_crosses_packages(writer):
    """A snapshot written by one package's `Network` restores in the
    other's to the same state, statuses and blocks, and the restored
    ledger goes on enforcing it."""
    envs, raws = build_both("fabtoken", lambda e: _seed_and_pay(e, 3) + [
        e.transfer("pay-2", [("seed", 2)], [5])])
    nets = networks(envs, max_block_txs=2)
    submit_both(nets, raws[0])
    submit_many_both(nets, raws[2:])
    view = assert_same_ledger(nets)
    src, dst = (REF, PORT) if writer == "jax" else (PORT, REF)
    raw = nets[src.root].snapshot()
    restored = _restore(dst, envs[dst.root], raw)
    assert ledger_view(dst, restored) == view
    ev = restored.submit(raws[1])  # the recovered-spent seed.0 again
    assert ev.status.value == INVALID and "already spent" in ev.message


def test_jax_wal_recovers_in_the_port(tmp_path):
    """A WAL journal (and its compaction snapshot) written by the JAX
    ledger recovers in the port's to the same ledger, and the other way
    round."""
    envs, raws = build_both("fabtoken", lambda e: _seed_and_pay(e, 4))
    wals = {P.root: str(tmp_path / f"{P.root}.wal") for P in (REF, PORT)}
    nets = {}
    for P in (REF, PORT):
        kw = {"device": "cpu"} if P is PORT else {}
        nets[P.root] = P.services_network.Network(
            envs[P.root].validator(), policy=policy(P, max_block_txs=2),
            wal_path=wals[P.root], snapshot_every=3, **kw)
    submit_both(nets, raws[0])
    submit_many_both(nets, raws[2:])  # blocks at heights 1 and 2: a snapshot at 3 blocks
    submit_both(nets, raws[1])  # a rejected double spend, journaled at height 3
    view = assert_same_ledger(nets)
    assert view["height"] == 4
    for src, dst in ((REF, PORT), (PORT, REF)):
        assert os.path.exists(wals[src.root] + ".snap")
        assert len(src.services_network.WriteAheadLog(wals[src.root]).replay()) == 1
        got = _recover(dst, envs[dst.root], wals[src.root])
        assert ledger_view(dst, got) == view


def test_follower_applies_jax_records_and_snapshot(tmp_path):
    """The follower-side entry points with no replication around them: a
    port ledger installs a JAX ledger's snapshot (`install_snapshot`),
    then applies its later WAL records (`apply_delta`), journaling each,
    and ends equal to it; a re-shipped record is skipped, a height gap
    raises, and the follower's own journal recovers the same ledger."""
    envs, raws = build_both("fabtoken", lambda e: _seed_and_pay(e, 4))
    ref_wal = str(tmp_path / "leader.wal")
    leader = REF.services_network.Network(envs[REF.root].validator(),
                                          policy=policy(REF, max_block_txs=1),
                                          wal_path=ref_wal, snapshot_every=0)
    assert leader.submit(raws[0]).status.value == VALID
    base = leader.snapshot()  # height 1
    for rb in raws[2:] + raws[1:2]:
        leader.submit(rb)
    records = REF.services_network.WriteAheadLog(ref_wal).replay()[1:]  # heights 1-4
    env = envs[PORT.root]
    follower, wal = _port_net(env, tmp_path)
    assert follower.install_snapshot(base) == 1
    skipped0 = counter(PORT, "repl.apply.skipped")
    for rec in records:
        follower.apply_delta(rec)
    assert follower.apply_delta(records[0]) == 5  # re-shipped: skipped
    assert counter(PORT, "repl.apply.skipped") - skipped0 == 1
    gap = REF.crypto_serialization.loads(records[-1])
    gap["height"] = 7
    with pytest.raises(N.WALError, match="gap"):
        follower.apply_delta(REF.crypto_serialization.dumps(gap))
    assert ledger_view(PORT, follower) == ledger_view(REF, leader)
    assert ledger_view(PORT, _recover(PORT, env, wal)) == ledger_view(REF, leader)


# ------------------------------------------------------------------ device faults

def test_batch_verify_fault_degrades_to_host_same_verdicts():
    """An injected `batch.verify` fault mid-block falls back to host
    validation with verdicts identical to the JAX ledger's and to the
    fault-free run."""
    zk_pps = setup_both()

    def run(inject):
        envs, raws = build_both("zkatdlog", lambda e: [e.issue("seed", [5, 5])] + [
            e.transfer(f"pay-{i}", [("seed", i)], [5]) for i in range(2)], zk_pps)
        nets = networks(envs, max_block_txs=8, min_batch=2)
        submit_both(nets, raws[0])
        if inject:
            faults.arm("batch.verify", "error", count=1)
        try:
            got = submit_many_both(nets, raws[1:])
        finally:
            faults.clear()
        assert_same_ledger(nets)
        return [s for _, s, _ in got]

    host0 = counter(PORT, "ledger.validate.host")
    errors0 = counter(PORT, "ledger.block.batch_errors")
    injected = run(True)
    assert counter(PORT, "ledger.block.batch_errors") - errors0 == 1
    assert counter(PORT, "ledger.validate.host") - host0 == 2
    clean = run(False)
    assert injected == clean == [VALID, VALID]


_HANG_CHILD = r"""
import json, os, random, sys, time
sys.path.insert(0, sys.argv[1])
os.environ["FTS_BREAKER_TIMEOUTS"] = "1"
os.environ["FTS_BREAKER_COOLDOWN_S"] = "20.0"
import torch
torch.set_num_threads(1)
from fabric_token_sdk_tpu_torch.api.request import IssueRecord, TokenRequest, TransferRecord
from fabric_token_sdk_tpu_torch.api.validator import RequestValidator
from fabric_token_sdk_tpu_torch.crypto import sign as csign
from fabric_token_sdk_tpu_torch.crypto.setup import setup
from fabric_token_sdk_tpu_torch.drivers import identity
from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
from fabric_token_sdk_tpu_torch.models.token import ID
from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network
from fabric_token_sdk_tpu_torch.utils import faults, resilience
from fabric_token_sdk_tpu_torch.utils import metrics as mx

rng = random.Random(0xF75)
pp = setup(base=4, exponent=2, rng=rng)
drv = ZKATDLogDriver(pp, device="cpu")
net = Network(RequestValidator(ZKATDLogDriver(pp, device="cpu")),
              policy=BlockPolicy(max_block_txs=8, min_batch=2), device="cpu")
key = csign.keygen(rng)
ident = identity.pk_identity(key.public)
out = drv.issue(ident, "USD", [7, 7], [ident, ident], anonymous=False, rng=rng)
req = TokenRequest(anchor="seed")
req.issues.append(IssueRecord(action=out.action_bytes, issuer=ident,
                              outputs_metadata=out.metadata, receivers=[ident, ident]))
req.issues[0].signature = key.sign(req.marshal_to_sign(), rng)
assert net.submit(req.to_bytes()).status.value == "Valid"
chains = [(ID("seed", i), out.outputs[i], out.metadata[i]) for i in range(2)]


def block(tag):
    global chains
    batch, nxt = [], []
    for i, (tid, raw, meta) in enumerate(chains):
        t = drv.transfer([tid], [raw], [meta], "USD", [7], [ident], rng=rng)
        tr = TokenRequest(anchor=f"{tag}-{i}")
        tr.transfers.append(TransferRecord(action=t.action_bytes, input_ids=[tid],
                                           senders=[ident], outputs_metadata=t.metadata,
                                           receivers=[ident]))
        tr.transfers[0].signatures = [key.sign(tr.marshal_to_sign(), rng)]
        batch.append(tr.to_bytes())
        nxt.append((ID(f"{tag}-{i}", 0), t.outputs[0], t.metadata[0]))
    t0 = time.monotonic()
    events = net.submit_many(batch)
    wall = time.monotonic() - t0
    assert all(e.status.value == "Valid" for e in events), [e.message for e in events]
    chains = nxt
    return wall


def ctr(name):
    return mx.REGISTRY.counter(name).value


warm_wall = block("warm")
assert ctr("ledger.validate.batched") >= 2, "the warm block did not ride the device plane"
os.environ["FTS_DEVICE_DEADLINE_VERIFY_S"] = "2"
faults.arm("batch.verify", "hang", count=1, delay_s=600)
hang_wall = block("hung")
faults.disarm("batch.verify")
state_after_hang = resilience.breaker_states().get("verify")
rej_applicable = state_after_hang == "open"
rejected_wall = block("rej")
os.environ["FTS_DEVICE_DEADLINE_VERIFY_S"] = "300"
time.sleep(20.5)
batched_before = ctr("ledger.validate.batched")
block("heal")
print(json.dumps({
    "ok": True, "warm_wall": warm_wall, "hang_wall": hang_wall,
    "rejected_wall": rejected_wall, "rej_applicable": rej_applicable,
    "breaker_open": ctr("resilience.breaker.open"), "state_after_hang": state_after_hang,
    "rejected": ctr("resilience.breaker.rejected"),
    "breaker_close": ctr("resilience.breaker.close"),
    "timeouts": ctr("resilience.bounded.timeouts"),
    "reengaged_rows": ctr("ledger.validate.batched") - batched_before,
}), flush=True)
"""


@pytest.mark.slow
@pytest.mark.chaos
def test_hung_device_plane_stays_live_and_heals():
    """A `hang` at `batch.verify` in a subprocess node: the block commits
    via host fallback within the deadline plus slack, the `verify`
    breaker OPENS, the next block is rejected up front, and after the
    cooldown a half-open probe RE-ENGAGES the device plane."""
    proc = subprocess.run([sys.executable, "-c", _HANG_CHILD, ROOT], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=840)
    assert proc.returncode == 0, f"chaos child failed:\n{proc.stderr[-4000:]}"
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["hang_wall"] < 60, report
    assert report["timeouts"] >= 1 and report["breaker_open"] >= 1
    assert report["state_after_hang"] == "open"
    if report["rej_applicable"]:
        assert report["rejected"] >= 1
    assert report["rejected_wall"] < 60, report
    assert report["breaker_close"] >= 1
    assert report["reengaged_rows"] >= 2, report
