"""PyTorch port, the pipelined block engine and backpressure against the
sequential engine and the JAX package.

Port mirrors of `tests/test_pipeline.py:71-410`: differential identity
of the pipelined and the sequential engine (verdicts, ledger state, WAL
contents, under an injected device fault too) and of both with the JAX
ledger on the same requests, strict height order under concurrency,
verify/commit overlap accounting, the `FTS_BLOCK_PIPELINE=0` kill
switch, a commit error reaching its waiter, condition-variable waits,
and admission control with exactly-once retry. The remote, soak,
`ftstop` and bench cases have no port counterpart yet. zkatdlog blocks
are 1-in/1-out on `device="cpu"` (`torch_network_cases`)."""

import threading
import time

import pytest
import torch

from fabric_token_sdk_tpu_torch.utils import profiler
from torch_network_cases import (
    PORT, REF, assert_same_ledger, build_both, counter, network, networks, policy, setup_both,
    submit_both, submit_many_both,
)

torch.set_num_threads(1)

VALID, INVALID = "Valid", "Invalid"
faults = PORT.utils_faults


@pytest.fixture(scope="module")
def zk_pps():
    return setup_both()


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    faults.clear()


def _wal_content(P, path):
    """Journal records minus the wall-clock stamp: the durable content two
    engines (and two packages) must agree on."""
    loads = P.crypto_serialization.loads
    return [{k: v for k, v in loads(raw).items() if k != "ts"}
            for raw in P.services_network_wal.WriteAheadLog(path).replay()]


def _fab_pay(e, values, prefix):
    return [e.issue("seed", values)] + [
        e.transfer(f"{prefix}-{i}", [("seed", i)], [v]) for i, v in enumerate(values)]


# ------------------------------------------------------------------ differential

def test_pipelined_vs_sequential_differential_fabtoken(tmp_path):
    """Same corpus (an intra-block double spend included) through both
    engines and the JAX ledger: identical verdicts, state and WAL
    contents (modulo timestamps)."""
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [5, 5, 7]),
        e.transfer("d-a", [("seed", 0)], [5]),
        e.transfer("d-b", [("seed", 0)], [5]),
        e.transfer("d-c", [("seed", 1)], [5]),
        e.transfer("d-d", [("seed", 2)], [7]),
    ])

    def run(pipeline):
        wals = {P.root: str(tmp_path / f"{P.root}-{int(pipeline)}.wal") for P in (REF, PORT)}
        nets = networks(envs, wal_paths=wals, max_block_txs=2, pipeline=pipeline)
        assert (nets[PORT.root]._engine is not None) == pipeline
        assert submit_both(nets, raws[0])[1] == VALID
        got = submit_many_both(nets, raws[1:])
        view = assert_same_ledger(nets)
        wal = _wal_content(PORT, wals[PORT.root])
        assert wal == _wal_content(REF, wals[REF.root])
        return got, view, wal

    piped, seq = run(True), run(False)
    assert piped == seq
    assert [s for _, s, _ in piped[0]] == [VALID, INVALID, VALID, VALID]
    assert piped[1]["height"] == 3  # the seed block + ceil(4/2) blocks
    assert [r["height"] for r in piped[2]] == [0, 1, 2]


def test_zk_pipelined_blocks_differential_and_metrics(zk_pps, tmp_path):
    """Four same-shape zkatdlog transfers streamed as two 2-tx blocks
    through the pipelined engine: verdicts, state and WAL contents match
    the sequential engine and the JAX ledger; the port's batched plane
    carried every proof in both engines; the pipeline counters moved."""
    envs, raws = build_both("zkatdlog", lambda e: [e.issue("zkp-seed", [5] * 4)] + [
        e.transfer(f"zkp-{i}", [("zkp-seed", i)], [5]) for i in range(4)], zk_pps)

    def run(pipeline):
        wals = {P.root: str(tmp_path / f"zk-{P.root}-{int(pipeline)}.wal") for P in (REF, PORT)}
        nets = networks(envs, wal_paths=wals, max_block_txs=2, min_batch=2, pipeline=pipeline)
        bt0 = counter(PORT, "batch.transfer.txs")
        assert submit_both(nets, raws[0])[1] == VALID
        got = submit_many_both(nets, raws[1:])
        assert counter(PORT, "batch.transfer.txs") - bt0 == 4
        view = assert_same_ledger(nets)
        wal = _wal_content(PORT, wals[PORT.root])
        assert wal == _wal_content(REF, wals[REF.root])
        return got, view["height"], wal

    blocks0 = counter(PORT, "orderer.pipeline.blocks")
    piped = run(True)
    piped_blocks = counter(PORT, "orderer.pipeline.blocks") - blocks0
    seq = run(False)
    assert piped == seq
    assert all(s == VALID for _, s, _ in piped[0])
    assert piped[1] == 3  # seed block + 2 transfer blocks, height-ordered
    assert piped_blocks >= 3  # every block rode the engine...
    assert counter(PORT, "orderer.pipeline.blocks") - blocks0 == piped_blocks  # ...seq none


def test_pipelined_batch_verify_fault_degrades_identically(zk_pps):
    """An injected `batch.verify` fault inside a PIPELINED block falls back
    to host validation with identical verdicts: the degrade chain
    survives the overlap, and it is counted and flight-recorded."""
    def run(inject):
        tag = f"pf-{int(inject)}"
        envs, raws = build_both("zkatdlog", lambda e: [e.issue(f"{tag}-seed", [5, 5])] + [
            e.transfer(f"{tag}-{i}", [(f"{tag}-seed", i)], [5]) for i in range(2)], zk_pps)
        nets = networks(envs, max_block_txs=8, min_batch=2, pipeline=True)
        assert nets[PORT.root]._engine is not None
        submit_both(nets, raws[0])
        if inject:
            faults.arm("batch.verify", "error", count=1)
        try:
            got = submit_many_both(nets, raws[1:])
        finally:
            faults.clear()
        assert_same_ledger(nets)
        return [s for _, s, _ in got]

    errors0 = counter(PORT, "ledger.block.batch_errors")
    host0 = counter(PORT, "ledger.validate.host")
    n_flight = len(PORT.utils_metrics.FLIGHT)
    injected = run(True)
    assert counter(PORT, "ledger.block.batch_errors") - errors0 == 1
    assert counter(PORT, "ledger.validate.host") - host0 == 2
    kinds = [e["kind"] for e in PORT.utils_metrics.FLIGHT.tail(len(PORT.utils_metrics.FLIGHT)
                                                                   - n_flight)]
    assert "verify.host_fallback" in kinds
    clean = run(False)
    assert injected == clean == [VALID, VALID]


def test_pipeline_kill_switch_restores_sequential(monkeypatch):
    """FTS_BLOCK_PIPELINE=0, the engine's one selector in the port: no
    engine, no overlap_s in the breakdown: the exact sequential path."""
    monkeypatch.setenv("FTS_BLOCK_PIPELINE", "0")
    envs, raws = build_both("fabtoken", lambda e: [e.issue("ks-seed", [5])])
    nets = networks(envs, max_block_txs=4)
    assert nets[PORT.root]._engine is None and nets[REF.root]._engine is None
    submit_both(nets, raws[0])
    assert "overlap_s" not in nets[PORT.root].last_block["breakdown"]
    assert_same_ledger(nets)


def test_pipelined_commit_error_reaches_the_waiter(tmp_path):
    """A commit-stage exception on the worker thread (an injected WAL
    fault) re-raises on the waiter's stack, and nothing durable is
    recorded; the resubmission commits exactly once."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5]),
                                                   e.transfer("we-pay", [("seed", 0)], [5])])
    net = network(PORT, envs[PORT.root], pipeline=True, policy=policy(PORT, max_block_txs=8),
                  wal_path=str(tmp_path / "err.wal"))
    faults.arm("wal.append", "error", count=1)
    with pytest.raises(faults.FaultInjected):
        net.submit(raws[1])
    faults.clear()
    assert net.status("we-pay") is None and net.height() == 0
    assert counter(PORT, "ledger.commit.stranded") >= 1
    # fault expended: an identical resubmission commits exactly once
    ev = net.submit(raws[1])
    assert ev.status.value == INVALID and "does not exist" in ev.message  # no seed
    assert net.height() == 1


def test_pipelined_height_order_under_concurrency():
    """Concurrent submitters through the engine: every tx lands in
    exactly one block, block numbers are strictly sequential."""
    envs, raws = build_both("fabtoken", lambda e: _fab_pay(e, [2] * 6, "hc"))
    net = network(PORT, envs[PORT.root], pipeline=True, policy=policy(PORT, max_block_txs=2))
    assert net.submit(raws[0]).status.value == VALID
    results, lock = [], threading.Lock()
    barrier = threading.Barrier(6)

    def worker(rb):
        barrier.wait()
        ev = net.submit(rb)
        with lock:
            results.append(ev)

    threads = [threading.Thread(target=worker, args=(rb,)) for rb in raws[1:]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(e.status.value == VALID for e in results)
    committed = []
    for i in range(1, net.height()):
        assert net.block(i).number == i  # strict height order at the merge
        committed.extend(net.block(i).txs)
    assert sorted(committed) == [f"hc-{i}" for i in range(6)]


def test_commit_worker_thread_role():
    """The engine's commit worker registers its profile role, and the
    finality listeners of a pipelined block run on it."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("role-seed", [1])])
    net = network(PORT, envs[PORT.root], pipeline=True, policy=policy(PORT))
    roles = []
    net.subscribe(lambda e, r: roles.append((profiler.thread_role(),
                                             threading.current_thread().name)))
    assert net.submit(raws[0]).status.value == VALID
    assert roles == [("commit-worker", "fts-block-commit")]
    assert profiler.thread_role() != "commit-worker"


# ------------------------------------------------------------------ overlap, waits

def test_overlap_recorded_when_commit_is_slow():
    """With a slow commit stage, block N+1's verify runs inside block N's
    commit window: `overlap_s` lands in the breakdown and the overlap
    histogram moves."""
    envs, raws = build_both("fabtoken", lambda e: _fab_pay(e, [2, 2, 2], "ov"))
    nets = networks(envs, max_block_txs=1, pipeline=True)
    submit_both(nets, raws[0])
    hist = PORT.utils_metrics.REGISTRY.histogram("orderer.pipeline.overlap.seconds")
    _, count0, sum0 = hist.state()
    faults.arm("ledger.commit_block", "delay", delay_s=0.15)
    try:
        got = nets[PORT.root].submit_many(raws[1:])
    finally:
        faults.clear()
    assert all(e.status.value == VALID for e in got)
    _, count, total = hist.state()
    assert count - count0 >= 3  # one observation a block
    assert total - sum0 > 0
    assert "overlap_s" in nets[PORT.root].last_block["breakdown"]
    nets[REF.root].submit_many(raws[1:])
    assert_same_ledger(nets)


def test_waiters_park_without_burning_cpu():
    """Waiters on an in-flight block wait on a condition variable, not a
    busy race on the commit lock: CPU time stays far below wall time."""
    envs, raws = build_both("fabtoken", lambda e: _fab_pay(e, [2, 2], "cw"))
    net = network(PORT, envs[PORT.root], pipeline=True, policy=policy(PORT, max_block_txs=8))
    net.submit(raws[0])
    subs = [net.submit_async(rb) for rb in raws[1:]]
    faults.arm("ledger.commit_block", "delay", delay_s=0.5)
    done = []
    threads = [threading.Thread(target=lambda s=s: done.append(s.result(timeout=30)))
               for s in subs]
    wall0, cpu0 = time.monotonic(), time.process_time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall, cpu = time.monotonic() - wall0, time.process_time() - cpu0
    assert all(e.status.value == VALID for e in done)
    assert wall >= 0.45  # the injected delay really gated the block
    assert cpu < 0.6 * wall, f"waiters burned {cpu:.2f}s CPU in {wall:.2f}s"


# ------------------------------------------------------------------ backpressure

def test_backpressure_rejects_before_ordering():
    """A full ordering queue rejects with the typed error BEFORE the tx
    enters ordering: nothing recorded, a later retry lands exactly once."""
    envs, raws = build_both("fabtoken", lambda e: _fab_pay(e, [2, 2, 2], "bp"))
    net = network(PORT, envs[PORT.root], policy=policy(PORT, max_block_txs=8, queue_max=2))
    net.submit(raws[0])
    rejects0 = counter(PORT, "orderer.backpressure.rejects")
    s0, s1 = net.submit_async(raws[1]), net.submit_async(raws[2])
    with pytest.raises(PORT.services_network.Backpressure):
        net.submit_async(raws[3])
    assert counter(PORT, "orderer.backpressure.rejects") - rejects0 == 1
    assert net.status("bp-2") is None  # never entered ordering
    net.flush()
    assert s0.result().status.value == VALID and s1.result().status.value == VALID
    resub0 = counter(PORT, "network.submit.resubmissions")
    assert net.submit(raws[3]).status.value == VALID
    assert counter(PORT, "network.submit.resubmissions") == resub0


def test_submit_many_is_cooperative_under_backpressure():
    """A batch larger than the queue bound lands WHOLE: the batch
    submitter drains its own queue on each rejection."""
    envs, raws = build_both("fabtoken", lambda e: _fab_pay(e, [2] * 6, "co"))
    nets = networks(envs, max_block_txs=2, queue_max=2)
    submit_both(nets, raws[0])
    flushes0 = counter(PORT, "orderer.backpressure.flushes")
    got = submit_many_both(nets, raws[1:])
    assert [s for _, s, _ in got] == [VALID] * 6
    assert counter(PORT, "orderer.backpressure.flushes") > flushes0
    assert_same_ledger(nets)
