"""PyTorch port, the orderer and the block validation pipeline against the
JAX package.

Port mirrors of `tests/test_orderer.py`: intra-block double spends (the
LATER tx is invalidated, never the block), conflicts across consecutive
blocks, same-shape zkatdlog groups in ONE batched verify on the port's
plane (`device="cpu"`: the kernels' plain torch versions), mixed
batched/host blocks, differential block vs per-tx commits, listener
crash isolation, block-cut policy and snapshot/restore. Every case
submits the same request bytes (built by both packages from one seed) to
the JAX `Network` and the port's, and compares statuses and messages,
heights, block tx lists, state and spent sets exactly
(`torch_network_cases`). The reference's mesh-sharded block test runs
on a logical mesh of CPU devices; the mesh, device and sign-plane rules
of the port's `Network` are pinned here too."""

import threading

import pytest
import torch

from torch_network_cases import (
    PORT, REF, assert_same_ledger, build_both, counter, events, host_sign_plane, module,
    network, networks, policy, setup_both, submit_both, submit_many_both,
)

torch.set_num_threads(1)

VALID, INVALID = "Valid", "Invalid"


@pytest.fixture(scope="module")
def zk_pps():
    return setup_both()


# ------------------------------------------------------------------ MVCC (fabtoken, host plane)

def test_intra_block_double_spend_invalidates_later_tx():
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [5]),
        e.transfer("spend-a", [("seed", 0)], [5]),
        e.transfer("spend-b", [("seed", 0)], [5]),
    ])
    nets = networks(envs, max_block_txs=8)
    submit_both(nets, raws[0])
    got = submit_many_both(nets, raws[1:])
    assert [s for _, s, _ in got] == [VALID, INVALID]
    assert "already spent" in got[1][2]
    view = assert_same_ledger(nets)
    # ONE block carried both txs; only the conflicting one was dropped
    assert view["height"] == 2 and view["blocks_api"][1] == ["spend-a", "spend-b"]
    port = nets[PORT.root]
    assert port.status("spend-a").status.value == VALID
    assert port.status("spend-b").status.value == INVALID
    assert port.exists(PORT.models_token.ID("spend-a", 0))
    assert not port.exists(PORT.models_token.ID("seed", 0))


def test_conflict_across_consecutive_blocks():
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [7]),
        e.transfer("blk-a", [("seed", 0)], [7]),
        e.transfer("blk-b", [("seed", 0)], [7]),
    ])
    nets = networks(envs)
    submit_both(nets, raws[0])
    assert submit_both(nets, raws[1])[1] == VALID
    ev_b = submit_both(nets, raws[2])  # next block, same input
    assert ev_b[1] == INVALID and "already spent" in ev_b[2]
    assert nets[PORT.root].height() == 3
    # idempotent resubmission returns the recorded event, adds no block
    assert submit_both(nets, raws[1])[1] == VALID
    assert assert_same_ledger(nets)["height"] == 3


def test_intra_block_create_then_spend():
    """An output created by an EARLIER tx in the block is spendable by a
    later tx of the same block."""
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [9]),
        e.transfer("hop-1", [("seed", 0)], [9], to="alice"),
        e.transfer("hop-2", [("hop-1", 0)], [9]),
    ])
    nets = networks(envs, max_block_txs=4)
    submit_both(nets, raws[0])
    got = submit_many_both(nets, raws[1:])
    assert [s for _, s, _ in got] == [VALID, VALID]
    view = assert_same_ledger(nets)
    assert view["blocks_api"][1] == ["hop-1", "hop-2"]
    assert nets[PORT.root].exists(PORT.models_token.ID("hop-2", 0))


def test_differential_block_vs_per_tx():
    """A block commit and per-tx commits of the SAME requests agree on
    every status and on the final ledger state."""
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [4, 6]),
        e.transfer("d-a", [("seed", 0)], [4]),
        e.transfer("d-b", [("seed", 0)], [4]),
        e.transfer("d-c", [("seed", 1)], [6]),
    ])
    nets = networks(envs, max_block_txs=8)
    submit_both(nets, raws[0])
    block = submit_many_both(nets, raws[1:])
    assert_same_ledger(nets)
    # fresh ledgers, one tx per block, no batched plane
    seq_nets = networks(envs, max_block_txs=1, use_batched=False)
    seq = [submit_both(seq_nets, rb) for rb in raws]
    assert [s for _, s, _ in seq[1:]] == [s for _, s, _ in block]
    ID = PORT.models_token.ID
    for anchor in ("d-a", "d-b", "d-c"):
        assert nets[PORT.root].exists(ID(anchor, 0)) == seq_nets[PORT.root].exists(ID(anchor, 0))
    assert not nets[PORT.root].exists(ID("d-b", 0))


# ------------------------------------------------------------------ zkatdlog blocks, batched plane

def _pay(e, n, value=5, seed_anchor="seed"):
    return [e.issue(seed_anchor, [value] * n)] + [
        e.transfer(f"pay-{i}", [(seed_anchor, i)], [value]) for i in range(n)]


def test_zk_block_rides_batched_verifier(zk_pps):
    """A block of same-shape zkatdlog transfers validates through ONE
    batched verify on the port's plane, with per-tx finality equal to the
    JAX ledger's host validation."""
    n = 4
    envs, raws = build_both("zkatdlog", lambda e: _pay(e, n), zk_pps)
    nets = networks(envs, max_block_txs=16, min_batch=2)
    submit_both(nets, raws[0])
    before = {k: counter(PORT, k) for k in (
        "batch.transfer.txs", "batch.transfer.batches", "ledger.validate.batched",
        "ledger.validate.host", "ledger.blocks.committed", "ledger.block.batch_errors")}
    size_hist = PORT.utils_metrics.REGISTRY.histogram("ledger.block.size")
    size_before = size_hist.count
    got = submit_many_both(nets, raws[1:])
    assert all(s == VALID for _, s, _ in got)
    view = assert_same_ledger(nets)
    assert view["height"] == 2 and view["blocks_api"][1] == [f"pay-{i}" for i in range(n)]
    delta = {k: counter(PORT, k) - v for k, v in before.items()}
    assert delta["batch.transfer.txs"] == n  # one call carried every proof
    assert delta["ledger.validate.batched"] == n and delta["ledger.validate.host"] == 0
    assert delta["ledger.blocks.committed"] == 1 and delta["ledger.block.batch_errors"] == 0
    assert size_hist.count == size_before + 1
    assert nets[PORT.root].last_block["breakdown"]["device_verify_s"] > 0


def test_zk_block_differential_vs_host(zk_pps):
    """Batched block commit and per-tx host commits of the SAME zkatdlog
    requests agree on every status, the MVCC conflict included."""
    envs, raws = build_both("zkatdlog", lambda e: [
        e.issue("zk-seed", [5, 5]),
        e.transfer("zk-a", [("zk-seed", 0)], [5]),
        e.transfer("zk-b", [("zk-seed", 1)], [5]),
        e.transfer("zk-c", [("zk-seed", 0)], [5]),
    ], zk_pps)
    nets = networks(envs, max_block_txs=8, min_batch=2)
    submit_both(nets, raws[0])
    bt0 = counter(PORT, "batch.transfer.txs")
    block = submit_many_both(nets, raws[1:])
    # all three same-shape proofs batch-verified; the conflict is MVCC's
    assert counter(PORT, "batch.transfer.txs") - bt0 == 3
    assert [s for _, s, _ in block] == [VALID, VALID, INVALID]
    assert "already spent" in block[2][2]
    assert_same_ledger(nets)
    seq = networks(envs, max_block_txs=1, use_batched=False)
    got = [submit_both(seq, rb) for rb in raws]
    assert [s for _, s, _ in got[1:]] == [s for _, s, _ in block]


def test_zk_mixed_block_host_and_batched(zk_pps):
    """One block mixing every plane: an issue (host), a same-shape
    transfer pair (batched) and an odd-shape singleton (host), after an
    issue-only block (no groups)."""
    envs, raws = build_both("zkatdlog", lambda e: [
        e.issue("mx-seed", [5, 5, 5]),
        e.issue("mx-issue2", [2]),
        e.transfer("mx-t1", [("mx-seed", 0)], [5]),  # (1, 1)
        e.transfer("mx-t2", [("mx-seed", 1)], [5]),  # (1, 1)
        e.transfer("mx-t3", [("mx-seed", 2)], [3, 2]),  # (1, 2): host
    ], zk_pps)
    nets = networks(envs, max_block_txs=8, min_batch=2)
    submit_both(nets, raws[0])
    b0, h0 = counter(PORT, "ledger.validate.batched"), counter(PORT, "ledger.validate.host")
    got = submit_many_both(nets, raws[1:])
    assert all(s == VALID for _, s, _ in got)
    assert assert_same_ledger(nets)["height"] == 2
    assert counter(PORT, "ledger.validate.batched") - b0 == 2
    assert counter(PORT, "ledger.validate.host") - h0 == 1


def test_zk_batched_group_rejects_tampered_proof(zk_pps):
    """A tampered proof inside a batched group invalidates ONLY its own
    tx: the device verdict (False) reaches the driver while the group's
    other tx commits."""
    def scenario(e):
        P = e.P
        reqs = [e.issue("tamper-seed", [5, 5]),
                e.transfer("tp-ok", [("tamper-seed", 0)], [5]),
                e.transfer("tp-bad", [("tamper-seed", 1)], [5])]
        ser = P.crypto_serialization
        tr = module(P, "crypto.transfer")
        wf = module(P, "crypto.wellformedness")
        hm = module(P, "crypto.hostmath")
        bad = reqs[2]
        action = ser.loads(bad.transfers[0].action)
        proof = tr.TransferProof.from_bytes(action["proof"])
        w = wf.TransferWF.from_bytes(proof.wf)
        w.sum_resp = (w.sum_resp + 1) % hm.R
        proof.wf = w.to_bytes()
        action["proof"] = proof.to_bytes()
        bad.transfers[0].action = ser.dumps(action)
        e.tms.sign_transfers(bad)  # only the PROOF is at fault
        return reqs

    envs, raws = build_both("zkatdlog", scenario, zk_pps)
    nets = networks(envs, max_block_txs=8, min_batch=2)
    submit_both(nets, raws[0])
    bt0 = counter(PORT, "batch.transfer.txs")
    got = submit_many_both(nets, raws[1:])
    assert counter(PORT, "batch.transfer.txs") - bt0 == 2  # both batched
    assert [s for _, s, _ in got] == [VALID, INVALID]
    assert "invalid transfer proof" in got[1][2]
    assert_same_ledger(nets)
    ID = PORT.models_token.ID
    assert nets[PORT.root].exists(ID("tamper-seed", 1))
    assert not nets[PORT.root].exists(ID("tamper-seed", 0))


@pytest.mark.parametrize("pipelined", [True, False])
def test_zk_block_through_sharded_pipeline(zk_pps, pipelined):
    """The reference's `test_zk_block_through_sharded_pipeline`: one
    zkatdlog block (four 1-in/1-out transfers and an intra-block double
    spend) through the port's `Network(mesh=...)` on the logical (2, 2)
    mesh of CPU devices, with the pipelined engine and without. Statuses,
    messages, blocks, state and spent set equal the JAX ledger's; the
    block's one batched verify ran bound to the mesh (in the engine's
    stage A too) over its 2 row groups; a restored or recovered ledger
    takes the mesh as well."""
    from fabric_token_sdk_tpu_torch.crypto.batch import BatchedTransferVerifier
    from torch_mesh_cases import cpu_mesh

    n = 4
    envs, raws = build_both("zkatdlog", lambda e: _pay(e, n) + [
        e.transfer("pay-again", [("seed", 1)], [5])], zk_pps)
    mesh = cpu_mesh("(2, 2)")
    nets = {P.root: network(P, envs[P.root], pipeline=pipelined,
                            policy=policy(P, max_block_txs=8, min_batch=2),
                            **({"mesh": mesh} if P is PORT else {}))
            for P in (REF, PORT)}
    port = nets[PORT.root]
    assert port._pipeline.mesh is mesh and (port._engine is not None) == pipelined
    submit_both(nets, raws[0])
    bound = []
    real = BatchedTransferVerifier.verify

    def spy(self, txs):
        bound.append((self.mesh, threading.current_thread().name))
        return real(self, txs)

    sharded = counter(PORT, "stages.sharded_calls")
    BatchedTransferVerifier.verify = spy
    try:
        got = submit_many_both(nets, raws[1:])
    finally:
        BatchedTransferVerifier.verify = real
    assert [s for _, s, _ in got] == [VALID] * n + [INVALID]
    assert "already spent" in got[-1][2]
    view = assert_same_ledger(nets)
    assert view["height"] == 2
    assert [m for m, _ in bound] == [mesh]  # one bound verify of the block
    assert counter(PORT, "stages.sharded_calls") - sharded == 3  # g1_msm, g1_mul, g1_sub
    N = PORT.services_network
    validator = envs[PORT.root].validator()
    restored = N.Network.restore(validator, port.snapshot(), policy=policy(PORT), device="cpu",
                                 mesh=mesh)
    assert restored._pipeline.mesh is mesh
    assert restored.snapshot() == port.snapshot()


def test_mesh_rules_of_the_block_path(zk_pps, tmp_path):
    """A `MeshConfig` names no device (TypeError); a mesh whose first
    device is not the pipeline's raises ValueError, for `Network`, the
    pipeline and `Network.recover` alike (the block path's device rule)."""
    from fabric_token_sdk_tpu_torch.parallel import MeshConfig, make_mesh
    from fabric_token_sdk_tpu_torch.services.network.orderer import BlockValidationPipeline

    envs, _ = build_both("zkatdlog", lambda e: [], zk_pps)
    env = envs[PORT.root]
    N = PORT.services_network
    meta = make_mesh(2, devices=[torch.device("meta")] * 2)
    for mesh, err in ((MeshConfig.build(4, mp=2), TypeError), (meta, ValueError)):
        with pytest.raises(err):
            N.Network(env.validator(), policy=policy(PORT), mesh=mesh, device="cpu")
        with pytest.raises(err):
            BlockValidationPipeline(env.validator(), policy(PORT), mesh=mesh, device="cpu")
        with pytest.raises(err):
            N.Network.recover(env.validator(), str(tmp_path / "w.wal"), mesh=mesh, device="cpu")


# ------------------------------------------------------------------ the port's device rules

def test_device_default_is_the_card_and_driver_device_must_match(zk_pps, monkeypatch):
    envs, _ = build_both("zkatdlog", lambda e: [], zk_pps)
    env = envs[PORT.root]
    N = PORT.services_network
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        N.Network(env.validator(), policy=policy(PORT))
    # a driver whose own device (None: the card) is not the ledger's
    with pytest.raises(ValueError, match="same device"):
        N.Network(env.validator(device=None), policy=policy(PORT), device="cpu")
    net = N.Network(env.validator(device="cpu"), policy=policy(PORT), device="cpu")
    assert net.device == torch.device("cpu") and net.health()["device"]["name"] == "cpu"


def test_sign_plane_auto_follows_the_device():
    """`sign_batched=None` is on for a CUDA device and off on the CPU,
    decided from the resolved device (not from what is imported)."""
    from fabric_token_sdk_tpu_torch.services.network.orderer import BlockValidationPipeline

    envs, _ = build_both("fabtoken", lambda e: [])
    env = envs[PORT.root]
    cpu = BlockValidationPipeline(env.validator(), policy(PORT), device="cpu")
    assert not cpu.sign_enabled()
    cpu.device = torch.device("cuda")  # as resolved on a machine with a card
    assert cpu.sign_enabled()
    forced = BlockValidationPipeline(env.validator(), policy(PORT, sign_batched=True),
                                     device="cpu")
    assert forced.sign_enabled()


def test_sign_plane_on_the_cpu_equals_host(monkeypatch):
    """With `sign_batched=True` on the CPU the block's pk signatures go
    through ONE `BatchedSchnorrVerifier` call (the plain `schnorr_rows`):
    statuses equal the host's, messages the JAX ledger's, and a wrong
    signature is still rejected."""
    def scenario(e):
        reqs = [e.issue("sg-seed", [5, 5, 5]),
                e.transfer("sg-0", [("sg-seed", 0)], [5]),
                e.transfer("sg-1", [("sg-seed", 1)], [5]),
                e.transfer("sg-2", [("sg-seed", 2)], [5])]
        # a valid signature of another request: the plane rejects it
        reqs[3].transfers[0].signatures[0] = reqs[1].transfers[0].signatures[0]
        return reqs

    envs, raws = build_both("fabtoken", scenario)
    host_sign_plane(monkeypatch)
    nets = networks(envs, max_block_txs=8, sign_batched=True, sign_min_batch=2)
    rows0, batches0 = counter(PORT, "batch.sign.rows"), counter(PORT, "batch.sign.batches")
    fb0 = counter(PORT, "batch.sign.host_fallbacks")
    submit_both(nets, raws[0])  # the issuer's signature: one row < sign_min_batch
    got = submit_many_both(nets, raws[1:])
    assert [s for _, s, _ in got] == [VALID, VALID, INVALID]
    assert "rejected by the batched signature plane" in got[2][2]
    assert counter(PORT, "batch.sign.batches") - batches0 == 1
    assert counter(PORT, "batch.sign.rows") - rows0 == 3
    assert counter(PORT, "batch.sign.host_fallbacks") == fb0
    assert_same_ledger(nets)
    host = networks(envs, max_block_txs=8, sign_batched=False)
    submit_both(host, raws[0])
    host_got = submit_many_both(host, raws[1:])
    assert [s for _, s, _ in host_got] == [s for _, s, _ in got]
    assert host_got[2][2].startswith("invalid owner signature")


# ------------------------------------------------------------------ commit loop, persistence

def test_transient_internal_error_is_not_cached():
    """A non-ValidationError fault fails the ATTEMPT but is never recorded
    as a durable rejection: an identical resubmission can succeed."""
    envs, raws = build_both("fabtoken", lambda e: [
        e.issue("seed", [5]), e.transfer("flaky", [("seed", 0)], [5])])
    nets = networks(envs)
    submit_both(nets, raws[0])
    for root, net in nets.items():
        orig = net.validator.validate
        calls = {"n": 0}

        def flaky(*args, _orig=orig, _calls=calls, **kwargs):
            if _calls["n"] == 0:
                _calls["n"] += 1
                raise MemoryError("transient fault")
            return _orig(*args, **kwargs)

        net.validator.validate = flaky
    ev1 = submit_both(nets, raws[1])
    assert ev1[1] == INVALID and "internal validation error" in ev1[2]
    assert nets[PORT.root].status("flaky") is None  # nothing durable recorded
    assert submit_both(nets, raws[1])[1] == VALID
    assert_same_ledger(nets)


def test_listener_exception_does_not_abort_commit():
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [5])])
    nets = networks(envs)
    net = nets[PORT.root]
    seen = []

    def boom(event, request):
        raise RuntimeError("listener crashed")

    net.subscribe(boom)
    net.subscribe(lambda e, r: seen.append(e.tx_id))
    before = counter(PORT, "ledger.listener.errors")
    assert submit_both(nets, raws[0])[1] == VALID
    assert counter(PORT, "ledger.listener.errors") - before == 1
    assert seen == ["seed"]  # listeners AFTER the crasher still ran
    assert_same_ledger(nets)


def test_block_cut_policy_and_snapshot_restore():
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [1, 2, 3, 4, 5])] + [
        e.transfer(f"cut-{v}", [("seed", v - 1)], [v]) for v in (1, 2, 3, 4, 5)])
    nets = networks(envs, max_block_txs=2)
    submit_both(nets, raws[0])
    got = submit_many_both(nets, raws[1:])
    assert all(s == VALID for _, s, _ in got)
    view = assert_same_ledger(nets)
    assert view["height"] == 4  # seed + 2 + 2 + 1
    assert [len(t) for t in view["blocks_api"][1:]] == [2, 2, 1]
    restored = {P.root: P.services_network.Network.restore(
        envs[P.root].validator(), nets[P.root].snapshot(), policy=policy(P),
        **({"device": "cpu"} if P is PORT else {})) for P in (REF, PORT)}
    assert assert_same_ledger(restored) == view
    assert restored[PORT.root].status("cut-3").status.value == VALID


def test_concurrent_submitters_group_commit():
    """Concurrent submitters race for the commit lock; every tx lands in
    exactly one block and all commit."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("seed", [2, 2, 2, 2])] + [
        e.transfer(f"par-{i}", [("seed", i)], [2]) for i in range(4)])
    net = networks(envs)[PORT.root]
    assert net.submit(raws[0]).status.value == VALID
    results = []
    barrier = threading.Barrier(4)

    def worker(rb):
        barrier.wait()
        results.append(net.submit(rb))

    threads = [threading.Thread(target=worker, args=(rb,)) for rb in raws[1:]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(e.status.value == VALID for e in results)
    committed = [tx for i in range(1, net.height()) for tx in net.block(i).txs]
    assert sorted(committed) == [f"par-{i}" for i in range(4)]
    # the same requests, sequentially, on the JAX ledger: the same state
    ref = networks(envs)[REF.root]
    assert events([ref.submit(rb) for rb in raws]) == events(
        [net.status(a) for a in ["seed"] + [f"par-{i}" for i in range(4)]])
    ref_state = REF.crypto_serialization.loads(ref.snapshot())
    port_state = PORT.crypto_serialization.loads(net.snapshot())
    assert (ref_state["state"], ref_state["spent"]) == (port_state["state"], port_state["spent"])
