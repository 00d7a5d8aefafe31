"""PyTorch port, the pipelined prove-and-submit client (`services/ttx/
pipeline.py`) against the JAX package.

Port mirrors of `tests/test_pipeline.py:460` and `:497`: while group k
is in flight (a slow commit), the caller already builds group k+1, the
results come back in builder order and the overlap gauge moves; a
`Backpressure` from the network is retried inside the submit worker.
Both run the same builders in both packages and compare the finality
events. Then the batched client path itself on the port (CPU, the plain
versions): groups whose builder selects by alice's selector and proves
the group with one `transfer_many` commit one block each, and a failed
plane on the card stops the pipeline with `DevicePlaneError`.
"""

import random
import time

import pytest
import torch

from torch_ttx_cases import (
    PORT, REF, build_env, event_of, mod, setup_both, transfer_group,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    for P in (REF, PORT):
        mod(P, "utils.faults").clear()


def ctr(P, name):
    return mod(P, "utils.metrics").REGISTRY.counter(name).value


def issue_builder(env, gi, n=2, delay=0.0):
    """A builder of n issues to alice (tx ids ps-gi-j), after `delay`
    seconds that stand for the prove work."""
    ttx = mod(env["P"], "services.ttx")

    def build():
        time.sleep(delay)
        out = []
        for j in range(n):
            t = ttx.Transaction(env["parties"]["issuer-node"], f"ps-{gi}-{j}")
            t.issue("issuer", "USD", [1 + gi], [env["alice"].recipient_identity()],
                    anonymous=False)
            t.collect_endorsements(env["auditor"])
            out.append(t.request.to_bytes())
        return out

    return build


def test_pipelined_submitter_overlaps_prove_with_submit_like_reference():
    got = {}
    for P in (REF, PORT):
        env = build_env(P, "fabtoken", policy={"max_block_txs": 8})
        groups0 = ctr(P, "ttx.pipeline.groups")
        faults = mod(P, "utils.faults")
        faults.arm("ledger.commit_block", "delay", delay_s=0.1)
        try:
            results = mod(P, "services.ttx").PipelinedSubmitter(env["network"]).run(
                [issue_builder(env, i, delay=0.05) for i in range(3)])
        finally:
            faults.clear()
        assert ctr(P, "ttx.pipeline.groups") - groups0 == 3
        assert mod(P, "utils.metrics").REGISTRY.gauge("ttx.pipeline.overlap_frac").value > 0
        got[P] = ([[event_of(e) for e in events] for events in results],
                  env["network"].height(), env["parties"]["alice-node"].balance("USD"))
    assert got[PORT] == got[REF]
    events, height, balance = got[PORT]
    assert [[e[0] for e in g] for g in events] == [[f"ps-{i}-{j}" for j in range(2)]
                                                   for i in range(3)]
    assert all(e[1] == "Valid" for g in events for e in g)
    assert height == 3 and balance == 2 * (1 + 2 + 3)


def test_pipelined_submitter_retries_backpressure_like_reference():
    got = {}
    for P in (REF, PORT):
        env = build_env(P, "fabtoken", policy={"max_block_txs": 8})
        network = env["network"]
        calls = {"n": 0}
        real = network.submit_many

        def flaky(requests, real=real, calls=calls, P=P):
            calls["n"] += 1
            if calls["n"] == 1:
                raise mod(P, "services.network").Backpressure("synthetic queue-full")
            return real(requests)

        network.submit_many = flaky
        bp0 = ctr(P, "ttx.pipeline.backpressure")
        results = mod(P, "services.ttx").pipelined_submit(network, [issue_builder(env, 0, n=1)],
                                                           backoff_s=0.01)
        got[P] = ([event_of(e) for e in results[0]], ctr(P, "ttx.pipeline.backpressure") - bp0,
                  calls["n"])
    assert got[PORT] == got[REF] == ([("ps-0-0", "Valid", "")], 1, 2)


@pytest.fixture(scope="module")
def zk_pp():
    return setup_both()[PORT]


def _zk_env(zk_pp, values):
    env = build_env(PORT, "zkatdlog", zk_pp, policy={"max_block_txs": 8})
    ttx = mod(PORT, "services.ttx")
    tx = ttx.Transaction(env["parties"]["issuer-node"], "seed")
    tx.issue("issuer", "USD", values, [env["alice"].recipient_identity()] * len(values),
             anonymous=False)
    tx.collect_endorsements(env["auditor"])
    tx.submit()
    return env


def _group_builder(env, rng, gi, n):
    alice_p = env["parties"]["alice-node"]

    def build():
        txs = transfer_group(alice_p, env["auditor"], [
            (f"g{gi}-{j}", [5], [env["bob"].recipient_identity()]) for j in range(n)], rng)
        return [tx.request.to_bytes() for tx in txs]

    return build


def test_transfer_many_groups_commit_one_block_each(zk_pp):
    """Two groups, each selected by alice's selector and proved by one
    `transfer_many` through the batched prover (`device="cpu"`), through
    `pipelined_submit`: one block a group, every request valid on the
    batched plane, the proofs accepted by the JAX package's host
    verifier, balances and ttxdb statuses exact, nothing left locked."""
    env = _zk_env(zk_pp, [5] * 4)
    net, alice_p, bob_p = env["network"], env["parties"]["alice-node"], env["parties"]["bob-node"]
    loads = mod(PORT, "crypto.serialization").loads
    before = loads(net.snapshot())["state"]
    rng = random.Random(9)
    raws = []

    def kept(build):
        def run():
            out = build()
            raws.extend(out)
            return out
        return run

    prove0, batched0 = ctr(PORT, "batch.prove.txs"), ctr(PORT, "ledger.validate.batched")
    results = mod(PORT, "services.ttx").pipelined_submit(
        net, [kept(_group_builder(env, rng, gi, 2)) for gi in range(2)])
    assert [[(e.tx_id, e.status.value) for e in g] for g in results] == [
        [(f"g{gi}-{j}", "Valid") for j in range(2)] for gi in range(2)]
    assert ctr(PORT, "batch.prove.txs") - prove0 == 4
    assert ctr(PORT, "ledger.validate.batched") - batched0 == 4
    assert net.height() == 3
    assert (alice_p.balance("USD"), bob_p.balance("USD")) == (0, 20)
    ids = [f"g{gi}-{j}" for gi in range(2) for j in range(2)]
    assert [alice_p.db.status(t) for t in ids] == ["Confirmed"] * 4
    assert [env["auditor"].db.status(t) for t in ids] == ["Confirmed"] * 4
    assert alice_p.selectors.locker.locked_count() == 0
    # the batched prover's requests pass the JAX package's host validation
    ref_pp = setup_both()[REF]
    validator = mod(REF, "api.validator").RequestValidator(
        mod(REF, "drivers.zkatdlog").ZKATDLogDriver(ref_pp), env["auditor"].identity)
    TokenRequest = mod(REF, "api.request").TokenRequest
    for raw in raws:
        res = validator.validate(TokenRequest.from_bytes(raw), lambda i: before[i.key()])
        assert len(res.spent) == 1 and len(res.outputs) == 1


def test_device_plane_error_stops_the_pipeline(zk_pp, monkeypatch):
    """On the card a failed proof plane fails the first group's block: the
    pipeline stops, `DevicePlaneError` reaches the caller, and nothing of
    either group commits (the second group may have been built while the
    first was in flight; it is never submitted)."""
    env = _zk_env(zk_pp, [5] * 4)
    net = env["network"]
    monkeypatch.setattr(net._pipeline, "device", torch.device("cuda"))
    monkeypatch.setattr(net._pipeline, "_load_kernels", lambda: None)
    built = []
    rng = random.Random(9)

    def builder(gi):
        inner = _group_builder(env, rng, gi, 2)

        def build():
            built.append(gi)
            return inner()

        return build

    faults = mod(PORT, "utils.faults")
    faults.arm("batch.verify", "error", count=1)
    with pytest.raises(mod(PORT, "services.network").DevicePlaneError):
        mod(PORT, "services.ttx").pipelined_submit(net, [builder(0), builder(1)])
    faults.clear()
    mod(PORT, "utils.resilience").reset()
    assert net.height() == 1 and net.status("g0-0") is None and net.status("g1-0") is None
    assert env["parties"]["alice-node"].balance("USD") == 20
    assert built in ([0], [0, 1])  # group 1 may be built while group 0 is in flight


def test_pipelined_submit_over_the_wire_retries_backpressure_exactly_once():
    """`pipelined_submit` over a port `RemoteNetwork` to a
    `LedgerServer(network=...)` on the CPU: three groups of two issues,
    the second refused once with `Backpressure` by the node (before
    ordering, over the wire as `error_class` "Backpressure") and retried
    by the submit worker. The events, height, statuses and alice's
    balance equal the same builders run against the in-process
    `Network`, and the refused group commits exactly once: one block a
    group, each tx id once in the ledger."""
    remote = mod(PORT, "services.network.remote")
    got = {}
    for where in ("in-process", "wire"):
        env = build_env(PORT, "fabtoken", policy={"max_block_txs": 8})
        builders = [issue_builder(env, i) for i in range(3)]
        net = env["network"]
        if where == "in-process":
            results = mod(PORT, "services.ttx").pipelined_submit(net, builders, backoff_s=0.01)
        else:
            # the node enqueues a wire batch request by request: refusing
            # the second group's first request refuses the whole group
            # before any of it is ordered, as a full ordering queue does
            calls = {"n": 0}
            real = net.submit_request_cooperative

            def refuse_second_group_once(request, real=real, calls=calls):
                calls["n"] += 1
                if calls["n"] == 3:
                    raise mod(PORT, "services.network").Backpressure("synthetic queue-full")
                return real(request)

            net.submit_request_cooperative = refuse_second_group_once
            server = remote.LedgerServer(network=net).start()
            client = remote.RemoteNetwork(server.address)
            bp0 = ctr(PORT, "ttx.pipeline.backpressure")
            wire0 = ctr(PORT, "remote.dispatch.backpressure")
            try:
                results = mod(PORT, "services.ttx").pipelined_submit(client, builders,
                                                                      backoff_s=0.01)
            finally:
                client.close()
                server.stop()
            assert ctr(PORT, "ttx.pipeline.backpressure") - bp0 == 1
            assert ctr(PORT, "remote.dispatch.backpressure") - wire0 == 1
            assert calls["n"] == 7  # three groups of two, the second's first refused once
        ids = [f"ps-{i}-{j}" for i in range(3) for j in range(2)]
        blocks = mod(PORT, "crypto.serialization").loads(net.snapshot())["blocks"]
        got[where] = ([[event_of(e) for e in events] for events in results], net.height(),
                      [event_of(net.status(t)) for t in ids], [b[1] for b in blocks],
                      env["parties"]["alice-node"].balance("USD"))
    assert got["wire"] == got["in-process"]
    events, height, status, block_txs, balance = got["wire"]
    assert all(e[1] == "Valid" for g in events for e in g)
    assert height == 3 and balance == 2 * (1 + 2 + 3)
    assert block_txs == [[f"ps-{i}-{j}" for j in range(2)] for i in range(3)]
