"""PyTorch port, the token transaction services against the JAX package.

Port mirror of `tests/test_services_fungible.py` (the reference's
`integration/token/fungible` suite: issue, audited transfer, redeem,
insufficient funds, replays and double spends, history, balances,
certification, the issuer's value cap) for both drivers, of its
concurrent-selector case, and of the NFT flow of
`tests/test_extras.py:111`. The same scenario runs in each package from
one seed, with explicit tx ids: every wallet, the management services,
the zkatdlog drivers' issue and transfer, the auditor's and the
certifier's signatures draw from seeded rngs, so the two runs must agree
on every request's bytes, every status and message, the balances, the
ttxdb rows of every party and of the auditor (timestamps aside) and the
certifications. The port's `Network` and parties run on `device="cpu"`;
zkatdlog parameters are `setup(base=4, exponent=2)` from one seed in
each package. A lone `submit()` is host-verified by policy in both (a
one-request block is under `BlockPolicy.min_batch`).
"""

import dataclasses
import random
import threading

import pytest
import torch

from torch_ttx_cases import (
    PORT, REF, build_env, db_rows, event_of, mod, seeded, setup_both, transfer_group,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def zk_pps():
    return setup_both()


def fungible_scenario(env, max_value):
    """The reference suite's steps; returns what both packages must agree
    on, having asserted the suite's own expectations."""
    P, network, auditor = env["P"], env["network"], env["auditor"]
    ttx = mod(P, "services.ttx")
    ValidationError = mod(P, "api.driver").ValidationError
    TxStatus = mod(P, "services.network").TxStatus
    issuer_p, alice_p, bob_p = (env["parties"][n] for n in ("issuer-node", "alice-node",
                                                             "bob-node"))
    alice, bob = env["alice"], env["bob"]
    out = {"raw": [], "events": []}

    def run(tx):
        tx.collect_endorsements(auditor)
        out["raw"].append(tx.request.to_bytes())
        out["events"].append(event_of(tx.submit()))

    tx = ttx.Transaction(issuer_p, "tx-issue-1")
    tx.issue("issuer", "USD", [10, 5], [alice.recipient_identity(), alice.recipient_identity()],
             anonymous=False)
    run(tx)
    assert (alice_p.balance("USD"), bob_p.balance("USD")) == (15, 0)
    tx2 = ttx.Transaction(alice_p, "tx-pay-1")
    tx2.transfer("alice", "USD", [7], [bob.recipient_identity()])
    run(tx2)
    assert (alice_p.balance("USD"), bob_p.balance("USD")) == (8, 7)
    tx3 = ttx.Transaction(bob_p, "tx-redeem-1")
    tx3.redeem("bob", "USD", 4)
    run(tx3)
    assert bob_p.balance("USD") == 3
    with pytest.raises(mod(P, "services.selector").InsufficientFunds) as e:
        ttx.Transaction(alice_p, "tx-too-much").transfer("alice", "USD", [100],
                                                         [bob.recipient_identity()])
    out["insufficient"] = str(e.value)

    replay = network.submit(tx2.request.to_bytes())
    assert replay.status == TxStatus.VALID  # the same tx id: deduplicated
    evil = network.submit(dataclasses.replace(tx2.request, anchor="tx-replay").to_bytes())
    assert evil.status == TxStatus.INVALID
    req3 = dataclasses.replace(tx2.request, anchor="tx-replay-2")
    auditor.audit(req3)
    out["raw"].append(req3.to_bytes())
    evil2 = network.submit(req3.to_bytes())
    assert evil2.status == TxStatus.INVALID
    assert "spent" in evil2.message or "exist" in evil2.message
    out["events"] += [event_of(replay), event_of(evil), event_of(evil2)]

    owner_view = mod(P, "services.owner").OwnerService(alice_p.db)
    out["owner"] = (owner_view.transaction_status("tx-pay-1"), owner_view.payments("alice", "USD"),
                    owner_view.holdings("alice", "USD"),
                    [(r.tx_id, r.tx_type, r.amount, r.status) for r in owner_view.history()],
                    [r.tx_id for r in owner_view.history("Confirmed")])
    assert out["owner"][:2] == ("Confirmed", 7)
    q = mod(P, "services.query").QueryService(bob_p.vault)
    out["query"] = (q.balances_by_type(), q.balance("USD"),
                    sorted((t.id.key(), t.quantity) for t in q.all_my_tokens()))
    assert out["query"][0] == {"USD": 3}

    cert_svc = mod(P, "services.certifier").CertificationService(network, rng=env["rng"])
    bob_ids = bob_p.vault.token_ids()
    cert_svc.certify_into(bob_p.vault, bob_ids[0])
    cert = bob_p.vault.certification(bob_ids[0])
    assert cert is not None
    cert_svc.verify(bob_ids[0], network.resolve_input(bob_ids[0]), cert)
    with pytest.raises(ValidationError) as e:
        cert_svc.certify(mod(P, "models.token").ID("tx-issue-1", 0))  # spent
    out["cert"] = (bob_ids[0].key(), cert, cert_svc.public_key.to_bytes(), str(e.value))

    assert auditor.db.status("tx-pay-1") == "Confirmed"
    assert auditor.db.status("tx-redeem-1") == "Confirmed"
    assert [r.amount for r in auditor.db.transactions() if r.tx_id == "tx-redeem-1"] == [7]

    with pytest.raises(ValueError) as e:
        ttx.Transaction(issuer_p, "tx-over").issue("issuer", "USD", [max_value + 1],
                                                   [alice.recipient_identity()], anonymous=False)
    out["over"] = str(e.value)
    out["balances"] = {n: p.balance("USD") for n, p in env["parties"].items()}
    out["tokens"] = {n: [i.key() for i in p.vault.token_ids()] for n, p in env["parties"].items()}
    out["dbs"] = {n: db_rows(p.db) for n, p in env["parties"].items()}
    out["auditor_db"] = db_rows(auditor.db)
    out["height"] = network.height()
    return out


def both(kind, zk_pps=None):
    got = {}
    for P in (REF, PORT):
        env = build_env(P, kind, None if zk_pps is None else zk_pps[P])
        max_value = (1 << 64) - 1 if kind == "fabtoken" else zk_pps[P].max_token_value()
        got[P] = fungible_scenario(env, max_value)
    assert got[PORT]["raw"] == got[REF]["raw"]  # byte-identical requests
    for key in got[REF]:
        assert got[PORT][key] == got[REF][key], key
    return got[PORT]


def test_fabtoken_fungible_suite_like_reference():
    out = both("fabtoken")
    assert out["balances"] == {"issuer-node": 0, "alice-node": 8, "bob-node": 3}
    assert out["events"][-2][1] == "Invalid" and out["height"] == 5


def test_zkatdlog_fungible_suite_like_reference(zk_pps):
    out = both("zkatdlog", zk_pps)
    assert out["balances"] == {"issuer-node": 0, "alice-node": 8, "bob-node": 3}
    assert [e[1] for e in out["events"]] == ["Valid"] * 4 + ["Invalid"] * 2
    assert out["auditor_db"][0][2][:2] == ("tx-redeem-1", "Redeem")


def test_concurrent_transfers_selector():
    """Two threads transferring from one wallet never double-select: both
    transfers commit (6 + 6), nothing stays locked."""
    env = build_env(PORT, "fabtoken")
    ttx = mod(PORT, "services.ttx")
    issuer_p, alice_p, bob_p = (env["parties"][n] for n in ("issuer-node", "alice-node",
                                                             "bob-node"))
    tx = ttx.Transaction(issuer_p, "seed")
    tx.issue("issuer", "USD", [6, 6], [env["alice"].recipient_identity()] * 2, anonymous=False)
    tx.collect_endorsements(env["auditor"])
    tx.submit()
    results = []

    def worker(n):
        t = ttx.Transaction(alice_p, f"c-{n}")
        try:
            t.transfer("alice", "USD", [6], [env["bob"].recipient_identity()])
            t.collect_endorsements(env["auditor"])
            t.submit()
            results.append("ok")
        except Exception as e:  # surfaced below
            results.append(repr(e))

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert results == ["ok", "ok"]
    assert (bob_p.balance("USD"), alice_p.balance("USD")) == (12, 0)
    assert alice_p.selectors.locker.locked_count() == 0


def nft_scenario(P, monkeypatch):
    """The reference NFT flow with seeded keys and uuids."""
    rng = random.Random(3)
    uuids = iter(f"{i:032x}" for i in range(1, 100))
    monkeypatch.setattr(mod(P, "services.nfttx.nft").uuid_mod, "uuid4",
                        lambda: type("U", (), {"hex": next(uuids)})())
    fab = mod(P, "drivers.fabtoken")
    pp = fab.FabTokenPublicParams()
    aw = seeded(mod(P, "api.wallet").AuditorWallet("auditor", mod(P, "crypto.sign").keygen(rng)),
                rng)
    kw = {"device": "cpu"} if P == PORT else {}
    net = mod(P, "services.network").Network(
        mod(P, "api.validator").RequestValidator(fab.FabTokenDriver(pp), aw.identity), **kw)
    auditor = mod(P, "services.auditor").AuditorService(fab.FabTokenDriver(pp), aw)
    net.subscribe(auditor.on_finality)
    Party = mod(P, "services.ttx").Party
    issuer_p, alice_p, bob_p = (Party(n, fab.FabTokenDriver(pp), net, aw.identity, rng=rng)
                                for n in ("issuer", "alice", "bob"))
    iw = issuer_p.new_issuer_wallet("issuer")
    pp.add_issuer(iw.identity)
    alice = alice_p.new_owner_wallet("alice", False)
    bob = bob_p.new_owner_wallet("bob", False)
    NFTService = mod(P, "services.nfttx").NFTService
    state = {"artist": "banksy", "work": "ttx #1"}
    token_type = NFTService(issuer_p).issue("issuer", state, alice.recipient_identity(), auditor,
                                            tx_id="nft-issue")
    alice_nft = NFTService(alice_p)
    seen = [token_type, alice_nft.my_nfts(), alice_nft.state_matches(token_type, state),
            alice_nft.state_matches(token_type, {"artist": "unknown", "work": "x"})]
    alice_nft.transfer("alice", token_type, bob.recipient_identity(), auditor, tx_id="nft-xfer")
    seen += [alice_nft.my_nfts(), NFTService(bob_p).my_nfts(),
             [net.status(t) and event_of(net.status(t)) for t in ("nft-issue", "nft-xfer")],
             db_rows(auditor.db), {p.name: db_rows(p.db) for p in (issuer_p, alice_p, bob_p)},
             net.snapshot()]
    return seen


def test_nft_flow_like_reference(monkeypatch):
    got = {P: nft_scenario(P, monkeypatch) for P in (REF, PORT)}
    # the ledger snapshots hold the committed request outputs and the
    # block timestamps: compare everything but the timestamps
    for P in got:
        d = mod(P, "crypto.serialization").loads(got[P][-1])
        got[P][-1] = (d["state"], d["spent"], [b[:2] for b in d["blocks"]], d["status"])
    assert got[PORT] == got[REF]
    token_type, mine, ok, bad, after, bobs = got[PORT][:6]
    assert token_type.startswith("nft.") and mine == [token_type] and ok and not bad
    assert after == [] and bobs == [token_type]


def _issue(env, anchor, values):
    tx = mod(env["P"], "services.ttx").Transaction(env["parties"]["issuer-node"], anchor)
    tx.issue("issuer", "USD", values, [env["alice"].recipient_identity()] * len(values),
             anonymous=False)
    tx.collect_endorsements(env["auditor"])
    return tx.submit()


def _transfers(env, tag, n, value=5):
    """n 1-in/1-out transfers of `value` from alice to bob, each proved on
    the host by `Transaction.transfer`, endorsed, not submitted."""
    ttx = mod(env["P"], "services.ttx")
    out = []
    for i in range(n):
        tx = ttx.Transaction(env["parties"]["alice-node"], f"{tag}-{i}")
        tx.transfer("alice", "USD", [value], [env["bob"].recipient_identity()])
        tx.collect_endorsements(env["auditor"])
        out.append(tx)
    return out


def test_group_reaches_the_batched_plane_as_one_block(zk_pps):
    """A lone `submit()` is a one-request block, verified on the host by
    policy; `submit_async` of a group then one `wait()` commits the group
    as one block through the batched proof plane (the port's on the CPU
    through the plain versions, the JAX ledger's served by its host
    verifier): the same bytes, statuses, balances and ttxdb rows."""
    got = {}
    for P in (REF, PORT):
        env = build_env(P, "zkatdlog", zk_pps[P], policy={"max_block_txs": 8})
        mx = mod(P, "utils.metrics")
        c0 = {k: mx.REGISTRY.counter(k).value for k in ("ledger.validate.host",
                                                          "ledger.validate.batched")}
        seen = [event_of(_issue(env, "seed", [5, 5, 5, 5]))]
        seen.append(event_of(_transfers(env, "lone", 1)[0].submit()))
        txs = _transfers(env, "grp", 3)
        c1 = {k: mx.REGISTRY.counter(k).value for k in c0}
        for tx in txs:
            tx.submit_async()
        seen += [event_of(tx.wait()) for tx in txs]
        c2 = {k: mx.REGISTRY.counter(k).value for k in c0}
        seen += [[tx.request.to_bytes() for tx in txs], env["network"].height(),
                 {n: p.balance("USD") for n, p in env["parties"].items()},
                 {n: db_rows(p.db) for n, p in env["parties"].items()}, db_rows(env["auditor"].db),
                 env["parties"]["alice-node"].selectors.locker.locked_count()]
        got[P] = seen
        if P == PORT:
            assert {k: c1[k] - c0[k] for k in c0} == {"ledger.validate.host": 1,
                                                      "ledger.validate.batched": 0}
            assert {k: c2[k] - c1[k] for k in c0} == {"ledger.validate.host": 0,
                                                      "ledger.validate.batched": 3}
    assert got[PORT] == got[REF]
    assert [e[1] for e in got[PORT][:5]] == ["Valid"] * 5
    assert got[PORT][6] == 3  # the seed's block, the lone transfer's, the group's
    assert got[PORT][7] == {"issuer-node": 0, "alice-node": 0, "bob-node": 20}
    assert got[PORT][-1] == 0


@pytest.mark.parametrize("kind, issued, amounts", [
    ("fabtoken", [7, 5], [5, 3]),  # each takes one input and a change output
    ("zkatdlog", [5, 5], [5, 5]),  # 1-in/1-out: the plain versions stay quick
])
def test_transfer_group_like_hand_built_reference(kind, issued, amounts, zk_pps):
    """The port's `Transaction.transfer_group` (the inputs by alice's
    selector, one `transfer_many` over the group, the endorsements) builds
    the requests and ttxdb rows that the same steps taken by hand build in
    the JAX package, which has no such helper; the group then commits as
    one block with the same statuses, balances and auditor rows."""
    got = {}
    for P in (REF, PORT):
        env = build_env(P, kind, zk_pps[P], policy={"max_block_txs": 8})
        _issue(env, "seed", issued)
        alice_p = env["parties"]["alice-node"]
        txs = transfer_group(alice_p, env["auditor"], [
            (f"grp-{i}", [v], [env["bob"].recipient_identity()])
            for i, v in enumerate(amounts)], random.Random(5))
        seen = [[tx.request.to_bytes() for tx in txs], db_rows(alice_p.db),
                alice_p.selectors.locker.locked_count()]
        for tx in txs:
            tx.submit_async()
        seen += [[event_of(tx.wait()) for tx in txs], env["network"].height(),
                 {n: p.balance("USD") for n, p in env["parties"].items()},
                 {n: db_rows(p.db) for n, p in env["parties"].items()}, db_rows(env["auditor"].db),
                 alice_p.selectors.locker.locked_count()]
        got[P] = seen
    assert got[PORT] == got[REF]
    assert got[PORT][2] == len(amounts)  # locked until finality
    assert [e[1] for e in got[PORT][3]] == ["Valid"] * len(amounts)
    assert got[PORT][4] == 2 and got[PORT][-1] == 0
    assert got[PORT][5]["bob-node"] == sum(amounts)
    assert got[PORT][5]["alice-node"] == sum(issued) - sum(amounts)


def test_transfer_group_unlocks_its_inputs_when_proving_fails(monkeypatch):
    """A group whose `transfer_many` raises, or whose last transaction
    finds every token held (by the group itself), leaves nothing locked and no new ttxdb row, and the
    error reaches the caller; the same tokens then go
    into a group that commits."""
    env = build_env(PORT, "fabtoken", policy={"max_block_txs": 8})
    _issue(env, "seed", [5, 5])
    alice_p, bob = env["parties"]["alice-node"], env["bob"]
    Transaction = mod(PORT, "services.ttx").Transaction

    def down(*args, **kwargs):
        raise RuntimeError("prover down")

    rows = db_rows(alice_p.db)
    monkeypatch.setattr(alice_p.driver, "transfer_many", down)
    with pytest.raises(RuntimeError, match="prover down"):
        Transaction.transfer_group(alice_p, "alice", "USD", [
            (f"bad-{i}", [5], [bob.recipient_identity()]) for i in range(2)], env["auditor"])
    assert alice_p.selectors.locker.locked_count() == 0
    assert db_rows(alice_p.db) == rows
    monkeypatch.undo()
    with pytest.raises(mod(PORT, "services.selector").SelectorTimeout):  # held by the group
        Transaction.transfer_group(alice_p, "alice", "USD", [
            (f"short-{i}", [5], [bob.recipient_identity()]) for i in range(3)], env["auditor"])
    assert alice_p.selectors.locker.locked_count() == 0
    assert db_rows(alice_p.db) == rows
    txs = Transaction.transfer_group(alice_p, "alice", "USD", [
        (f"ok-{i}", [5], [bob.recipient_identity()]) for i in range(2)], env["auditor"])
    for tx in txs:
        tx.submit_async()
    assert [tx.wait().status.value for tx in txs] == ["Valid", "Valid"]
    assert (alice_p.balance("USD"), env["parties"]["bob-node"].balance("USD")) == (0, 10)
    assert alice_p.selectors.locker.locked_count() == 0


def test_device_plane_error_reaches_wait_and_keeps_the_locks(zk_pps, monkeypatch):
    """On the card a batched plane that fails fails the block: `wait()`
    raises `DevicePlaneError`, nothing commits, no row is verified on the
    host, and the transactions keep their inputs locked and their ttxdb
    rows Pending, so they can be submitted again; they then commit. The
    card's rule is run here by reading the pipeline's device as CUDA, as
    `tests/test_torch_device_failure.py` does."""
    import torch as _torch

    env = build_env(PORT, "zkatdlog", zk_pps[PORT], policy={"max_block_txs": 8})
    net, alice_p = env["network"], env["parties"]["alice-node"]
    _issue(env, "seed", [5, 5])
    txs = _transfers(env, "card", 2)
    pipe = net._pipeline
    monkeypatch.setattr(pipe, "device", _torch.device("cuda"))
    monkeypatch.setattr(pipe, "_load_kernels", lambda: None)
    faults, mx = mod(PORT, "utils.faults"), mod(PORT, "utils.metrics")
    host0 = mx.REGISTRY.counter("ledger.validate.host").value
    faults.arm("batch.verify", "error", count=1)
    try:
        for tx in txs:
            tx.submit_async()
        with pytest.raises(mod(PORT, "services.network").DevicePlaneError):
            txs[0].wait()
        with pytest.raises(mod(PORT, "services.network").DevicePlaneError):
            txs[1].wait()
    finally:
        faults.clear()
    assert net.height() == 1 and [net.status(tx.tx_id) for tx in txs] == [None, None]
    assert mx.REGISTRY.counter("ledger.validate.host").value == host0
    assert alice_p.selectors.locker.locked_count() == 2
    assert [alice_p.db.status(tx.tx_id) for tx in txs] == ["Pending", "Pending"]
    assert alice_p.balance("USD") == 10
    mod(PORT, "utils.resilience").reset()
    for tx in txs:
        tx.submit_async()
    assert [tx.wait().status.value for tx in txs] == ["Valid", "Valid"]
    assert net.height() == 2 and alice_p.selectors.locker.locked_count() == 0
    assert [alice_p.db.status(tx.tx_id) for tx in txs] == ["Confirmed", "Confirmed"]
    assert (alice_p.balance("USD"), env["parties"]["bob-node"].balance("USD")) == (0, 10)
