"""Shared cases of the port's ttx tests (`tests/test_torch_ttx.py`,
`tests/test_torch_ttx_pipeline.py`).

`build_env(P, kind)` builds one auditor, an issuer party, alice and bob
on a shared `Network` of package P (the port's on `device="cpu"`) from
one seed: every wallet key, the management services, the zkatdlog
drivers' issue and transfer and the auditor's signatures draw from the
same seeded rng, so one scenario run in both packages builds
byte-identical requests. `transfer_group` is the batched client path a
`PipelinedSubmitter` builder runs: the port's `Transaction.transfer_group`,
and for the JAX package, which has no such helper, the same steps by
hand (each transaction's inputs by the sender's selector, the whole
group proved by one `driver.transfer_many`, then the owner signatures
and the audit).
"""

import functools
import importlib
import random

from torch_network_cases import HostTransferVerifier

REF, PORT = "fabric_token_sdk_tpu", "fabric_token_sdk_tpu_torch"
SETUP_SEED = 0xF75


def mod(P, name):
    return importlib.import_module(f"{P}.{name}")


def setup_both():
    """zkatdlog public parameters of both packages, from one seed."""
    return {P: mod(P, "crypto.setup").setup(base=4, exponent=2, rng=random.Random(SETUP_SEED))
            for P in (REF, PORT)}


def seeded(wallet, rng):
    """Bind `rng` into a long-term wallet's signatures (the auditor signs
    with none)."""
    wallet.sign = functools.partial(type(wallet).sign, wallet, rng=rng)
    return wallet


def make_driver(P, kind, pp, rng):
    if kind == "fabtoken":
        return mod(P, "drivers.fabtoken").FabTokenDriver(pp)
    kw = {"device": "cpu"} if P == PORT else {}
    drv = mod(P, "drivers.zkatdlog").ZKATDLogDriver(pp, **kw)
    if rng is not None:  # the management service passes the driver no rng
        drv.issue = functools.partial(drv.issue, rng=rng)
        drv.transfer = functools.partial(drv.transfer, rng=rng)
    return drv


def build_env(P, kind, zk_pp=None, seed=11, policy=None):
    """One auditor, an issuer party, alice and bob on a shared `Network`
    of package P (the port's on the CPU); alice and bob are nym owners
    for zkatdlog, as in the reference suite."""
    rng = random.Random(seed)
    pp = mod(P, "drivers.fabtoken").FabTokenPublicParams() if kind == "fabtoken" else zk_pp
    mk = functools.partial(make_driver, P, kind, pp, rng)
    aw = seeded(mod(P, "api.wallet").AuditorWallet("auditor", mod(P, "crypto.sign").keygen(rng)),
                rng)
    auditor = mod(P, "services.auditor").AuditorService(mk(), aw)
    kw = {"device": "cpu"} if P == PORT else {}
    if policy is not None:
        kw["policy"] = mod(P, "services.network").BlockPolicy(**policy)
    vdriver = make_driver(P, kind, pp, None)
    if P == REF and kind == "zkatdlog":
        # the JAX ledger's proof plane served by its host verifier: no XLA
        # compile here, the same verdicts (`torch_network_cases`)
        plane = HostTransferVerifier(pp)
        vdriver.batch_verifier = lambda mesh=None: plane
    network = mod(P, "services.network").Network(
        mod(P, "api.validator").RequestValidator(vdriver, aw.identity), **kw)
    network.subscribe(auditor.on_finality)
    Party = mod(P, "services.ttx").Party
    parties = {name: Party(name, mk(), network, auditor_identity=aw.identity, rng=rng)
               for name in ("issuer-node", "alice-node", "bob-node")}
    issuer = parties["issuer-node"].new_issuer_wallet("issuer")
    nym = zk_pp.nym_params if kind == "zkatdlog" else None
    alice = parties["alice-node"].new_owner_wallet("alice", anonymous=nym is not None,
                                                   nym_params=nym)
    bob = parties["bob-node"].new_owner_wallet("bob", anonymous=nym is not None, nym_params=nym)
    pp.add_issuer(issuer.identity)
    return dict(P=P, rng=rng, network=network, auditor=auditor, parties=parties, issuer=issuer,
                alice=alice, bob=bob)


def db_rows(db):
    conn = db._conn
    return ([r[:7] for r in conn.execute("SELECT * FROM transactions ORDER BY rowid")],
            list(conn.execute("SELECT * FROM movements ORDER BY rowid")))


def event_of(e):
    return (e.tx_id, e.status.value, e.message)


def transfer_group(party, auditor, txs, rng, wallet="alice", token_type="USD"):
    """`txs`: (tx_id, values, recipients) a transaction. Returns the
    Transactions, endorsed, their requests holding one transfer each
    (inputs by `party`'s selector, change back to `wallet`), all proved
    by one `transfer_many` on the party driver's device."""
    P = type(party).__module__.split(".")[0]
    ttx = mod(P, "services.ttx")
    if P == PORT:
        return ttx.Transaction.transfer_group(party, wallet, token_type, txs, auditor, rng)
    ttxdb = mod(P, "services.ttxdb.db")
    TransferRecord = mod(P, "api.request").TransferRecord
    made, specs = [], []
    for tx_id, values, recipients in txs:
        tx = ttx.Transaction(party, tx_id)
        amount = sum(values)
        ids, total = party.selectors.new_selector(tx_id).select(amount, token_type)
        values, recipients = list(values), list(recipients)
        if total > amount:
            values.append(total - amount)
            recipients.append(party.wallets.owner_wallet(wallet).recipient_identity())
        tokens, metas = party.vault.get_many(ids)
        specs.append((ids, tokens, metas, token_type, values, recipients))
        made.append((tx, amount))
    outcomes = party.driver.transfer_many(specs, rng=rng, min_batch=1)
    for (tx, amount), spec, out in zip(made, specs, outcomes):
        ids, tokens, _, _, _, recipients = spec
        tx.request.transfers.append(TransferRecord(
            action=out.action_bytes, input_ids=list(ids),
            senders=[party.driver.output_owner(raw) for raw in tokens],
            outputs_metadata=out.metadata, receivers=list(recipients)))
        party.db.add_transaction(tx.tx_id, ttxdb.TxType.TRANSFER, wallet, "", token_type, amount)
        party.db.add_movement(tx.tx_id, wallet, token_type, amount, ttxdb.MovementDirection.SENT)
        tx.collect_endorsements(auditor)
    return [tx for tx, _ in made]
