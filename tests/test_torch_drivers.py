"""PyTorch port, the token drivers (fabtoken and zkatdlog) with the api,
models and identity layers, against the JAX package.

Port mirrors of `tests/test_drivers.py`; for one seed, the issue,
transfer and redeem requests of both lifecycles byte-identical across
packages, each package's `RequestValidator` accepting the other's and
rejecting the same planted faults; and the zkatdlog driver's batched
planes on `device="cpu"` (the plain torch versions of the kernels):
`transfer_many` byte-identical to the JAX driver's, `transfer_batch_plan`
plus `batch_verifier().verify` verdicts equal to host validation, and
the card as the default device (the mesh binding of `batch_verifier` and
`batch_prover` is `tests/test_torch_mesh_planes.py`'s). Public parameters are
`setup(base=4, exponent=2)` from one seed in each package."""

import functools
import importlib
import random
from types import SimpleNamespace

import pytest
import torch

from fabric_token_sdk_tpu_torch.api.driver import ValidationError
from fabric_token_sdk_tpu_torch.api.request import IssueRecord, TokenRequest, TransferRecord
from fabric_token_sdk_tpu_torch.api.tms import ManagementService
from fabric_token_sdk_tpu_torch.api.wallet import IssuerWallet, OwnerWallet, WalletRegistry
from fabric_token_sdk_tpu_torch.crypto import batch_prove as bp, hostmath as hm, sign
from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wf
from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
from fabric_token_sdk_tpu_torch.crypto.setup import setup
from fabric_token_sdk_tpu_torch.drivers.fabtoken import FabTokenDriver, FabTokenPublicParams
from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
from fabric_token_sdk_tpu_torch.models.token import ID
from fabric_token_sdk_tpu_torch.utils import metrics as mx

torch.set_num_threads(1)

SETUP_SEED = 0xF75


def _package(root):
    mods = ("api.request", "api.tms", "api.validator", "api.wallet", "api.driver",
            "crypto.setup", "crypto.sign", "crypto.token", "drivers.fabtoken",
            "drivers.zkatdlog", "models.token")
    return SimpleNamespace(root=root, **{
        m.replace(".", "_"): importlib.import_module(f"{root}.{m}") for m in mods})


REF = _package("fabric_token_sdk_tpu")
PORT = _package("fabric_token_sdk_tpu_torch")


@pytest.fixture(scope="module")
def zk_pp():
    return setup(base=4, exponent=2, rng=random.Random(SETUP_SEED))


@pytest.fixture(scope="module")
def both_pp():
    return {P.root: P.crypto_setup.setup(base=4, exponent=2, rng=random.Random(SETUP_SEED))
            for P in (REF, PORT)}


def make_ledger(outputs_by_id):
    def resolve(token_id):
        if token_id not in outputs_by_id:
            raise ValidationError(f"unknown input {token_id}")
        return outputs_by_id[token_id]
    return resolve


# ------------------------------------------------------------------ mirrors of test_drivers.py

def run_lifecycle(tms, alice, bob, issuer, anonymous):
    req = tms.new_request("tx1")
    alice_id = alice.recipient_identity()
    tms.add_issue(req, issuer, "USD", [12], [alice_id], anonymous=anonymous)
    tms.sign_issues(req)
    v = tms.validator()
    result = v.validate(req, make_ledger({}))
    (kind, outputs), = result.outputs
    assert kind == "issue" and len(outputs) == 1

    ledger = {ID("tx1", 0): outputs[0]}
    meta = req.issues[0].outputs_metadata

    req2 = tms.new_request("tx2")
    tms.add_transfer(req2, [ID("tx1", 0)], [ledger[ID("tx1", 0)]], meta, "USD", [7, 5],
                     [bob.recipient_identity(), alice.recipient_identity()])
    tms.sign_transfers(req2)
    res2 = v.validate(req2, make_ledger(ledger))
    assert res2.spent == [ID("tx1", 0)]
    (_, outs2), = res2.outputs
    ledger2 = {ID("tx2", 0): outs2[0], ID("tx2", 1): outs2[1]}

    ut = tms.driver.output_to_unspent(ID("tx2", 0), outs2[0], req2.transfers[0].outputs_metadata[0])
    assert ut.type == "USD" and ut.quantity == "7"

    req3 = tms.new_request("tx3")
    tms.add_redeem(req3, [ID("tx2", 0)], [outs2[0]], [req2.transfers[0].outputs_metadata[0]],
                   "USD", 4, 3, bob.recipient_identity())
    tms.sign_transfers(req3)
    res3 = v.validate(req3, make_ledger(ledger2))
    (_, outs3), = res3.outputs
    assert tms.driver.output_owner(outs3[0]) == b""  # redeemed output

    # double spend within one request is rejected
    req4 = tms.new_request("tx4")
    for _ in range(2):
        tms.add_transfer(req4, [ID("tx2", 1)], [outs2[1]], [req2.transfers[0].outputs_metadata[1]],
                         "USD", [5], [bob.recipient_identity()])
    tms.sign_transfers(req4)
    with pytest.raises(ValidationError):
        v.validate(req4, make_ledger(ledger2))

    # wrong signature is rejected
    req5 = tms.new_request("tx5")
    tms.add_transfer(req5, [ID("tx2", 1)], [outs2[1]], [req2.transfers[0].outputs_metadata[1]],
                     "USD", [5], [bob.recipient_identity()])
    tms.sign_transfers(req5)
    req5.transfers[0].signatures[0] = req3.transfers[0].signatures[0]
    with pytest.raises(ValidationError):
        v.validate(req5, make_ledger(ledger2))


def test_fabtoken_lifecycle(rng):
    driver = FabTokenDriver(FabTokenPublicParams())
    alice = OwnerWallet("alice", anonymous=False, rng=rng)
    bob = OwnerWallet("bob", anonymous=False, rng=rng)
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    wallets = WalletRegistry(owners={"alice": alice, "bob": bob}, issuers={"issuer": issuer})
    driver.pp.add_issuer(issuer.identity)
    run_lifecycle(ManagementService(driver, wallets, rng=rng), alice, bob, issuer, anonymous=False)


def test_fabtoken_unauthorized_issuer(rng):
    driver = FabTokenDriver(FabTokenPublicParams())
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    rogue = IssuerWallet("rogue", sign.keygen(rng))
    driver.pp.add_issuer(issuer.identity)
    alice = OwnerWallet("alice", anonymous=False, rng=rng)
    wallets = WalletRegistry(owners={"alice": alice}, issuers={"rogue": rogue})
    tms = ManagementService(driver, wallets, rng=rng)
    req = tms.new_request("tx1")
    tms.add_issue(req, rogue, "USD", [5], [alice.recipient_identity()], anonymous=False)
    tms.sign_issues(req)
    with pytest.raises(ValidationError):
        tms.validator().validate(req, make_ledger({}))


def test_zkatdlog_lifecycle(rng, zk_pp):
    driver = ZKATDLogDriver(zk_pp, device="cpu")
    alice = OwnerWallet("alice", anonymous=True, nym_params=zk_pp.nym_params, rng=rng)
    bob = OwnerWallet("bob", anonymous=True, nym_params=zk_pp.nym_params, rng=rng)
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    wallets = WalletRegistry(owners={"alice": alice, "bob": bob}, issuers={"issuer": issuer})
    run_lifecycle(ManagementService(driver, wallets, rng=rng), alice, bob, issuer, anonymous=True)


def test_zkatdlog_value_out_of_range(rng, zk_pp):
    driver = ZKATDLogDriver(zk_pp)
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    with pytest.raises(ValueError):
        driver.issue(issuer.identity, "USD", [zk_pp.max_token_value() + 1], [b"x"])


def test_issue_authorization_cannot_be_bypassed(rng):
    """Record-level issuer swap / blanking must not bypass the action's
    issuer signature requirement."""
    driver = FabTokenDriver(FabTokenPublicParams())
    issuer = IssuerWallet("issuer", sign.keygen(rng))
    rogue = IssuerWallet("rogue", sign.keygen(rng))
    driver.pp.add_issuer(issuer.identity)
    alice = OwnerWallet("alice", anonymous=False, rng=rng)
    tms = ManagementService(driver, WalletRegistry(owners={"alice": alice},
                                                   issuers={"rogue": rogue}), rng=rng)
    req = tms.new_request("tx1")
    outcome = driver.issue(issuer.identity, "USD", [5], [alice.recipient_identity()],
                           anonymous=False)
    rec = IssueRecord(action=outcome.action_bytes, issuer=rogue.identity,
                      outputs_metadata=outcome.metadata)
    req.issues.append(rec)
    rec.signature = rogue.sign(req.marshal_to_sign(), rng)
    with pytest.raises(ValidationError):
        tms.validator().validate(req, make_ledger({}))
    rec.issuer = b""
    rec.signature = b""
    with pytest.raises(ValidationError):
        tms.validator().validate(req, make_ledger({}))


def test_malformed_action_bytes_rejected():
    driver = FabTokenDriver(FabTokenPublicParams())
    with pytest.raises(ValidationError):
        driver.validate_issue(b"garbage")
    with pytest.raises(ValidationError):
        driver.validate_issue(dumps({"nope": 1}))
    with pytest.raises(ValidationError):
        driver.validate_transfer(dumps({"ids": [["a", 0]], "inputs": [], "outputs": []}),
                                 make_ledger({}), b"", [])


# ------------------------------------------------------------------ across packages

def lifecycle_requests(P, zk_pp, seed):
    """Issue, transfer and redeem requests (and two planted faults) built
    by package P from one seed. Returns [(name, request, ledger, ok)],
    the ledger keyed by (tx_id, index) so either package's IDs resolve."""
    rng = random.Random(seed)
    if zk_pp is None:
        driver = P.drivers_fabtoken.FabTokenDriver(P.drivers_fabtoken.FabTokenPublicParams())
        anonymous = False
        owner = functools.partial(P.api_wallet.OwnerWallet, anonymous=False, rng=rng)
    else:
        driver = P.drivers_zkatdlog.ZKATDLogDriver(zk_pp)
        # the management service passes no rng to the driver: bind one
        driver.issue = functools.partial(driver.issue, rng=rng)
        driver.transfer = functools.partial(driver.transfer, rng=rng)
        anonymous = True
        owner = functools.partial(P.api_wallet.OwnerWallet, anonymous=True,
                                  nym_params=zk_pp.nym_params, rng=rng)
    alice, bob = owner("alice"), owner("bob")
    issuer = P.api_wallet.IssuerWallet("issuer", P.crypto_sign.keygen(rng))
    if zk_pp is None:
        driver.pp.add_issuer(issuer.identity)
    wallets = P.api_wallet.WalletRegistry(owners={"alice": alice, "bob": bob},
                                          issuers={"issuer": issuer})
    tms = P.api_tms.ManagementService(driver, wallets, rng=rng)
    ID_ = P.models_token.ID
    out = []

    req = tms.new_request("tx1")
    tms.add_issue(req, issuer, "USD", [12], [alice.recipient_identity()], anonymous=anonymous)
    tms.sign_issues(req)
    out.append(("issue", req, {}, True))
    issued = loads(req.issues[0].action)["outputs"][0]
    meta = req.issues[0].outputs_metadata

    req2 = tms.new_request("tx2")
    tms.add_transfer(req2, [ID_("tx1", 0)], [issued], meta, "USD", [7, 5],
                     [bob.recipient_identity(), alice.recipient_identity()])
    tms.sign_transfers(req2)
    out.append(("transfer", req2, {("tx1", 0): issued}, True))
    outs2 = loads(req2.transfers[0].action)["outputs"]
    meta2 = req2.transfers[0].outputs_metadata
    ledger2 = {("tx2", 0): outs2[0], ("tx2", 1): outs2[1]}

    req3 = tms.new_request("tx3")
    tms.add_redeem(req3, [ID_("tx2", 0)], [outs2[0]], [meta2[0]], "USD", 4, 3,
                   bob.recipient_identity())
    tms.sign_transfers(req3)
    out.append(("redeem", req3, ledger2, True))

    req4 = tms.new_request("tx4")
    for _ in range(2):
        tms.add_transfer(req4, [ID_("tx2", 1)], [outs2[1]], [meta2[1]], "USD", [5],
                         [bob.recipient_identity()])
    tms.sign_transfers(req4)
    out.append(("double spend", req4, ledger2, False))

    req5 = tms.new_request("tx5")
    tms.add_transfer(req5, [ID_("tx2", 1)], [outs2[1]], [meta2[1]], "USD", [5],
                     [bob.recipient_identity()])
    tms.sign_transfers(req5)
    req5.transfers[0].signatures[0] = req3.transfers[0].signatures[0]
    out.append(("wrong signature", req5, ledger2, False))
    return out, tms


def _verdict(P, tms, raw, ledger):
    """Package P's validator on request bytes: the outputs, or None when
    it rejects."""
    req = P.api_request.TokenRequest.from_bytes(raw)
    try:
        res = tms.validator().validate(req, lambda i: ledger[(i.tx_id, i.index)])
    except P.api_driver.ValidationError:
        return None
    return [(i.tx_id, i.index) for i in res.spent], res.outputs


@pytest.mark.parametrize("kind", ["fabtoken", "zkatdlog"])
def test_requests_byte_identical_and_cross_validated(both_pp, kind):
    pps = {root: (None if kind == "fabtoken" else pp) for root, pp in both_pp.items()}
    ref, ref_tms = lifecycle_requests(REF, pps[REF.root], seed=41)
    port, port_tms = lifecycle_requests(PORT, pps[PORT.root], seed=41)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for (name, rreq, ledger, ok), (_, preq, _, _) in zip(ref, port):
        raw = preq.to_bytes()
        assert raw == rreq.to_bytes(), name
        assert PORT.api_request.TokenRequest.from_bytes(raw).to_bytes() == raw
        got = {P.root: _verdict(P, tms, raw, ledger)
               for P, tms in ((REF, ref_tms), (PORT, port_tms))}
        assert got[REF.root] == got[PORT.root], name
        assert (got[PORT.root] is not None) == ok, name


# ------------------------------------------------------------------ batched planes

def _mint(P, pp, seed, values_rows):
    """Transfer specs over inputs minted directly (commitments and
    metadata, owners nym identities of one wallet), and the ledger.
    Outputs go to a second wallet; every spec keeps its values."""
    rng = random.Random(seed)
    alice = P.api_wallet.OwnerWallet("alice", anonymous=True, nym_params=pp.nym_params, rng=rng)
    bob = P.api_wallet.OwnerWallet("bob", anonymous=True, nym_params=pp.nym_params, rng=rng)
    tokm = P.crypto_token
    specs, ledger = [], {}
    for t, (in_vals, out_vals) in enumerate(values_rows):
        coms, wits = tokm.tokens_with_witness(in_vals, "USD", pp.ped_params, rng)
        ids, raws, metas = [], [], []
        for k, (c, w) in enumerate(zip(coms, wits)):
            owner = alice.recipient_identity()
            ids.append(P.models_token.ID(f"mint{t}", k))
            raws.append(tokm.Token(owner=owner, data=c).to_bytes())
            metas.append(tokm.Metadata("USD", w.value, w.bf, owner=owner).to_bytes())
            ledger[(f"mint{t}", k)] = raws[-1]
        specs.append((ids, raws, metas, "USD", list(out_vals),
                      [bob.recipient_identity() for _ in out_vals]))
    return specs, ledger, P.api_wallet.WalletRegistry(owners={"alice": alice, "bob": bob})


def _signed(driver, wallets, anchor, spec, action, tms_rng=None):
    """A one-transfer request over `action`, signed by the input owners."""
    req = TokenRequest(anchor=anchor)
    req.transfers.append(TransferRecord(action=action, input_ids=list(spec[0]),
                                        senders=[driver.output_owner(r) for r in spec[1]],
                                        receivers=list(spec[5])))
    ManagementService(driver, wallets, rng=tms_rng).sign_transfers(req)
    return req


def _host(validator, req, resolve, proofs=None):
    try:
        res = validator.validate(req, resolve, transfer_proofs=proofs)
    except ValidationError as e:
        return str(e)
    return res.spent, res.outputs


@pytest.fixture(scope="module")
def made_1in1out(both_pp):
    """Two 1-in/1-out transfers through both drivers' `transfer_many`
    from one seed: the port's on device="cpu"."""
    rows = [([9], [9]), ([4], [4])]
    out = {}
    for P in (REF, PORT):
        pp = both_pp[P.root]
        specs, ledger, wallets = _mint(P, pp, 77, rows)
        kw = {"device": "cpu"} if P is PORT else {}
        driver = P.drivers_zkatdlog.ZKATDLogDriver(pp, **kw)
        outcomes = driver.transfer_many(specs, rng=random.Random(78), min_batch=1)
        out[P.root] = (driver, specs, ledger, wallets, outcomes)
    return out


def test_transfer_many_byte_identical_to_reference(made_1in1out):
    ref, port = made_1in1out[REF.root], made_1in1out[PORT.root]
    assert [s[1] for s in port[1]] == [s[1] for s in ref[1]]  # the same minted inputs
    assert [o.action_bytes for o in port[4]] == [o.action_bytes for o in ref[4]]
    assert [o.metadata for o in port[4]] == [o.metadata for o in ref[4]]


def test_batch_plan_and_verify_equal_host_validation(made_1in1out):
    driver, specs, ledger, wallets, outcomes = made_1in1out[PORT.root]
    resolve = lambda i: ledger[(i.tx_id, i.index)]  # noqa: E731
    actions = [o.action_bytes for o in outcomes]
    # plant: a bumped WF response (the batched plane rejects it), and an
    # action whose claimed inputs differ from the ledger's (the proof is
    # valid for the claim, so the plane accepts it; input_match rejects)
    d = loads(actions[0])
    p = tr.TransferProof.from_bytes(d["proof"])
    w = wf.TransferWF.from_bytes(p.wf)
    w.sum_resp = (w.sum_resp + 1) % hm.R
    d["proof"] = tr.TransferProof(w.to_bytes(), None).to_bytes()
    tampered = dumps(d)
    d = loads(actions[1])
    d["ids"] = [["mint0", 0]]  # spends the first input, claims the second's token
    mismatched = dumps(d)
    actions += [tampered, mismatched]
    req_specs = specs + [specs[0], (specs[0][0],) + specs[1][1:]]
    reqs = [_signed(driver, wallets, f"tx{i}", s, a, random.Random(90 + i))
            for i, (s, a) in enumerate(zip(req_specs, actions))]
    plans = [driver.transfer_batch_plan(a) for a in actions]
    assert all(pl is not None and pl[0] == (1, 1) for pl in plans)
    assert driver.transfer_batch_plan(b"garbage") is None
    txs_before = mx.REGISTRY.counter("batch.transfer.txs").value
    verdicts = driver.batch_verifier().verify([pl[1] for pl in plans]).tolist()
    assert mx.REGISTRY.counter("batch.transfer.txs").value - txs_before == len(plans)
    assert verdicts == [True, True, False, True]
    v = ManagementService(driver).validator()
    host = [_host(v, r, resolve) for r in reqs]
    batched = [_host(v, r, resolve, {0: ok}) for r, ok in zip(reqs, verdicts)]
    assert [isinstance(h, str) for h in host] == [False, False, True, True]
    assert batched[:2] == host[:2]
    assert batched[2] == "invalid transfer proof"
    assert "invalid transfer proof" in host[2]
    assert batched[3] == host[3] == "transfer inputs do not match ledger state"
    assert driver.batch_verifier() is driver.batch_verifier()
    assert driver.batch_prover() is bp.prover_for(driver.pp, device="cpu")


@pytest.mark.slow
def test_batched_planes_2in2out(zk_pp):
    specs, ledger, wallets = _mint(PORT, zk_pp, 79, [([5, 3], [6, 2]), ([4, 4], [1, 7])])
    driver = ZKATDLogDriver(zk_pp, device="cpu")
    outcomes = driver.transfer_many(specs, rng=random.Random(80), min_batch=1)
    resolve = lambda i: ledger[(i.tx_id, i.index)]  # noqa: E731
    reqs = [_signed(driver, wallets, f"tx{i}", s, o.action_bytes, random.Random(i))
            for i, (s, o) in enumerate(zip(specs, outcomes))]
    plans = [driver.transfer_batch_plan(o.action_bytes) for o in outcomes]
    assert [pl[0] for pl in plans] == [(2, 2)] * 2
    verdicts = driver.batch_verifier().verify([pl[1] for pl in plans]).tolist()
    assert verdicts == [True, True]
    v = ManagementService(driver).validator()
    for r, ok in zip(reqs, verdicts):
        assert _host(v, r, resolve, {0: ok}) == _host(v, r, resolve)


class _Boom:
    def prove(self, reqs, rng=None):
        raise MemoryError("injected device fault")


def test_transfer_many_device_error_propagates(zk_pp, monkeypatch):
    """A failure of the batched prover ends `transfer_many`: no group is
    proved on the host in its place."""
    driver = ZKATDLogDriver(zk_pp, device="cpu")
    monkeypatch.setattr(bp, "prover_for", lambda pp, device=None: _Boom())
    specs, _, _ = _mint(PORT, zk_pp, 83, [([6], [6]), ([1], [1])])
    host_before = mx.REGISTRY.counter("batch.prove.host").value
    with pytest.raises(MemoryError, match="injected device fault"):
        driver.transfer_many(specs, rng=random.Random(84), min_batch=1)
    assert mx.REGISTRY.counter("batch.prove.host").value == host_before


def test_default_device_is_the_card(zk_pp, monkeypatch):
    """With CUDA reported absent, building a driver and its host paths
    work; the first batched-plane call raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    driver = ZKATDLogDriver(zk_pp)
    specs, ledger, _ = _mint(PORT, zk_pp, 81, [([3], [3]), ([2], [2])])
    host = driver.transfer_many(specs, rng=random.Random(82), min_batch=3)
    assert driver.transfer_batch_plan(host[0].action_bytes)[0] == (1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.transfer_many(specs, rng=random.Random(82), min_batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.batch_verifier()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.batch_prover()
