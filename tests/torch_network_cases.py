"""Shared cases of the port's block validation tests
(`tests/test_torch_{orderer,pipeline,recovery,resilience}.py`).

Requests are built by each package's `ManagementService` and wallets from
one seed (the port has no ttx services, so no `Party`): the same calls
in both packages give byte-identical requests, which `build_both`
asserts. The same bytes then go to the JAX package's `Network` and to
the port's `Network(device="cpu")`, and `assert_same_ledger` compares
what they committed exactly: heights, the blocks' tx lists, statuses and
messages, state and spent sets, all from the decoded snapshots (block
timestamps excepted).

Both ledgers run the same policy. The JAX ledger's batched planes are
served by the JAX package's host verifiers (`HostTransferVerifier`,
`HostSchnorrVerifier`: its batched verifiers' verdicts equal them, which
its own tests pin), so no XLA program compiles here, while the port's
run the kernels' plain torch versions: the port's planes are held to the
reference's host verdicts, and a device verdict reaches the same
rejection message in both ledgers. zkatdlog public parameters are
`setup(base=4, exponent=2)` from one seed in each package, and the
zkatdlog blocks are 1-in/1-out (no range proof).
"""

import contextlib
import functools
import importlib
import os
import random
from types import SimpleNamespace

import numpy as np

SETUP_SEED = 0xF75

_MODS = ("api.request", "api.tms", "api.validator", "api.wallet", "crypto.setup",
         "crypto.sign", "crypto.serialization", "drivers.fabtoken", "drivers.zkatdlog",
         "models.token", "services.network", "services.network.ledger",
         "services.network.wal", "utils.faults", "utils.metrics", "utils.resilience",
         "utils.slo")


def _package(root):
    return SimpleNamespace(root=root, **{
        m.replace(".", "_"): importlib.import_module(f"{root}.{m}") for m in _MODS})


REF = _package("fabric_token_sdk_tpu")
PORT = _package("fabric_token_sdk_tpu_torch")


def setup_both():
    """zkatdlog public parameters of both packages, from one seed."""
    return {P.root: P.crypto_setup.setup(base=4, exponent=2, rng=random.Random(SETUP_SEED))
            for P in (REF, PORT)}


def module(P, name):
    return importlib.import_module(f"{P.root}.{name}")


def counter(P, name):
    return P.utils_metrics.REGISTRY.counter(name).value


class Env:
    """An issuer and two non-anonymous owners (pk identities) of package
    P, their `ManagementService`, and the outputs of every request built
    so far, keyed (anchor, index)."""

    def __init__(self, P, kind, zk_pp=None, seed=0):
        self.P, self.kind = P, kind
        rng = random.Random(seed)
        if kind == "fabtoken":
            self.pp = P.drivers_fabtoken.FabTokenPublicParams()
            driver = P.drivers_fabtoken.FabTokenDriver(self.pp)
        else:
            self.pp = zk_pp
            driver = P.drivers_zkatdlog.ZKATDLogDriver(zk_pp)
            # the management service passes no rng to the driver: bind one
            driver.issue = functools.partial(driver.issue, rng=rng)
            driver.transfer = functools.partial(driver.transfer, rng=rng)
        self.issuer = P.api_wallet.IssuerWallet("issuer", P.crypto_sign.keygen(rng))
        self.owners = {name: P.api_wallet.OwnerWallet(name, anonymous=False, rng=rng)
                       for name in ("alice", "bob")}
        if kind == "fabtoken":
            self.pp.add_issuer(self.issuer.identity)
        wallets = P.api_wallet.WalletRegistry(owners=dict(self.owners),
                                              issuers={"issuer": self.issuer})
        self.tms = P.api_tms.ManagementService(driver, wallets, rng=rng)
        self.outputs = {}

    def _record(self, anchor, action, metas):
        raws = self.P.crypto_serialization.loads(action)["outputs"]
        for k, (raw, meta) in enumerate(zip(raws, metas)):
            self.outputs[(anchor, k)] = (raw, meta)

    def issue(self, anchor, values, to="alice"):
        req = self.tms.new_request(anchor)
        owner = self.owners[to].recipient_identity()
        self.tms.add_issue(req, self.issuer, "USD", list(values), [owner] * len(values),
                           anonymous=False)
        self.tms.sign_issues(req)
        self._record(anchor, req.issues[0].action, req.issues[0].outputs_metadata)
        return req

    def transfer(self, anchor, inputs, values, to="bob"):
        """A signed transfer spending the outputs `inputs` ((anchor, k)
        pairs) to `to`: no selector, so double spends can be built."""
        req = self.tms.new_request(anchor)
        ids = [self.P.models_token.ID(a, k) for a, k in inputs]
        toks = [self.outputs[i][0] for i in inputs]
        metas = [self.outputs[i][1] for i in inputs]
        owner = self.owners[to].recipient_identity()
        self.tms.add_transfer(req, ids, toks, metas, "USD", list(values),
                              [owner] * len(values))
        self.tms.sign_transfers(req)
        self._record(anchor, req.transfers[0].action, req.transfers[0].outputs_metadata)
        return req

    def validator(self, device="cpu"):
        """A `RequestValidator` over a fresh driver of the same public
        parameters (the port's zkatdlog driver on `device`)."""
        P = self.P
        if self.kind == "fabtoken":
            driver = P.drivers_fabtoken.FabTokenDriver(self.pp)
        elif P is PORT:
            driver = P.drivers_zkatdlog.ZKATDLogDriver(self.pp, device=device)
        else:
            driver = P.drivers_zkatdlog.ZKATDLogDriver(self.pp)
        return P.api_validator.RequestValidator(driver)


def build_both(kind, scenario, zk_pps=None, seed=0):
    """Run `scenario(env) -> list of requests` in both packages from one
    seed; assert the request bytes identical. Returns ({root: env},
    [bytes])."""
    envs, raws = {}, {}
    for P in (REF, PORT):
        env = Env(P, kind, None if zk_pps is None else zk_pps[P.root], seed)
        envs[P.root] = env
        raws[P.root] = [r.to_bytes() for r in scenario(env)]
    assert raws[REF.root] == raws[PORT.root]
    return envs, raws[PORT.root]


class HostTransferVerifier:
    """A batched proof plane over the JAX package's host
    `TransferVerifier`: one verdict a row, False where it raises."""

    def __init__(self, pp):
        self.pp = pp

    def verify(self, rows):
        tr = module(REF, "crypto.transfer")
        out = []
        for ins, outs, proof in rows:
            try:
                tr.TransferVerifier(ins, outs, self.pp).verify(proof)
                out.append(True)
            except ValueError:
                out.append(False)
        return np.array(out, dtype=bool)


class HostSchnorrVerifier:
    """A batched signature plane over the JAX package's host
    `sign.verify_many`: True/False a parsed row, None an unparsable one
    (the `BatchedSchnorrVerifier` contract)."""

    def __init__(self, *args, **kwargs):
        pass

    def verify(self, rows):
        return module(REF, "crypto.sign").verify_many(rows)


def host_sign_plane(monkeypatch):
    """Serve the JAX ledger's sign plane by `HostSchnorrVerifier` (its
    orderer imports `BatchedSchnorrVerifier` at first use)."""
    monkeypatch.setattr(module(REF, "crypto.batch_sign"), "BatchedSchnorrVerifier",
                        HostSchnorrVerifier)


def policy(P, **kw):
    return P.services_network.BlockPolicy(**kw)


@contextlib.contextmanager
def pipeline_env(on):
    """`FTS_BLOCK_PIPELINE` while a `Network` is built: the pipelined
    engine's one selector in the port (the JAX package reads it too, and
    its `BlockPolicy.pipeline` stays at its default, on). None leaves
    the environment as it is."""
    if on is None:
        yield
        return
    old = os.environ.get("FTS_BLOCK_PIPELINE")
    os.environ["FTS_BLOCK_PIPELINE"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["FTS_BLOCK_PIPELINE"]
        else:
            os.environ["FTS_BLOCK_PIPELINE"] = old


def network(P, env, pipeline=None, **kw):
    """Package P's `Network` over the env's public parameters: the port's
    on the CPU, the JAX one's proof plane served by `HostTransferVerifier`.
    `pipeline` True/False builds it with the pipelined engine on/off."""
    validator = env.validator()
    if P is PORT:
        kw.setdefault("device", "cpu")
    elif env.kind == "zkatdlog":
        plane = HostTransferVerifier(env.pp)
        validator.driver.batch_verifier = lambda mesh=None: plane
    with pipeline_env(pipeline):
        return P.services_network.Network(validator, **kw)


def networks(envs, wal_paths=None, pipeline=None, **policy_kw):
    """{root: Network} of both packages under one policy. `wal_paths`
    ({root: path}) journals each; `pipeline` as in `network`."""
    out = {}
    for P in (REF, PORT):
        kw = {"policy": policy(P, **policy_kw)}
        if wal_paths:
            kw["wal_path"] = wal_paths[P.root]
        out[P.root] = network(P, envs[P.root], pipeline=pipeline, **kw)
    return out


def events(evs):
    return [(e.tx_id, e.status.value, e.message) for e in evs]


def submit_many_both(nets, raws):
    """`submit_many` on both ledgers; asserts equal events, returns them."""
    got = {root: events(net.submit_many(list(raws))) for root, net in nets.items()}
    assert got[REF.root] == got[PORT.root]
    return got[PORT.root]


def submit_both(nets, raw):
    got = {root: events([net.submit(raw)])[0] for root, net in nets.items()}
    assert got[REF.root] == got[PORT.root]
    return got[PORT.root]


def snapshot_view(P, raw):
    """A decoded snapshot with the block timestamps dropped."""
    d = P.crypto_serialization.loads(raw)
    return {"state": d["state"], "spent": d["spent"],
            "blocks": [[b[0], b[1]] for b in d["blocks"]], "status": d["status"]}


def ledger_view(P, net):
    view = snapshot_view(P, net.snapshot())
    view["height"] = net.height()
    view["blocks_api"] = [net.block(i).txs for i in range(net.height())]
    return view


def assert_same_ledger(nets):
    ref = ledger_view(REF, nets[REF.root])
    port = ledger_view(PORT, nets[PORT.root])
    assert port == ref
    return port
