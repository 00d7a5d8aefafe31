"""Shared cases of the port's remote node, replication and ops-plane tests
(`tests/test_torch_{remote_network,replication,ops_plane}.py`).

`Kit(P)` builds package P's fabtoken issuer (public parameters, driver,
pk key and identity) from one seed, so the same calls in both packages
give byte-identical issue requests (`Kit.issue`); `fab_net(P, ...)` is
package P's journaled `Network` over them (the port's on
`device="cpu"`). `raw_rpc` speaks the wire format below every client
nicety. `wait` polls a condition up to a deadline: no test waits on a
bare sleep.
"""

import importlib
import json
import random
import socket
import time
from types import SimpleNamespace

_MODS = ("api.request", "api.validator", "crypto.sign", "drivers.identity",
         "drivers.fabtoken", "services.network", "services.network.ledger",
         "services.network.remote", "services.network.replication",
         "services.network.wal", "utils.faults", "utils.metrics")


def _package(root):
    return SimpleNamespace(root=root, **{
        m.replace(".", "_"): importlib.import_module(f"{root}.{m}") for m in _MODS})


REF = _package("fabric_token_sdk_tpu")
PORT = _package("fabric_token_sdk_tpu_torch")


def counter(P, name):
    return P.utils_metrics.REGISTRY.counter(name).value


def wait(cond, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Kit:
    """Package P's fabtoken issuer from `seed`: `issue(anchor)` gives the
    bytes of a signed issue request of one output to the issuer."""

    def __init__(self, P, seed=0xF75):
        self.P = P
        self.rng = random.Random(seed)
        self.pp = P.drivers_fabtoken.FabTokenPublicParams()
        self.drv = P.drivers_fabtoken.FabTokenDriver(self.pp)
        self.key = P.crypto_sign.keygen(self.rng)
        self.ident = P.drivers_identity.pk_identity(self.key.public)

    def issue(self, anchor, value=5):
        req_mod = self.P.api_request
        outcome = self.drv.issue(self.ident, "USD", [value], [self.ident], anonymous=False)
        req = req_mod.TokenRequest(anchor=anchor)
        req.issues.append(req_mod.IssueRecord(
            action=outcome.action_bytes, issuer=self.ident,
            outputs_metadata=outcome.metadata, receivers=[self.ident]))
        req.issues[0].signature = self.key.sign(req.marshal_to_sign(), self.rng)
        return req.to_bytes()

    def validator(self):
        return self.P.api_validator.RequestValidator(self.P.drivers_fabtoken.FabTokenDriver(self.pp))


def fab_net(P, wal_path=None, pp=None, snapshot_every=0, **kw):
    """Package P's `Network` over fabtoken, journaled at `wal_path`; the
    port's on the CPU."""
    pp = pp or P.drivers_fabtoken.FabTokenPublicParams()
    validator = P.api_validator.RequestValidator(P.drivers_fabtoken.FabTokenDriver(pp))
    if P is PORT:
        kw.setdefault("device", "cpu")
    return P.services_network_ledger.Network(
        validator, wal_path=None if wal_path is None else str(wal_path),
        snapshot_every=snapshot_every, **kw)


def raw_rpc(address, msg, timeout=5.0):
    """One framed request/response over a fresh socket (the JAX package's
    framing, which both packages share)."""
    with socket.create_connection(address, timeout=timeout) as sock:
        sock.settimeout(timeout)
        PORT.services_network_remote._send_msg(sock, msg)
        return PORT.services_network_remote._recv_msg(sock)


def journal(P, wal_path):
    """The records of a WAL, decoded, with their timestamps dropped."""
    out = []
    for raw in P.services_network_wal.WriteAheadLog(str(wal_path)).replay():
        d = json.loads(raw)
        d.pop("ts", None)
        out.append(d)
    return out


def statuses(net, tx_ids):
    return [(t, None if net.status(t) is None else net.status(t).status.value)
            for t in tx_ids]
