"""PyTorch port, the mesh binding of the batched planes (the reference's
`crypto/batch.py:_MeshBound`): the well-formedness verifier, the
transfer verifier on 1-in/1-out transfers, the Schnorr sign plane and
the 1-in/1-out prover, each bound to the logical (2, 1) and (2, 2)
meshes of CPU devices, against the same plane unbound (bit for bit),
the JAX package's host verifiers and, for the prover, the JAX package's
batched prover's bytes for one seed. Ragged batches (3 rows over dp = 2)
with planted rows; the mesh plane's counters as planned: one
`stages.sharded_calls` and dp `stages.shards` a stage call.

Also the binding's rules: a `MeshConfig` names no device (TypeError), a
mesh over another device than the plane's raises ValueError, the window
tables are copied once a distinct device when the mesh is bound, and
`set_mesh(None)`, `driver.batch_verifier(mesh)` and `prover_for(...,
mesh)` re-bind. The plain versions run a whole call a row group, so
each bound call costs dp unbound ones."""

import random

import pytest
import torch

from fabric_token_sdk_tpu.crypto import batch_prove as ref_bp, setup as ref_setup
from fabric_token_sdk_tpu.crypto import sign as ref_sign, token as ref_tok
from fabric_token_sdk_tpu.crypto import transfer as ref_tr, wellformedness as ref_wf
from fabric_token_sdk_tpu_torch.crypto import batch, batch_prove as bp, batch_sign as bs
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, setup, sign, token as tok
from fabric_token_sdk_tpu_torch.crypto import transfer as tr, wellformedness as wf
from fabric_token_sdk_tpu_torch.crypto.serialization import dumps, loads
from fabric_token_sdk_tpu_torch.drivers.zkatdlog import ZKATDLogDriver
from fabric_token_sdk_tpu_torch.parallel import MeshConfig, make_mesh
from torch_mesh_cases import MESH_SHAPES, ShardCounts, cpu_mesh
from torch_transfer_cases import host_verdicts, prove_txs

torch.set_num_threads(1)

SEED = 0x3E5B
MESHES = list(MESH_SHAPES)


@pytest.fixture(scope="module")
def params():
    pp = setup.setup(base=16, exponent=2, rng=random.Random(SEED))
    ref_pp = ref_setup.PublicParams.deserialize(pp.serialize())
    return pp, ref_pp


def _bump_wf(raw_wf: bytes) -> bytes:
    """WF proof bytes with the sum response bumped."""
    w = wf.TransferWF.from_bytes(raw_wf)
    w.sum_resp = (w.sum_resp + 1) % hm.R
    return w.to_bytes()


def _wf_host(mod, pp, rows):
    out = []
    for ins, outs, raw in rows:
        try:
            mod.TransferWFVerifier(pp.ped_params, ins, outs).verify(raw)
            out.append(True)
        except Exception:
            out.append(False)
    return out


@pytest.fixture(scope="module")
def wf_rows(params):
    """Each plane's rows, row 1 with a bumped WF sum response, and their
    unbound verdicts: the WF verifier on the WF proofs of three 1-in/2-out
    transfers (15 flat rows, ragged over dp = 2), the transfer verifier
    on three 1-in/1-out transfers (3 transactions over dp = 2)."""
    pp, _ = params
    rng = random.Random(SEED + 1)
    wf_txs = [(i, o, tr.TransferProof.from_bytes(raw).wf)
              for i, o, raw in prove_txs(pp, 3, rng, shape=(1, 2))]
    wf_txs[1] = (wf_txs[1][0], wf_txs[1][1], _bump_wf(wf_txs[1][2]))
    txs = prove_txs(pp, 3, rng)
    txs[1] = (txs[1][0], txs[1][1],
              tr.TransferProof(_bump_wf(tr.TransferProof.from_bytes(txs[1][2]).wf), None).to_bytes())
    return {"wf": (wf_txs, batch.BatchedWFVerifier(pp, device="cpu").verify(wf_txs)),
            "transfer": (txs, batch.BatchedTransferVerifier(pp, device="cpu").verify(txs))}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("plane", ["wf", "transfer"])
def test_bound_wf_and_transfer_1in1out_equal_unbound_and_reference_hosts(
        params, wf_rows, plane, mesh_name):
    pp, ref_pp = params
    rows, unbound = wf_rows[plane]
    mesh = cpu_mesh(mesh_name)
    if plane == "wf":
        v = batch.BatchedWFVerifier(pp, device="cpu", mesh=mesh)
        hosts = [_wf_host(wf, pp, rows), _wf_host(ref_wf, ref_pp, rows)]
    else:
        v = batch.BatchedTransferVerifier(pp, device="cpu", mesh=mesh)
        hosts = [host_verdicts(rows, tr.TransferVerifier, pp),
                 host_verdicts(rows, ref_tr.TransferVerifier, ref_pp)]
    assert v.mesh is mesh
    with ShardCounts() as c:
        got = v.verify(rows)
    assert got.dtype == bool and got.tolist() == unbound.tolist() == [True, False, True]
    assert hosts == [got.tolist()] * 2
    # g1_msm, g1_mul, g1_sub: one call a stage over the 2 row groups
    assert c.delta == {"stages.sharded_calls": 3, "stages.shards": 6,
                       "pairing.staged.sharded_calls": 0, "pairing.staged.shards": 0}


def _sign_rows():
    """Five Schnorr rows (ragged over dp = 2): valid, a flipped c, another
    message, an unparsable blob, valid."""
    rng = random.Random(SEED + 2)
    keys = [sign.keygen(rng) for _ in range(2)]
    rows = []
    for i in range(5):
        key = keys[i % 2]
        msg = b"mesh row %d" % i
        rows.append((key.public.point, msg, key.sign(msg, rng)))
    d = loads(rows[1][2])
    d["c"] ^= 1
    rows[1] = (rows[1][0], rows[1][1], dumps(d))
    rows[2] = (rows[2][0], b"another message", rows[2][2])
    rows[3] = (rows[3][0], rows[3][1], b"\x00not a signature")
    return rows, [True, False, False, None, True]


@pytest.mark.parametrize("mesh_name", MESHES)
def test_bound_schnorr_equals_unbound_and_reference_hosts(mesh_name):
    rows, want = _sign_rows()
    v = bs.BatchedSchnorrVerifier(device="cpu")
    assert v.mesh is None and v.verify(rows) == want
    v.set_mesh(cpu_mesh(mesh_name))
    with ShardCounts() as c:
        assert v.verify(rows) == want
    assert c.delta["stages.sharded_calls"] == 1 and c.delta["stages.shards"] == 2
    for (pk, msg, sig), w in zip(rows, want):
        if w is None:
            continue
        for mod in (sign, ref_sign):
            try:
                mod.PublicKey(pk).verify(msg, sig)
                ok = True
            except Exception:
                ok = False
            assert ok == w
    v.set_mesh(None)  # unbound again: no row group
    with ShardCounts() as c:
        assert v.verify(rows) == want
    assert c.delta["stages.sharded_calls"] == 0


def _prove_reqs(tok_mod, pp, seed, count):
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        ins, inw = tok_mod.tokens_with_witness([7], "USD", pp.ped_params, rng)
        outs, outw = tok_mod.tokens_with_witness([7], "USD", pp.ped_params, rng)
        out.append((inw, outw, ins, outs))
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
def test_bound_prover_1in1out_bytes_equal_unbound_and_reference(params, mesh_name):
    """Three 1-in/1-out requests (ragged over dp = 2) through
    `prover_for(pp, "cpu", mesh)`: the same bytes as the unbound prover
    and the JAX package's batched prover for one seed; the one select
    multiexp over the row groups."""
    pp, ref_pp = params
    reqs = _prove_reqs(tok, pp, SEED + 3, 3)
    prover = bp.prover_for(pp, "cpu", mesh=cpu_mesh(mesh_name))
    with ShardCounts() as c:
        got = prover.prove(reqs, random.Random(SEED + 4))
    assert c.delta["stages.sharded_calls"] == 1 and c.delta["stages.shards"] == 2
    unbound = bp.prover_for(pp, "cpu")  # the cached prover, re-bound to None
    assert unbound is prover and prover.mesh is None and prover.ped3.mesh is None
    assert got == unbound.prove(reqs, random.Random(SEED + 4))
    ref_reqs = _prove_reqs(ref_tok, ref_pp, SEED + 3, 3)
    assert got == ref_bp.BatchedTransferProver(ref_pp).prove(ref_reqs, random.Random(SEED + 4))


# ------------------------------------------------------------ the binding's rules


def test_a_mesh_config_is_refused(params):
    pp, _ = params
    cfg = MeshConfig.build(4, mp=2)
    for make in (lambda: batch.BatchedWFVerifier(pp, device="cpu", mesh=cfg),
                 lambda: batch.BatchedTransferVerifier(pp, device="cpu", mesh=cfg),
                 lambda: bs.BatchedSchnorrVerifier(device="cpu", mesh=cfg),
                 lambda: bp.BatchedTransferProver(pp, device="cpu", mesh=cfg),
                 lambda: ZKATDLogDriver(pp, device="cpu").batch_verifier(mesh=cfg)):
        with pytest.raises(TypeError, match="MeshConfig names no devices"):
            make()
    v = batch.BatchedWFVerifier(pp, device="cpu")
    with pytest.raises(TypeError):
        v.set_mesh(cfg)
    assert v.mesh is None  # a refused mesh leaves the binding as it was


def test_a_mesh_over_another_device_raises(params):
    """The mesh's first device must be the plane's: a logical mesh of
    `meta` devices (no data) on a plane on the CPU raises ValueError."""
    pp, _ = params
    meta = make_mesh(2, devices=[torch.device("meta")] * 2)
    with pytest.raises(ValueError, match="first device"):
        batch.BatchedWFVerifier(pp, device="cpu", mesh=meta)
    v = bs.BatchedSchnorrVerifier(device="cpu")
    with pytest.raises(ValueError, match="first device"):
        v.set_mesh(meta)
    with pytest.raises(ValueError, match="first device"):
        ZKATDLogDriver(pp, device="cpu").batch_prover(mesh=meta)


def test_tables_copied_once_a_distinct_device_when_bound(params, monkeypatch):
    """Binding copies each window table to each distinct device that runs
    a row group, once; the calls then take those copies and copy no
    table. On a logical mesh over the plane's own device the copy is the
    table itself."""
    pp, _ = params
    v = batch.BatchedTransferVerifier(pp, device="cpu")
    tables = {id(v.table3.table), id(v.table2.table), id(v.membership.tableP.table)}
    v.set_mesh(cpu_mesh("(2, 2)"))
    assert {k[0] for k in v._replicas} == tables and {k[1] for k in v._replicas} == {"cpu"}
    assert all(t is v._replicas[(id(t), "cpu")] for t in
               (v.table3.table, v.table2.table, v.membership.tableP.table))
    moved = []
    real_to = torch.Tensor.to

    def watched_to(self, *a, **kw):
        # a move to a device, not a dtype cast of a plain version
        if id(self) in tables and ("device" in kw or any(
                isinstance(x, (str, torch.device)) for x in a)):
            moved.append(a)
        return real_to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", watched_to)
    txs = prove_txs(pp, 1, random.Random(SEED + 5))
    assert v.verify(txs).tolist() == [True]
    assert moved == []
    v.set_mesh(None)
    assert v._replicas == {} and v.wf.mesh is None and v.membership.mesh is None


def test_driver_rebinds_its_cached_planes(params):
    """`batch_verifier(mesh)` and `batch_prover(mesh)` bind the mesh in
    place of refusing it, and re-bind the cached plane on every call,
    None unbinding (the reference's contract); the fabtoken driver has
    no batched plane, mesh or not."""
    from fabric_token_sdk_tpu_torch.drivers.fabtoken import FabTokenDriver, FabTokenPublicParams

    pp, _ = params
    drv = ZKATDLogDriver(pp, device="cpu")
    mesh = cpu_mesh("(2, 1)")
    v = drv.batch_verifier(mesh)
    assert v.mesh is mesh and v.wf.mesh is mesh and v.membership.mesh is mesh
    assert drv.batch_verifier() is v and v.mesh is None
    p = drv.batch_prover(mesh)
    assert p.mesh is mesh and p.ped2.mesh is mesh
    assert drv.batch_prover() is p and p.mesh is None
    assert FabTokenDriver(FabTokenPublicParams()).batch_verifier(mesh) is None
