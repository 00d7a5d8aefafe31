"""PyTorch port, the device dispatch ledger (`utils/devobs.py`), against
the JAX package.

Port mirrors of the seven tests of `tests/test_devobs.py` (the off switch
is a passthrough; occupancy, waste and placement; the build and load
attribution in place of the XLA compile and cache one; `note_degrade`;
the multiexp ledgered under its kernel's name; the clamp site; the
ledger never perturbs verdicts) and of `tests/test_compile_budget.py::
test_dispatch_ledger_pins_program_set_across_batch_sweep`. New: the
card's timing by event pairs resolved at a read (fake events on the
CPU), reads from other threads while frames record, a node's `device`
section with the JAX package's keys at every level, and each program's
dispatches equal to its kernel's `Kernel.launches` with the card's route
emulated.
"""

import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from torch_network_cases import REF, PORT, build_both, counter

torch.set_num_threads(1)

from fabric_token_sdk_tpu_torch.api.validator import RequestValidator  # noqa: E402
from fabric_token_sdk_tpu_torch.crypto import hostmath as hm, sign  # noqa: E402
from fabric_token_sdk_tpu_torch.crypto.batch_sign import BatchedSchnorrVerifier  # noqa: E402
from fabric_token_sdk_tpu_torch.drivers.fabtoken import (  # noqa: E402
    FabTokenDriver, FabTokenPublicParams,
)
from fabric_token_sdk_tpu_torch.ops import _build, curve as cv, stages as st  # noqa: E402
from fabric_token_sdk_tpu_torch.ops import warmup as wu  # noqa: E402
from fabric_token_sdk_tpu_torch.services.network import BlockPolicy, Network, TxStatus  # noqa: E402
from fabric_token_sdk_tpu_torch.services.ttx import Party, Transaction  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import benchschema, devobs  # noqa: E402
from fabric_token_sdk_tpu_torch.utils import metrics as mx  # noqa: E402

ref_devobs = __import__("fabric_token_sdk_tpu.utils.devobs", fromlist=["x"])


@pytest.fixture(autouse=True)
def _clean_ledger():
    """Each test sees (and leaves) a reset ledger, switched on; registry
    histograms are process-wide and asserted by delta only."""
    devobs.reset()
    devobs.enable(True)
    yield
    devobs.enable(True)
    devobs.reset()


def _hist_count(name):
    h = mx.REGISTRY.snapshot().get("histograms", {}).get(name)
    return h["count"] if h else 0


def _schnorr_rows(n, seed=0xD0B5, bad=()):
    """n (public key, message, signature) rows of one key; rows in `bad`
    carry another message's signature."""
    rng = random.Random(seed)
    key = sign.keygen(rng)
    msgs = [b"devobs-%d" % i for i in range(n)]
    sigs = [key.sign(m, rng) for m in msgs]
    for i in bad:
        sigs[i] = sigs[(i + 1) % n]
    return [(key.public.point, m, s) for m, s in zip(msgs, sigs)]


# ------------------------------------------------------------ zero cost when off


def test_off_is_passthrough():
    devobs.enable(False)
    assert not devobs.enabled()
    agg_before = _hist_count("device.dispatch.seconds")
    threads_before = threading.active_count()
    with devobs.plane("verify"):
        with devobs.attribute("offtest_attr"):
            with devobs.dispatch("offtest_prog", rows=5, padded_rows=3):
                pass
    devobs.note_compile(1.0)
    devobs.note_cache("cache_hits")
    devobs.note_degrade("offtest_reason")
    # a real wrapper too: its frame is a passthrough
    a = torch.zeros((1, 3, 8), dtype=torch.int32)
    st.g1_add_rows(a, a)
    assert devobs.snapshot() == {}
    assert devobs.current_program() is None
    snap = mx.REGISTRY.snapshot()
    assert "device.dispatch.offtest_prog.seconds" not in snap.get("histograms", {})
    assert "device.offtest_prog.padded_rows" not in snap.get("counters", {})
    assert _hist_count("device.dispatch.seconds") == agg_before
    assert threading.active_count() == threads_before
    assert devobs.health_section()["enabled"] is False
    assert devobs.health_section()["programs"] == {}


# ------------------------------------------------------------ ledger arithmetic + schema


def test_dispatch_records_occupancy_waste_and_placement():
    agg_before = _hist_count("device.dispatch.seconds")
    with devobs.plane("verify"):
        with devobs.dispatch("ledger_prog", rows=5, padded_rows=3, dp=2):
            pass
    snap = devobs.snapshot()
    assert set(snap) == {("verify", "ledger_prog")}
    e = snap[("verify", "ledger_prog")]
    assert e["dispatches"] == 1
    assert (e["rows"], e["padded_rows"], e["dp"], e["mp"]) == (5, 3, 2, 1)
    assert e["wall_s"] >= 0

    h = devobs.health_section()
    prog = h["programs"]["verify:ledger_prog"]
    assert prog["occupancy"] == 0.625
    assert prog["waste_frac"] == 0.375
    assert h["planes"]["verify"]["occupancy"] == 0.625

    assert _hist_count("device.dispatch.seconds") == agg_before + 1
    assert _hist_count("device.dispatch.ledger_prog.seconds") >= 1
    reg = mx.REGISTRY.snapshot()
    assert reg["counters"]["device.ledger_prog.padded_rows"] == 3
    assert reg["histograms"]["device.verify.occupancy"]["count"] >= 1

    section = devobs.section()
    assert benchschema.validate_device(section) == []
    assert section["dispatches"] == 1
    assert section["occupancy"] == 0.625
    assert section["waste_frac"] == 0.375
    # a body that raised is no dispatch (as a failed launch counts none)
    with pytest.raises(RuntimeError):
        with devobs.dispatch("ledger_prog", rows=5, plane="verify"):
            raise RuntimeError("launch failed")
    assert devobs.snapshot()[("verify", "ledger_prog")]["dispatches"] == 1


def test_build_and_load_attribution(tmp_path, monkeypatch):
    """In place of the XLA compile and cache attribution: `build_all`
    reports each `nvcc` build (a compile with its seconds, and a miss)
    and each load of a library `_build/` already held (a hit) against
    the active frame; warmup's frame takes its build. A fake `nvcc` (a
    stub library copied to its `-o`) stands in for the CUDA toolkit."""
    stub_c = tmp_path / "stub.c"
    stub_c.write_text("int fts_stub(void) { return 0; }\n")
    stub = tmp_path / "stub.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(stub), str(stub_c)], check=True)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"""#!{sys.executable}
import shutil, sys
args = sys.argv[1:]
shutil.copy({str(stub)!r}, args[args.index("-o") + 1])
""")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    n = len(_build.SOURCES)

    with devobs.dispatch("attr_prog", rows=1):
        _build.build_all()
        assert devobs.current_program() == "attr_prog"
    e = devobs.snapshot()[(devobs.DEFAULT_PLANE, "attr_prog")]
    assert (e["dispatches"], e["compiles"], e["cache_misses"], e["cache_hits"]) == (1, n, n, 0)
    assert e["compile_s"] == pytest.approx(sum(_build.BUILD_SECONDS.values()))
    # loaded again in a fresh process: hits, no compile
    monkeypatch.setattr(_build, "_libs", {})
    devobs.reset()
    with devobs.attribute("warm_prog"):
        ext = wu.build_extensions()
    assert ext == {"built": [], "loaded": sorted(_build.SOURCES)}
    e = devobs.snapshot()[(devobs.DEFAULT_PLANE, "warm_prog")]
    assert (e["dispatches"], e["compiles"], e["cache_hits"], e["cache_misses"]) == (0, 0, n, 0)
    # with no frame ever opened, events land on the unattributed bucket
    devobs.reset()
    devobs.note_compile(0.1)
    devobs.note_cache("cache_hits")
    assert set(devobs.snapshot()) == {(devobs.DEFAULT_PLANE, devobs.UNATTRIBUTED)}
    # the frame outlives its block as the process-wide fallback
    devobs.reset()
    with devobs.dispatch("late_prog", rows=1):
        pass
    devobs.note_compile(0.25)
    assert devobs.snapshot()[(devobs.DEFAULT_PLANE, "late_prog")]["compiles"] == 1


def test_note_degrade_lands_on_named_program():
    devobs.note_degrade("k_not_divisible", program="fused_pairing")
    devobs.note_degrade("k_not_divisible", program="fused_pairing")
    e = devobs.snapshot()[(devobs.DEFAULT_PLANE, "fused_pairing")]
    assert e["degrades"] == {"k_not_divisible": 2}
    prog = devobs.health_section()["programs"]["stages:fused_pairing"]
    assert prog["degrades"] == 2
    assert prog["degrade_reasons"] == {"k_not_divisible": 2}


# ------------------------------------------------------------ a real dispatch, its kernel's name


def test_msm_dispatch_ledgered_with_canonical_program_name():
    """The port's programs are its kernels; one launch over all rows, so
    no padding. Under the sign plane's tag the same kernels land on the
    `sign` plane."""
    rng = random.Random(0xD0B5)
    table = cv.FixedBaseTable([hm.g1_mul(hm.G1_GEN, 3)])
    scalars = torch.from_numpy(np.stack(
        [cv.encode_scalars([rng.randrange(hm.R)]) for _ in range(5)]))
    st.g1_msm_rows(table.table, scalars)
    e = devobs.snapshot()[("stages", "g1_msm")]
    assert (e["dispatches"], e["rows"], e["padded_rows"]) == (1, 5, 0)
    assert devobs.health_section()["programs"]["stages:g1_msm"]["occupancy"] == 1.0

    got = BatchedSchnorrVerifier(device="cpu").verify(_schnorr_rows(3, bad=(1,)))
    assert got == [True, False, True]
    snap = devobs.snapshot()
    assert {f: e["dispatches"] for f, e in snap.items() if f[0] == "sign"} == {
        ("sign", "g1_msm"): 1, ("sign", "g1_mul"): 1, ("sign", "g1_addsub"): 1}
    assert all(e["rows"] == 3 for f, e in snap.items() if f[0] == "sign")


def test_clamp_site_is_attributed():
    from fabric_token_sdk_tpu_torch.parallel import sharding

    before = mx.REGISTRY.snapshot().get("counters", {})
    cfg = sharding.MeshConfig.build(6, 4)
    assert cfg.mp == 3
    after = mx.REGISTRY.snapshot()["counters"]

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("sharding.clamped") == 1
    assert delta("sharding.clamped.meshconfig") == 1
    evt = [e for e in mx.FLIGHT.tail(50) if e["kind"] == "sharding.clamped"][-1]
    assert evt["where"] == "MeshConfig"
    assert (evt["want"], evt["got"], evt["n_devices"]) == (4, 3, 6)


# ------------------------------------------------------------ the ledger never perturbs verdicts


def _run_scenario():
    """Issue, then two transfers of which the second double-spends, in
    one block whose two signatures go through the sign plane's plain
    versions (so the frames are on the path)."""
    pp = FabTokenPublicParams()
    network = Network(RequestValidator(FabTokenDriver(pp)),
                      policy=BlockPolicy(max_block_txs=8, sign_batched=True, sign_min_batch=2),
                      device="cpu")
    rng = random.Random(0xD0)
    parties = {name: Party(name, FabTokenDriver(pp), network, rng=rng)
               for name in ("issuer-node", "alice-node", "bob-node")}
    pp.add_issuer(parties["issuer-node"].new_issuer_wallet("issuer").identity)
    alice = parties["alice-node"].new_owner_wallet("alice", anonymous=False)
    bob = parties["bob-node"].new_owner_wallet("bob", anonymous=False)
    tx = Transaction(parties["issuer-node"], "devobs-seed")
    tx.issue("issuer", "USD", [5], [alice.recipient_identity()], anonymous=False)
    tx.collect_endorsements(None)
    tx.submit()
    alice_p = parties["alice-node"]
    tid = alice_p.vault.token_ids()[0]

    def spend(anchor):
        req = alice_p.tms.new_request(anchor)
        tokens, metas = alice_p.vault.get_many([tid])
        alice_p.tms.add_transfer(req, [tid], tokens, metas, "USD", [5],
                                 [bob.recipient_identity()])
        alice_p.tms.sign_transfers(req)
        return req.to_bytes()

    events = network.submit_many([spend("dv-ok"), spend("dv-dup")])
    return [e.status for e in events]


def test_ledger_never_perturbs_verdicts():
    rows0 = counter(PORT, "batch.sign.rows")
    on_statuses = _run_scenario()
    assert on_statuses == [TxStatus.VALID, TxStatus.INVALID]
    assert counter(PORT, "batch.sign.rows") - rows0 == 2
    assert devobs.snapshot()[("sign", "g1_mul")]["dispatches"] == 1
    devobs.enable(False)
    devobs.reset()
    off_statuses = _run_scenario()
    assert off_statuses == on_statuses
    assert devobs.snapshot() == {}


# ------------------------------------------------------------ tests/test_compile_budget.py:96


def test_dispatch_ledger_pins_program_set_across_batch_sweep():
    """Sweeping the batch size grows dispatches, never the set of
    (plane, program) frames: one kernel a stage whatever the rows, and
    no build on the CPU."""
    rng = random.Random(0xB0D6)
    table = cv.FixedBaseTable([hm.g1_mul(hm.G1_GEN, 31 + i) for i in range(3)])

    def scal(B):
        return torch.from_numpy(np.stack(
            [cv.encode_scalars([rng.randrange(hm.R) for _ in range(3)]) for _ in range(B)]))

    before = devobs.snapshot()
    sweep = (1, 3, 11, 32)
    for B in sweep:
        st.g1_msm_rows(table.table, scal(B))
    after = devobs.snapshot()

    def disp(snap, frame):
        return snap.get(frame, {}).get("dispatches", 0)

    grown = {f for f in after if disp(after, f) > disp(before, f)}
    assert grown == {("stages", "g1_msm")}, grown
    frame = ("stages", "g1_msm")
    assert disp(after, frame) - disp(before, frame) == len(sweep)
    assert after[frame]["rows"] - before.get(frame, {}).get("rows", 0) == sum(sweep)
    assert after[frame]["padded_rows"] == 0
    assert after[frame]["compiles"] == 0


# ------------------------------------------------------------ the card's timing, by event pairs


class _FakeEvent:
    """A timing event of a fake stream: `query()` is True once the test
    says the stream reached it; `elapsed_time` in ms, as CUDA's."""

    def __init__(self, clock):
        self.clock = clock
        self.at = None

    def record(self, stream):
        stream.recorded.append(self)
        self.at = len(stream.recorded)

    def query(self):
        return self.at is not None and self.at <= self.clock["done"]

    def elapsed_time(self, end):
        assert self.query() and end.query(), "elapsed_time on a running event"
        return (end.at - self.at) * self.clock["ms_per_step"]


class _FakeStream:
    def __init__(self):
        self.recorded = []


def test_card_timing_by_event_pairs_resolved_at_read(monkeypatch):
    """On a CUDA device a frame records an event pair on the device's
    stream and never synchronizes; a read resolves the finished pairs by
    `query()` into `wall_s` and the histograms, keeps a running pair for
    a later read, never drops it; a mesh frame takes the longest of its
    devices' pairs; past `RESOLVE_AT` pending pairs a dispatch resolves
    the finished ones itself. The time histograms take `TIME_BUCKETS`."""
    clock = {"done": 0, "ms_per_step": 1.0}
    streams = {"cuda:0": _FakeStream(), "cuda:1": _FakeStream()}

    def fake_streams(device):
        devs = device if isinstance(device, list) else [device]
        return [(d, streams[d]) for d in dict.fromkeys(devs)]

    made = []

    def fake_event(key):
        made.append(key)
        return _FakeEvent(clock)

    monkeypatch.setattr(devobs, "_streams", fake_streams)
    monkeypatch.setattr(devobs, "_event", fake_event)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("the ledger synchronized"))
    h0 = _hist_count("device.dispatch.card_prog.seconds")
    with devobs.plane("verify"):
        with devobs.dispatch("card_prog", rows=4, device="cuda:0"):
            streams["cuda:0"].recorded.append(None)  # the kernel: 2 steps on the stream
            streams["cuda:0"].recorded.append(None)
    e = devobs.snapshot()[("verify", "card_prog")]
    assert (e["dispatches"], e["rows"], e["wall_s"]) == (1, 4, 0.0)  # still running
    assert len(devobs._pending) == 1
    assert _hist_count("device.dispatch.card_prog.seconds") == h0
    clock["done"] = 10 ** 6  # the stream finished
    prog = devobs.health_section()["programs"]["verify:card_prog"]
    assert prog["wall_s"] == 0.003 and prog["p50_s"] == 0.003
    # device times take buckets from 10 us (the registry's default start at 1 ms)
    assert tuple(mx.histogram("device.dispatch.card_prog.seconds").buckets) == devobs.TIME_BUCKETS
    assert devobs._pending == []
    assert _hist_count("device.dispatch.card_prog.seconds") == h0 + 1
    # a mesh frame: the longest pair of its devices
    with devobs.dispatch("mesh_prog", rows=2, device=["cuda:0", "cuda:1"]):
        streams["cuda:1"].recorded.extend([None] * 5)
    assert devobs.snapshot()[("stages", "mesh_prog")]["wall_s"] == pytest.approx(0.006)
    # unread, the pending list stays bounded
    clock["done"] = 0
    base = len(streams["cuda:0"].recorded)
    for _ in range(devobs.RESOLVE_AT - 1):
        with devobs.dispatch("many", rows=1, device="cuda:0"):
            pass
    assert len(devobs._pending) == devobs.RESOLVE_AT - 1
    clock["done"] = base + 2 * (devobs.RESOLVE_AT - 1)
    with devobs.dispatch("many", rows=1, device="cuda:0"):
        pass
    assert len(devobs._pending) == 1  # the last one, still running
    clock["done"] = 10 ** 6
    e = devobs.snapshot()[("stages", "many")]
    assert e["dispatches"] == devobs.RESOLVE_AT and e["wall_s"] == pytest.approx(
        devobs.RESOLVE_AT * 0.001)
    # resolved events go back to the pool
    assert sum(map(len, devobs._free_events.values())) >= 2 * devobs.RESOLVE_AT


def test_reads_from_other_threads_while_frames_record():
    """The ops RPC reads the ledger from the server's thread while blocks
    dispatch: no count is lost or doubled."""
    stop = threading.Event()
    reads = []

    def reader():
        while not stop.is_set():
            reads.append(devobs.health_section()["planes"].get("verify", {}).get("dispatches", 0))

    def writer():
        with devobs.plane("verify"):
            for _ in range(300):
                with devobs.dispatch("thr_prog", rows=2):
                    pass

    r = threading.Thread(target=reader)
    r.start()
    ws = [threading.Thread(target=writer) for _ in range(4)]
    for w in ws:
        w.start()
    for w in ws:
        w.join()
    stop.set()
    r.join()
    e = devobs.snapshot()[("verify", "thr_prog")]
    assert (e["dispatches"], e["rows"]) == (1200, 2400)
    assert reads and reads == sorted(reads)


# ------------------------------------------------------------ the node's section, both packages


def test_node_device_section_has_the_reference_keys():
    """The same 2-tx block (two issues: two pk signatures) through the
    JAX and the port `Network` with the sign plane on: the port's runs
    the kernels' plain versions inside their frames; the JAX ledger's is
    served by its host verifier inside the JAX ledger's frames of the
    same three programs (its XLA sign plane costs ~40 s of compiles
    here). Both `health()["device"]` sections have the same keys at
    every level (the port adds `name`, its device); plane and program
    rows agree in everything but times and program names."""
    envs, raws = build_both("fabtoken", lambda e: [e.issue("ds-0", [5]), e.issue("ds-1", [7])])
    ref_bs = __import__("fabric_token_sdk_tpu.crypto.batch_sign", fromlist=["x"])
    ref_sign = __import__("fabric_token_sdk_tpu.crypto.sign", fromlist=["x"])

    class FramedHostSchnorr:
        def __init__(self, *a, **k):
            pass

        def verify(self, rows):
            with ref_devobs.plane("sign"):
                for prog in ("g1_msm1_tile", "g1_mul_tile", "g1_sub_tile"):
                    with ref_devobs.dispatch(prog, rows=len(rows)):
                        pass
            return ref_sign.verify_many(rows)

    ref_devobs.reset()
    sections = {}
    saved = ref_bs.BatchedSchnorrVerifier
    ref_bs.BatchedSchnorrVerifier = FramedHostSchnorr
    try:
        for P in (REF, PORT):
            kw = {"device": "cpu"} if P is PORT else {}
            net = P.services_network.Network(
                envs[P.root].validator(),
                P.services_network.BlockPolicy(max_block_txs=4, sign_batched=True,
                                               sign_min_batch=2), **kw)
            got = [e.status.value for e in net.submit_many(raws)]
            assert got == ["Valid", "Valid"], (P.root, got)
            sections[P.root] = net.health()["device"]
    finally:
        ref_bs.BatchedSchnorrVerifier = saved
        ref_devobs.reset()
    ref, port = sections[REF.root], sections[PORT.root]
    assert set(port) == set(ref) | {"name"} and port["name"] == "cpu"
    assert port["enabled"] is ref["enabled"] is True
    assert set(port["planes"]) == set(ref["planes"]) == {"sign"}
    assert set(port["planes"]["sign"]) == set(ref["planes"]["sign"])
    assert port["planes"]["sign"]["dispatches"] == ref["planes"]["sign"]["dispatches"] == 3
    assert port["planes"]["sign"]["rows"] == ref["planes"]["sign"]["rows"] == 6
    assert sorted(port["programs"]) == ["sign:g1_addsub", "sign:g1_msm", "sign:g1_mul"]
    for p, r in zip(sorted(port["programs"].values(), key=lambda x: x["program"]),
                    sorted(ref["programs"].values(), key=lambda x: x["program"])):
        assert set(p) == set(r)
        same = ("plane", "dispatches", "rows", "padded_rows", "occupancy", "waste_frac",
                "dp", "mp", "compiles", "cache_hits", "cache_misses", "degrades")
        assert {k: p[k] for k in same} == {k: r[k] for k in same}
        assert p["wall_s"] > 0 and p["p50_s"] > 0 and p["p99_s"] >= p["p50_s"]


# ------------------------------------------------------------ dispatches equal launches


def test_dispatches_equal_kernel_launches(monkeypatch):
    """With the card's route emulated on CPU tensors (the route taken,
    the shape checks and the launch faked; the launch counted as
    `Kernel.launch` counts it), warmup's 15 programs launch each kernel
    through its wrapper: each program's dispatches, summed over planes,
    equal its kernel's `Kernel.launches` delta exactly."""
    real_route = st._route

    def card_route(name, *tensors):
        real_route(name, *tensors)
        return True

    def fake_launch(self, device, *args):
        with self._count_lock:
            self.launches += 1

    monkeypatch.setattr(st, "_route", card_route)
    monkeypatch.setattr(st, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(_build.Kernel, "launch", fake_launch)
    before = {k.name: k.launches for k in _build.ALL_KERNELS}
    summary = wu.warmup(device="cpu")
    assert summary["programs"] == len(wu.all_programs()) == 15
    launched = {k.name: k.launches - before[k.name] for k in _build.ALL_KERNELS}
    dispatched = {}
    for (_plane, prog), e in devobs.snapshot().items():
        dispatched[prog] = dispatched.get(prog, 0) + e["dispatches"]
    assert {k: v for k, v in launched.items() if v} == dispatched
    assert set(dispatched) == {k.name for k in _build.ALL_KERNELS}
    assert dispatched["g1_addsub"] == 2 and dispatched["gt_product"] == 2  # two programs each


# ------------------------------------------------------------ the time buckets and overlaps


@pytest.mark.parametrize("at_s, slow_s", [(5.64e-3, 7.91e-3), (13e-6, 26e-6)])
def test_time_buckets_resolve_a_kernel_p50_within_ten_percent(at_s, slow_s):
    """C2: a program's dispatches mostly at one time (`final_exp` at the
    block's rows, 5.64 ms; `g1_addsub`, 13 us) with some slower ones (the
    batch's rows): the p50 of `TIME_BUCKETS` reads within 10% of the
    common time, where a bucket from 5 to 10 ms (or 10 to 25 us) read its
    midpoint. The bounds step by 1.2x from 10 us to 25 ms."""
    h = mx.histogram(f"test.devobs.buckets.{at_s}", buckets=devobs.TIME_BUCKETS)
    for _ in range(15):
        h.observe(at_s)
    for _ in range(5):
        h.observe(slow_s)
    assert abs(h.quantile(0.5) - at_s) <= 0.1 * at_s
    fine = [b for b in devobs.TIME_BUCKETS if b <= 0.025]
    assert fine[0] == 1e-5 and fine[-1] == 0.025
    assert all(1.15 <= b / a <= 1.25 for a, b in zip(fine, fine[1:]))
    assert devobs.TIME_BUCKETS[-1] == 120.0


def test_overlapping_pairs_on_one_stream_are_counted(monkeypatch):
    """C3: a frame whose event pair was open on a stream while another
    thread's pair was open there counts as overlapped, both frames; a
    frame nested in another on the same thread, or on another stream,
    does not. The count stands in `section()` beside the p50 and in
    `device.dispatch.overlapped`."""
    clock = {"done": 10 ** 6, "ms_per_step": 1.0}
    streams = {"cuda:0": _FakeStream(), "cuda:1": _FakeStream()}
    monkeypatch.setattr(devobs, "_streams", lambda device: [(device, streams[device])])
    monkeypatch.setattr(devobs, "_event", lambda key: _FakeEvent(clock))
    devobs.reset()
    before = mx.REGISTRY.counter("device.dispatch.overlapped").value
    # nested on one thread (a mesh frame around its kernel's): no overlap
    with devobs.dispatch("outer", rows=1, device="cuda:0"):
        with devobs.dispatch("inner", rows=1, device="cuda:0"):
            pass
    # another thread's frame opens while A's is open on cuda:0; a third
    # thread's frame on cuda:1 meanwhile overlaps nothing
    opened, release = threading.Event(), threading.Event()

    def holder():
        with devobs.plane("sign"), devobs.dispatch("g1_msm", rows=2, device="cuda:0"):
            opened.set()
            release.wait(timeout=10)

    t = threading.Thread(target=holder)
    t.start()
    assert opened.wait(timeout=10)
    def alone():
        with devobs.dispatch("alone", rows=1, device="cuda:1"):
            pass

    with devobs.plane("verify"), devobs.dispatch("miller", rows=4, device="cuda:0"):
        other = threading.Thread(target=alone)
        other.start()
        other.join()
    release.set()
    t.join()
    with devobs.dispatch("after", rows=1, device="cuda:0"):  # both closed: no overlap
        pass
    snap = devobs.snapshot()
    assert snap[("sign", "g1_msm")]["overlapped"] == 1
    assert snap[("verify", "miller")]["overlapped"] == 1
    assert all(snap[("stages", p)]["overlapped"] == 0
               for p in ("outer", "inner", "after", "alone"))
    sec = devobs.section()
    assert sec["dispatch_overlapped"] == 2 and "dispatch_p50_s" in sec
    assert mx.REGISTRY.counter("device.dispatch.overlapped").value - before == 2
    devobs.reset()
