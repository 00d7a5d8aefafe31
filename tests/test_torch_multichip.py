"""PyTorch port, `multichip_torch.py` (the counterpart of
`__graft_entry__.py:dryrun_multichip`) on a logical mesh of CPU devices:
`main()` in this process at (dp, mp) = (2, 1) runs stages 0-3 (the
`entry()` step, Schnorr rows over the row groups, PS pairing products,
a zkatdlog block through `Network(mesh=...)`) and writes an `ok: true`
result in the reference's shape; the same script as a child with a
deadline shorter than its first stage fires its watchdog, which writes
`ok: false` with the live phase, flushes the sidecar and the flight
ring, and exits 1. `entry()` returns the flagship step and its
arguments."""

import json
import os
import subprocess
import sys

import pytest
import torch

from fabric_token_sdk_tpu_torch.crypto import hostmath as hm
from fabric_token_sdk_tpu_torch.ops import curve as cv
from fabric_token_sdk_tpu_torch.utils import metrics as mx

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import multichip_torch  # noqa: E402


def test_entry_step_is_the_fixed_base_multiexp_minus_c_stmt():
    fn, args = multichip_torch.entry("cpu")
    resp, stmt, chal = args
    assert tuple(resp.shape) == (32, 3, 8) and tuple(stmt.shape) == (32, 3, 8)
    want = hm.g1_multiexp([hm.g1_mul(hm.G1_GEN, 3 + i) for i in range(3)], [7, 7, 7])
    assert cv.decode_points(fn(*args).numpy()) == [want] * 32


def test_dry_run_stages_0_to_3_write_an_ok_result(tmp_path, capsys):
    result = tmp_path / "multichip.result.json"
    was = mx.enabled()
    sharded = mx.REGISTRY.counter("stages.sharded_calls").value
    rc = multichip_torch.main(["--logical", "--device", "cpu", "--devices", "2",
                               "--block-txs", "3", "--result", str(result)])
    assert rc == 0 and mx.enabled() == was
    out = capsys.readouterr().out
    for stage in range(4):
        assert f"stage {stage}:" in out
    doc = json.loads(result.read_text())
    assert doc["ok"] is True and doc["degraded"] is False and doc["phase"] == "done"
    assert doc["n_devices"] == 2
    assert {k: doc["gauges"][k] for k in ("multichip.dp", "multichip.mp",
                                          "multichip.block_txs")} == {
        "multichip.dp": 2, "multichip.mp": 1, "multichip.block_txs": 3}
    assert mx.REGISTRY.counter("stages.sharded_calls").value > sharded


def test_watchdog_writes_a_degraded_result_and_exits_1(tmp_path):
    result = tmp_path / "m.result.json"
    sidecar = tmp_path / "m.metrics.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "multichip_torch.py"), "--logical", "--device",
         "cpu", "--devices", "2", "--deadline", "0.5", "--result", str(result),
         "--sidecar", str(sidecar)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "DEADLINE" in proc.stderr
    doc = json.loads(result.read_text())
    assert doc["ok"] is False and doc["degraded"] is True and doc["deadline_s"] == 0.5
    assert doc["phase"] in ("mesh_build", "entry_step", "sigma_kernel")
    snap = json.loads(sidecar.read_text())
    assert snap["meta"]["progress.phase"] == doc["phase"]
    flight = json.loads((tmp_path / "m.flight.json").read_text())
    assert any(e["kind"] == "multichip.deadline" for e in flight["events"])


def test_a_mesh_of_missing_cards_fails_with_an_error_result(tmp_path, monkeypatch):
    """Without the cards asked for, `make_mesh` raises: the run raises and
    its result reads `ok: false` with the error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    result = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="CUDA devices"):
        multichip_torch.main(["--devices", "3", "--mp", "2", "--deadline", "0",
                              "--result", str(result)])
    doc = json.loads(result.read_text())
    assert doc["ok"] is False and "make_mesh" in doc["error"]
