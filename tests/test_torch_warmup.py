"""PyTorch port, the kernel warmup (`ops/warmup.py`) and its CLI.

The inventory is the kernel table: one program a row of PERF.md section
6 from B4 to B16 (and entry point), together launching exactly the
kernels `_build.ALL_KERNELS` holds, with `PROVER_ONLY_PROGRAMS` in the
reference's sense (programs only the batched prover launches).
`python -m fabric_token_sdk_tpu_torch.cmd.ftswarmup --list` prints it.
`warmup(device="cpu", include_pairing=False)` runs the plain versions of
the group programs once each, and the CLI ends on the reference's
`{"metric": "warmup", ...}` line with its sidecars; the whole inventory
through the plain versions (the pairing programs ~40 s) is `slow`.
Without CUDA, `warmup()` (the card) raises. The build-once contract is
pinned in `tests/test_torch_ops_plane.py`."""

import functools
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from fabric_token_sdk_tpu.ops import warmup as ref_wu
from fabric_token_sdk_tpu_torch.ops import _build, warmup as wu
from fabric_token_sdk_tpu_torch.utils import metrics as mx

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP = ["g1_msm", "g1_msm_select", "g1_mul", "g1_sub", "g1_to_affine", "g2_mul", "g2_add",
         "g2_to_affine", "g1_add"]


def _table_rows():
    """{row id: row text} of PERF.md's kernel table, B4 to B16."""
    rows = {}
    with open(os.path.join(ROOT, "PERF.md")) as fh:
        for line in fh:
            m = re.match(r"\| (B\d+(?: \(select\))?) \|", line)
            if m and 4 <= int(re.match(r"B(\d+)", m.group(1)).group(1)) <= 16:
                rows[m.group(1)] = line
    return rows


def test_inventory_is_the_kernel_table():
    progs = wu.all_programs()
    assert len(progs) == 15 and len({p.name for p in progs}) == 15
    # every launched kernel once or more, and nothing else
    assert {p.kernel.name for p in progs} == {k.name for k in _build.ALL_KERNELS}
    # one program a row of the table (B16 has two entry points)
    rows = _table_rows()
    assert sorted({p.row for p in progs}) == sorted(rows)
    for p in progs:
        assert f"csrc/{p.kernel.source}" in rows[p.row], (p.name, p.row)
    assert [p.name for p in wu.all_programs(include_pairing=False)] == GROUP
    assert {p.name for p in wu.all_programs(include_prover=False)} == (
        {p.name for p in progs} - {"g1_msm_select", "g1_add"})
    # the reference's meaning: only the batched prover launches them
    assert wu.PROVER_ONLY_PROGRAMS == {"g1_msm_select", "g1_add"}
    assert ref_wu.program_planes("g1_add_tile") == wu.program_planes("g1_add") == "prove"
    assert wu.program_planes("g1_msm") == "verify"
    assert wu.program_planes("miller") == ref_wu.program_planes("miller_tile") == "verify+prove"
    assert wu.program_planes("gt_product_k2") == ref_wu.program_planes(
        "gt_product_k2_tile") == "verify+prove"


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "fabric_token_sdk_tpu_torch.cmd.ftswarmup",
                           *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_cli_list():
    res = _cli("--list")
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert [ln.split()[0] for ln in lines] == [p.name for p in wu.all_programs()]
    assert "g1_add" in lines[11] and "[prove]" in lines[11] and "B14" in lines[11]
    assert "[verify+prove]" in lines[8] and "miller.cu" in lines[8]
    assert len(_cli("--list", "--no-pairing").stdout.splitlines()) == 9
    assert len(_cli("--list", "--no-prover").stdout.splitlines()) == 13


def test_warmup_group_programs_on_plain_versions():
    before = mx.counter("warmup.programs").value
    seen = []
    summary = wu.warmup(device="cpu", include_pairing=False,
                        progress=lambda name, dt: seen.append(name))
    assert summary["programs"] == 9 and seen == GROUP
    assert [p["name"] for p in summary["per_program"]] == GROUP
    assert (summary["built"], summary["loaded"]) == (0, 0)  # the CPU builds nothing
    assert mx.counter("warmup.programs").value - before == 9
    assert summary["seconds"] > 0 and mx.gauge("warmup.seconds").value == summary["seconds"]


def test_warmup_on_the_card_raises_without_cuda():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wu.warmup()


def test_cli_summary_line_and_sidecar(tmp_path, monkeypatch, capsys):
    """The CLI in this process, its warmup on the plain versions (the CLI
    itself warms the card); the sidecar is written without the exit and
    signal hooks `install_sidecar` would leave in the test process."""
    from fabric_token_sdk_tpu_torch.cmd import ftswarmup

    sidecar = str(tmp_path / "w.metrics.json")
    monkeypatch.setattr(wu, "warmup", functools.partial(wu.warmup, device="cpu"))
    monkeypatch.setattr(mx, "install_sidecar",
                        lambda path: monkeypatch.setattr(mx, "_sidecar_path", path))
    programs = mx.counter("warmup.programs").value
    hist = mx.REGISTRY.snapshot()["histograms"].get("warmup.program.seconds", {})
    was = mx.enabled()
    try:
        assert ftswarmup.main(["--no-pairing", "--no-prover", "--sidecar", sidecar]) == 0
    finally:
        mx.enable(was)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last["metric"] == "warmup" and last["programs"] == 7
    assert (last["built"], last["loaded"]) == (0, 0) and "per_program" not in last
    assert err.count("[fts-warmup]") == 7
    snap = json.load(open(sidecar))
    assert snap["meta"]["entry"] == "ftswarmup"
    assert snap["counters"]["warmup.programs"] - programs == 7
    assert snap["histograms"]["warmup.program.seconds"]["count"] - hist.get("count", 0) == 7
    assert os.path.exists(str(tmp_path / "w.flight.json"))


@pytest.mark.slow
def test_warmup_every_program_on_plain_versions():
    summary = wu.warmup(device="cpu")
    assert [p["name"] for p in summary["per_program"]] == [p.name for p in wu.all_programs()]
