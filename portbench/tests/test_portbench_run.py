"""The harness's run function on the CPU builds the contract's last line;
the command without a card prints no result; no run loads JAX or the JAX
package."""

import json
import subprocess
import sys

from portbench import run as bench_run
from portbench.cell import ROOT

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _cpu_run_script(cell: str, trace: int) -> str:
    return (
        "import json, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run\n"
        f"out = run.run({cell!r}, 2**31 + 5, 0.2, {bool(trace)}, "
        "device='cpu', overrides={'lanes': 2, 'lm_iters': 1, "
        "'trace_solves': 1}, log=lambda *a, **k: None)\n"
        "print(json.dumps({'out': out, "
        "'forbidden': run.forbidden_modules(), "
        "'tops': sorted({m.split('.')[0] for m in __import__('sys')"
        ".modules})}))\n")


def _cpu_run(cell: str, trace: int) -> dict:
    p = subprocess.run([sys.executable, "-c", _cpu_run_script(cell, trace)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_last_line_keys_and_no_jax():
    got = _cpu_run("intel50.sc.b8_dense", 0)
    out = got["out"]
    assert set(out) == KEYS | {"check"}
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"lm_it_per_s.dense", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["device"]["platform"] == "cpu"
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "slam_tpu"} & set(got["tops"])


def test_traced_run_keys():
    out = _cpu_run("intel50.sc.b8_dense", 1)["out"]
    assert set(out) == KEYS | {"check", "breakdown"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) <= {m + ".dense" for m in (
        "launches_per_it", "linearize_ms_per_it", "linsolve_ms_per_it",
        "linsolve_roofline_pct", "kernels_roofline_pct", "device_idle_pct")}


def test_command_without_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        return
    rc = bench_run.main(["--workload", "intel50.sc.b8_dense", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc != 0
    assert captured.out == ""
    assert "no result" in captured.err


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "slam_tpu_torch_lookalike",
                        types.ModuleType("slam_tpu_torch_lookalike"))
    assert "slam_tpu" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "slam_tpu.x",
                        types.ModuleType("slam_tpu.x"))
    assert "slam_tpu" in bench_run.forbidden_modules()
