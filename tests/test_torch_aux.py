"""The port's profiling utilities and sweep harness against the JAX
package's (float64, CPU): ``Timer``, ``trace``, ``iteration_rate``;
``run_sweep`` (with and without the oracle columns), ``format_table``,
``replay_outliers_to_g2o``; ``--sweep``, ``--sweep-seeds`` and
``--profile`` through the command line."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from slam_tpu.config import SolverConfig
from slam_tpu.eval import harness as jharness
from slam_tpu.io import g2o
from slam_tpu_torch import cli, convert
from slam_tpu_torch.eval import harness
from slam_tpu_torch.utils import profiling

TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's solves: beside other busy
    test processes, a full-width thread team waits on its slowest thread
    at every barrier (as in ``tests/test_torch_ceres_oracle.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def circle_path(circle, tmp_path):
    graph, _ = circle
    path = tmp_path / "c.g2o"
    g2o.write_g2o(str(path), graph)
    return str(path)


def test_profiling_timer():
    t = profiling.Timer()
    with t.section("parse"):
        pass
    x = torch.ones((8, 8), dtype=torch.float64)
    with t.section("solve", sync=x):
        x = x @ x
    with t.section("solve", sync=(x, {"y": [x]})):
        x = x @ x
    assert set(t.sections) == {"parse", "solve"}
    assert all(v >= 0 for v in t.sections.values())
    assert "parse" in t.report() and t.report().startswith("[timing]")


def test_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    x = torch.ones((16, 16), dtype=torch.float64)
    with profiling.trace(logdir):
        y = (x @ x).sum()
    assert float(y) == 16 ** 3
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_iteration_rate():
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    rate, best = profiling.iteration_rate(fn, torch.ones(4), reps=3,
                                          iters_per_call=5)
    assert len(calls) == 4  # warm-up + reps
    assert best > 0 and rate == pytest.approx(5 / best)


def _sweep_kw(oracle=False, **solver):
    return dict(solver=SolverConfig(linear_solver="dense", dtype="float64",
                                    **solver), oracle=oracle)


def _compare_cells(tcells, jcells):
    assert len(tcells) == len(jcells)
    for tc, jc in zip(tcells, jcells):
        t, j = tc.row(), dataclasses.asdict(jc)
        assert set(t) == set(j)
        for k in t:
            if k == "wall_s":
                continue
            if isinstance(j[k], float):
                np.testing.assert_allclose(t[k], j[k], rtol=TOL, atol=TOL,
                                           err_msg=k)
            else:
                assert t[k] == j[k], k


def test_run_sweep_matches_jax(circle_path, tmp_path):
    kw = dict(methods=[0, 1], outlier_counts=[0, 5], seeds=[0, 1])
    jcells = jharness.run_sweep(circle_path, **kw,
                                **_sweep_kw(max_iterations=15))
    sk = _sweep_kw(max_iterations=15)
    sk["solver"] = convert.config_from_jax(sk["solver"])
    tcells = harness.run_sweep(circle_path, **kw, **sk,
                               save_path=str(tmp_path / "sweep"),
                               device="cpu")
    # Zero-outlier cells run once, whatever the seeds.
    assert len(tcells) == 6
    _compare_cells(tcells, jcells)
    assert harness.format_table(tcells) == jharness.format_table(jcells)
    with open(tmp_path / "sweep" / "sweep.json") as f:
        rows = json.load(f)
    assert [r["num_outliers"] for r in rows] == [0, 5, 5, 0, 5, 5]
    with open(tmp_path / "sweep" / "sweep.md") as f:
        assert f.read() == harness.format_table(tcells)


def test_run_sweep_oracle_columns_match_jax(circle_path):
    kw = dict(methods=[1], outlier_counts=[0], seeds=[0])
    jcells = jharness.run_sweep(circle_path, **kw, **_sweep_kw(oracle=True))
    sk = _sweep_kw(oracle=True)
    sk["solver"] = convert.config_from_jax(sk["solver"])
    tcells = harness.run_sweep(circle_path, **kw, **sk, device="cpu")
    c = tcells[0]
    assert c.oracle_final_cost is not None
    assert c.ate_vs_reference < 0.05 and c.ate_plain_vs_reference < 0.05
    _compare_cells(tcells, jcells)


def test_format_table_layout():
    cells = [harness.SweepCell("X", m, n, s, 1.0 + s, 2.0, 10 + s, True,
                               0.1, 0.5 * (s + 1), 0.9, None, None, None)
             for m, n, s in ((0, 0, 0), (1, 10, 0), (1, 10, 1))]
    lines = harness.format_table(cells).splitlines()
    assert lines[0].startswith("| dataset | method | outliers | seeds |")
    assert lines[1] == "|---|---|---|---|---|---|---|---|---|---|---|"
    assert lines[2] == ("| X | baseline | 0 | 1 | 0.500 | 0.500 | 0.90 | "
                        "1.0000 | 10 | n/a | n/a |")
    assert lines[3] == ("| X | DCS | 10 | 2 | 0.750 | 1.000 | 0.90 | "
                        "1.5000 | 10 | n/a | n/a |")
    assert len(lines) == 4


def test_replay_outliers_matches_jax(circle_path, tmp_path):
    jout, tout = tmp_path / "j.g2o", tmp_path / "t.g2o"
    jd = jharness.replay_outliers_to_g2o(circle_path, 7, seed=3,
                                         out_path=str(jout))
    td = harness.replay_outliers_to_g2o(circle_path, 7, seed=3,
                                        out_path=str(tout))
    assert td.num_edges == jd.num_edges
    assert tout.read_bytes() == jout.read_bytes()


def test_cli_sweep_seeds(circle_path, tmp_path, capsys):
    save = tmp_path / "s"
    assert cli.main([circle_path, "5", "1", "--sweep", "--sweep-seeds", "2",
                     "--device", "cpu", "--max-iterations", "8",
                     "--save-path", str(save)]) == 0
    with open(save / "sweep.json") as f:
        rows = json.load(f)
    # Methods 0 and 1; counts 0 and 5; two seeds where outliers are
    # injected.
    assert [(r["method"], r["num_outliers"], r["seed"]) for r in rows] == [
        (0, 0, 0), (0, 5, 0), (0, 5, 1), (1, 0, 0), (1, 5, 0), (1, 5, 1)]
    assert all(np.isfinite(r["final_cost"]) for r in rows)
    assert (save / "sweep.log").is_file()
    assert "| DCS | 5 | 2 |" in capsys.readouterr().out


def test_cli_profile_writes_a_trace(circle_path, tmp_path):
    """``--profile DIR`` wraps the solve in a trace and changes no
    result."""
    argv = [circle_path, "5", "1", "--device", "cpu", "--max-iterations",
            "5"]
    assert cli.main(argv + ["--save-path", str(tmp_path / "a")]) == 0
    assert cli.main(argv + ["--save-path", str(tmp_path / "b"), "--profile",
                            str(tmp_path / "trace")]) == 0
    assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert (tmp_path / "a" / "opt_nodes.txt").read_bytes() == \
        (tmp_path / "b" / "opt_nodes.txt").read_bytes()
