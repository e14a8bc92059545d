"""The port's method-0/1/2 pipeline against the JAX package's on the circle
fixture (float64, CPU): log records, poses, switches and ``switches.txt``;
the per-stage report; its CLI without JAX; and ``chip_smoke.py``'s refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from slam_tpu.config import RunConfig, SolverConfig
from slam_tpu.io import g2o
from slam_tpu.methods.global_solve import run_global_solve as jax_run
from slam_tpu.utils.logging import RunLogger
from slam_tpu_torch import cli, convert
from slam_tpu_torch.methods.global_solve import run_global_solve as torch_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Capture(RunLogger):
    def __init__(self):
        super().__init__(echo=False)
        self.records = []

    def log(self, tag, msg="", **fields):
        self.records.append((tag, fields))


def compare_runs(graph, cfg):
    """Run both packages; poses agree to 1e-6 and every log record except
    wall times is identical (rescue trigger, rounds, tags, kept)."""
    lj, lt = Capture(), Capture()
    oj = jax_run(graph, cfg, lj)
    ot = torch_run(convert.graph_from_jax(graph), convert.config_from_jax(cfg),
                   lt, device="cpu")
    np.testing.assert_allclose(ot.poses, oj.poses, rtol=0, atol=1e-6)

    def strip(records):
        out = []
        for tag, f in records:
            f = {k: v for k, v in f.items() if k != "wall_s"}
            for k in ("initial_cost", "final_cost", "final_trust_lambda"):
                if k in f:
                    f[k] = round(f[k], 9)
            out.append((tag, f))
        return out

    assert strip(lt.records) == strip(lj.records)
    return lt.records


@pytest.mark.parametrize("method", [0, 1])
def test_circle_global_solve_matches(circle_outliers, method):
    graph, _ = circle_outliers
    cfg = RunConfig(method=method, num_outliers=10, seed=7,
                    solver=SolverConfig(dtype="float64", max_iterations=20,
                                        dcs_consensus_chains=2))
    compare_runs(graph, cfg)


def test_circle_rescue_path_matches(circle):
    """Enough bogus loops that the psi-consensus rescue triggers."""
    graph, _ = circle
    dirty = graph.add_random_outliers(40, seed=3)
    cfg = RunConfig(method=1, num_outliers=40, seed=3,
                    solver=SolverConfig(dtype="float64", max_iterations=15,
                                        dcs_consensus_chains=2,
                                        dcs_consensus_drop_frac=0.0))
    records = compare_runs(dirty, cfg)
    assert any(tag == "retry" for tag, _ in records)


def test_cli_runs_without_jax(circle_outliers, tmp_path):
    graph, _ = circle_outliers
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, graph)
    save = tmp_path / "save"
    code = (
        "import sys\n"
        "from slam_tpu_torch import cli\n"
        f"rc = cli.main([{path!r}, '5', '1', '--device', 'cpu', "
        f"'--save-path', {str(save)!r}, '--max-iterations', '5'])\n"
        "assert rc == 0\n"
        "import importlib, pkgutil, slam_tpu_torch\n"
        "for m in pkgutil.walk_packages(slam_tpu_torch.__path__, "
        "'slam_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'slam_tpu') "
        "or m.startswith(('jax.', 'jaxlib', 'slam_tpu.')))\n"
        "assert not bad, bad\n"
        "print('NOJAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    for name in ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
                 "opt_edges.txt"):
        assert (save / name).is_file(), name


# ---------------------------------------------------------------------------
# Method 2 (switchable constraints)
# ---------------------------------------------------------------------------

def _method2_cfg(robust, solver, **kw):
    return RunConfig(method=2, num_outliers=10, seed=7,
                     solver=SolverConfig(dtype="float64", max_iterations=20,
                                         robust=robust, linear_solver=solver),
                     **kw)


@pytest.mark.parametrize("solver", ["auto", "schur", "pcg"])
@pytest.mark.parametrize("robust", ["none", "sc_varpro"])
def test_circle_method2_matches(circle_outliers, robust, solver):
    """Joint SC (robust "none" maps to "sc") and its variable projection on
    the dense (auto: 64 nodes), Schur and PCG solvers: every log record
    identical but for wall times, and the CG iterations within one per LM
    iteration; cost, poses and switches to 1e-8."""
    graph, _ = circle_outliers
    cfg = _method2_cfg(robust, solver)
    lj, lt = Capture(), Capture()
    oj = jax_run(graph, cfg, lj)
    ot = torch_run(convert.graph_from_jax(graph),
                   convert.config_from_jax(cfg), lt, device="cpu")
    np.testing.assert_allclose(ot.poses, oj.poses, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ot.switches, oj.switches, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(ot.result.cost), float(oj.result.cost),
                               rtol=1e-8)
    assert ot.switches.shape == oj.switches.shape
    assert [t for t, _ in lt.records] == [t for t, _ in lj.records]
    for (tag, ft), (_, fj) in zip(lt.records, lj.records):
        assert ft.keys() == fj.keys(), tag
        for k, vj in fj.items():
            vt = ft[k]
            if k == "wall_s":
                continue
            if k in ("linear_iters", "inner_linear_iters"):
                assert abs(vt - vj) <= int(fj.get("iterations", 0)), k
            elif isinstance(vj, float):
                np.testing.assert_allclose(vt, vj, rtol=1e-8, atol=1e-12,
                                           err_msg=f"{tag} {k}")
            else:
                assert vt == vj, (tag, k)
    if robust == "none":
        assert dict(lt.records)["solve"]["robust"] == "sc"


@pytest.mark.parametrize("robust", ["none", "sc_varpro"])
def test_run_from_config_writes_switches(circle, tmp_path, robust):
    """``switches.txt`` of both packages: the same lines in the same
    layout (three sections, odometry rows ``1 1``), values to 1e-8."""
    from slam_tpu.methods.global_solve import run_from_config as jax_rfc
    from slam_tpu_torch.methods.global_solve import \
        run_from_config as torch_rfc

    graph, _ = circle  # run_from_config injects the 10 bogus loops
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, graph)
    files = {}
    for name, run, conv in (("jax", jax_rfc, lambda c: c),
                            ("torch", lambda c: torch_rfc(c, device="cpu"),
                             convert.config_from_jax)):
        save = tmp_path / name
        run(conv(_method2_cfg(robust, "auto", dataset=path,
                              save_path=str(save))))
        files[name] = (save / "switches.txt").read_text().splitlines()
    j, t = files["jax"], files["torch"]
    assert len(t) == len(j) == graph.num_edges + 10 + 3
    assert t[0] == "Odometry EDGES AHEAD"
    assert "Closure EDGES AHEAD" in t and "BOGUS EDGES AHEAD" in t
    for lt_, lj_ in zip(t, j):
        wt, wj = lt_.split(), lj_.split()
        if len(wj) != 5:
            assert lt_ == lj_
            continue
        assert wt[:3] == wj[:3]
        np.testing.assert_allclose([float(x) for x in wt[3:]],
                                   [float(x) for x in wj[3:]], rtol=0,
                                   atol=1e-8)
    bogus = t[t.index("BOGUS EDGES AHEAD") + 1:]
    assert len(bogus) == 10


def test_report_stages(circle_outliers, capsys):
    """``report_stages`` adds the three per-stage times (positive, finite)
    to the report, its record and its text."""
    from slam_tpu_torch.solver import report as treport

    graph, _ = circle_outliers
    cfg = convert.config_from_jax(_method2_cfg("none", "pcg",
                                               report_stages=True))
    log = Capture()
    out = torch_run(convert.graph_from_jax(graph), cfg, log, device="cpu")
    rec = dict(log.records)["report"]
    for stage in ("linearize", "linear_solve", "retract_cost"):
        v = rec[f"t_{stage}_s"]
        assert np.isfinite(v) and v > 0, (stage, v)
    text = capsys.readouterr().out
    assert "Per-iteration stage times" in text
    for stage in ("linearize", "linear_solve", "retract_cost"):
        assert f"    {stage}" in text
    # measure_stages itself, on the dense joint system.
    import torch

    from slam_tpu_torch.solver.models import SE2Model
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph

    tg = convert.graph_from_jax(graph).canonical_order()
    edges = edge_set_from_graph(tg, pad_to=256)
    times = treport.measure_stages(
        torch.as_tensor(out.poses), torch.as_tensor(out.switches), edges,
        anchor_first_node(tg.num_nodes),
        cfg.solver.replace(robust="sc", linear_solver="dense"), SE2Model)
    assert list(times) == ["linearize", "linear_solve", "retract_cost"]
    assert all(np.isfinite(v) and v > 0 for v in times.values())


def test_cli_method2_runs(circle_outliers, tmp_path, capsys):
    """Method 2, ``--sc-varpro``, ``--linear-solver pcg`` and
    ``--report-stages`` run through the CLI; and method 2 on the Woodbury
    solver matches the JAX package's run record for record."""
    graph, _ = circle_outliers
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, graph)
    for extra in ([], ["--sc-varpro"],
                  ["--linear-solver", "pcg", "--report-stages"]):
        save = tmp_path / ("save" + "".join(extra))
        assert cli.main([path, "5", "2", "--device", "cpu", "--save-path",
                         str(save), "--max-iterations", "5", *extra]) == 0
        assert (save / "switches.txt").is_file()
    assert "retract_cost" in capsys.readouterr().out
    save = tmp_path / "w"
    assert cli.main([path, "5", "2", "--device", "cpu", "--linear-solver",
                     "woodbury", "--save-path", str(save),
                     "--max-iterations", "5"]) == 0
    assert (save / "switches.txt").is_file()
    records = compare_runs(graph, _method2_cfg("none", "woodbury"))
    assert any(tag == "woodbury" for tag, _ in records)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
