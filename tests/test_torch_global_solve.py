"""The port's method-0/1 pipeline against the JAX package's on the circle
fixture (float64, CPU), its CLI without JAX, and ``chip_smoke.py``'s
refusal to run without a GPU."""

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
from slam_tpu_torch import cli
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
    ot = torch_run(graph, cfg, lt, device="cpu")
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
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
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


@pytest.mark.parametrize("argv", [
    ["INTEL", "0", "2"], ["INTEL", "0", "3"], ["INTEL", "0", "4"],
    ["INTEL", "0", "1", "--sweep"], ["INTEL", "0", "1", "--checkpoint", "x"],
    ["INTEL", "0", "1", "--profile", "x"],
])
def test_cli_names_unported_paths(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv)


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
