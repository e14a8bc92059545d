"""The golden-trajectory gates of ``tests/test_golden.py`` through the port,
float64 on the CPU, at the JAX tests' own bounds: CSAIL and INTEL clean
and CSAIL+50 DCS (dense LM against ``results/golden/``), the product-
pipeline gates (``slow``, as in the JAX tests), the M3500 auto-init cell
and the sphere2500 PCM and chordal-init cell."""

import json
import os

import numpy as np
import pytest
import torch

from slam_tpu_torch.config import RunConfig, SolverConfig
from slam_tpu_torch.eval import metrics
from slam_tpu_torch.io import g2o
from slam_tpu_torch.solver.lm import lm_solve
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "results", "golden")
META = json.load(open(os.path.join(GOLDEN, "meta.json")))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's large dense float64 solves:
    beside other busy test processes, a full-width thread team waits on
    its slowest thread at every barrier of the factor and the triangular
    solves (a 7.6 s cell took 263 s that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _golden(key):
    return np.load(os.path.join(GOLDEN, f"{key}.npy"))


def _solve(name, outliers, seed, max_iterations, robust):
    """``tests/test_golden.py::_solve`` through the port."""
    graph = g2o.load_g2o(g2o.find_dataset(name))
    g = graph.add_random_outliers(outliers, seed=seed)
    edges = edge_set_from_graph(g, dtype=torch.float64)
    free = anchor_first_node(g.num_nodes)
    poses0 = torch.as_tensor(g.poses, dtype=torch.float64)
    sw0 = torch.ones((edges.num_edges,), dtype=torch.float64)
    cfg = SolverConfig(robust=robust, linear_solver="dense",
                       dtype="float64", max_iterations=max_iterations,
                       use_pallas="off")
    return lm_solve(poses0, sw0, edges, free, cfg)


# (key, dataset, outliers, seed, robust, ATE bound, cost bound of the
# golden's final cost: factor, offset) -- test_golden.py:46-76.
CELLS = {
    "CSAIL_0out_seed0": ("CSAIL", 0, 0, "none", 0.05, 2.0, 0.05),
    "CSAIL_50out_seed42": ("CSAIL", 50, 42, "dcs", 0.10, 1.5, 0.0),
    "INTEL_0out_seed0": ("INTEL", 0, 0, "none", 0.05, 2.0, 0.05),
}


@pytest.mark.parametrize("key", sorted(CELLS))
def test_dense_solve_matches_golden(key):
    name, outliers, seed, robust, max_ate, factor, offset = CELLS[key]
    res = _solve(name, outliers, seed, 40, robust)
    ate = metrics.ate(res.poses.numpy(), _golden(key))
    assert ate < max_ate, ate
    assert float(res.cost) < factor * META[key]["final_cost"] + offset


def _product_gate(dataset, outliers, seed, key, max_ate, max_iterations=30,
                  chains=2):
    """``tests/test_golden.py::_product_gate`` through the port."""
    from slam_tpu_torch.methods.global_solve import run_global_solve
    from slam_tpu_torch.utils.logging import RunLogger

    graph = g2o.load_g2o(g2o.find_dataset(dataset))
    dirty = graph.add_random_outliers(outliers, seed=seed)
    out = run_global_solve(
        dirty,
        RunConfig(dataset=dataset, method=1, num_outliers=outliers,
                  seed=seed,
                  solver=SolverConfig(dtype="float64",
                                      max_iterations=max_iterations,
                                      dcs_consensus_chains=chains)),
        RunLogger(echo=False), device="cpu")
    ate = metrics.ate(out.poses, _golden(key))
    assert ate < max_ate, (key, ate)
    return out


@pytest.mark.slow
def test_intel_50out_product_matches_golden():
    _product_gate("INTEL", 50, 42, "INTEL_50out_seed42", 0.8)


@pytest.mark.slow
def test_csail_200out_product_matches_golden():
    _product_gate("CSAIL", 200, 42, "CSAIL_200out_seed42", 0.5)


@pytest.mark.slow
def test_m3500_dcs_outliers_matches_golden():
    """The product pipeline (auto init and the float64 solve) at 25
    iterations, as the JAX gate runs it."""
    from slam_tpu_torch.methods.global_solve import run_global_solve
    from slam_tpu_torch.utils.logging import RunLogger

    key = "M3500_50out_seed0"
    graph = g2o.load_g2o(g2o.find_dataset("M3500"))
    dirty = graph.add_random_outliers(50, seed=0)
    out = run_global_solve(
        dirty,
        RunConfig(dataset="M3500", method=1, num_outliers=50,
                  solver=SolverConfig(dtype="float64", max_iterations=25)),
        RunLogger(echo=False), device="cpu")
    ate = metrics.ate(out.poses, _golden(key))
    assert ate < 0.5, ate
    assert float(out.result.cost) < 1.5 * META[key]["final_cost"]


@pytest.mark.parametrize("n", [0, 10, 50, 100])
def test_m3500_auto_init_lands_near_golden(n):
    """The port's auto init alone (PCM-gated chordal) lands within 6 m of
    the clean golden at every BASELINE outlier count."""
    from slam_tpu_torch.solver.init import apply_init

    graph = g2o.load_g2o(g2o.find_dataset("M3500"))
    dirty = graph.add_random_outliers(n, seed=0)
    ini = apply_init(dirty, RunConfig(init="auto"))
    ate = metrics.ate(np.asarray(ini.poses), _golden("M3500_0out_seed0"))
    assert ate < 6.0, (n, ate)


def test_sphere_se3_pcm_classification_and_init():
    """The port's quaternion cycle test rejects all 50 injected bogus
    loops on sphere2500 and no real one, the trust rule accepts it, and
    the PCM-gated chordal init lands within 2 m of the clean golden."""
    from slam_tpu_torch.graph import BOGUS_EDGE, CLOSURE_EDGE
    from slam_tpu_torch.robust.pcm import pcm_loop_mask
    from slam_tpu_torch.solver.init import apply_init, pcm_trusted

    graph = g2o.load_g2o(os.path.join(REPO, "data", "sphere2500.g2o"))
    dirty = graph.add_random_outliers(50, seed=0).canonical_order()
    r = pcm_loop_mask(dirty)
    et = np.asarray(dirty.edge_type)[r.loop_edges]
    assert ((~r.loop_mask) & (et == BOGUS_EDGE)).sum() == 50
    assert ((~r.loop_mask) & (et == CLOSURE_EDGE)).sum() == 0
    assert pcm_trusted(r)
    ini = apply_init(dirty, RunConfig(init="auto"))
    ate = metrics.ate(np.asarray(ini.poses), _golden("sphere2500_0out_seed0"))
    assert ate < 2.0, ate


@pytest.mark.slow
def test_sphere2500_cli_matches_the_jax_run(tmp_path):
    """``sphere2500 50 1 --seed 0`` through the port's CLI entry in
    float64 ends at the JAX CLI's final cost (1e-9 relative), with its
    iterations, on the golden trajectory (which is that run's)."""
    from slam_tpu_torch.methods.global_solve import run_from_config

    with open(os.path.join(REPO, "slam_tpu_torch", "data",
                           "reference_costs.json")) as f:
        ref = json.load(f)["sphere2500_50_1_cli"]
    out = run_from_config(
        RunConfig(dataset="sphere2500", num_outliers=50, method=1, seed=0,
                  save_path=str(tmp_path),
                  solver=SolverConfig(dtype="float64")), device="cpu")
    res = out.result
    assert int(res.iterations) == ref["iterations"]
    assert int(res.accepted) == ref["accepted"]
    np.testing.assert_allclose(float(res.cost), ref["final_cost"],
                               rtol=1e-9)
    saved = g2o.load_nodes(str(tmp_path / "opt_nodes.txt"))
    assert saved.shape == (2500, 7)
    assert metrics.ate(saved, _golden("sphere2500_50out_seed0")) < 1e-6
