"""The port's chain + low-rank Woodbury solver against the JAX package's
(float64, CPU): the operators, the multi-RHS chain solve, single solves
against the JAX solve and the port's dense solve, LM trajectories (plain,
joint SC), the no-closure graph, padding, and ``--linear-solver woodbury``
through both command lines."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SolverConfig
from slam_tpu.io import g2o, synthetic
from slam_tpu.solver import linear as jlinear
from slam_tpu.solver.lm import lm_solve as jlm_solve
from slam_tpu.solver.linearize import linearize as jlinearize
from slam_tpu.solver.models import SE2Model as JSE2
from slam_tpu.solver.problem import anchor_first_node as janchor
from slam_tpu.solver.problem import edge_set_from_graph as jedges
from slam_tpu.solver.woodbury import build_woodbury_ops as jbuild
from slam_tpu.solver.woodbury import woodbury_solve as jsolve
from slam_tpu_torch import convert
from slam_tpu_torch.solver import linear, tridiag
from slam_tpu_torch.solver.linearize import linearize
from slam_tpu_torch.solver.lm import lm_solve
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.solver.woodbury import build_woodbury_ops, \
    woodbury_solve

TOL = 1e-9
LIN = dict(dcs_phi=0.5, huber_delta=0.01, sc_prior_lambda=1.0)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads for this module's solves: beside other busy
    test processes, a full-width thread team waits on its slowest thread
    at every barrier (as in ``tests/test_torch_ceres_oracle.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _case(graph):
    g = graph.canonical_order()
    tg = convert.graph_from_jax(g)
    return dict(
        g=g, je=jedges(g, dtype=jnp.float64, incidence=True),
        jf=janchor(g.num_nodes, dtype=jnp.float64),
        te=edge_set_from_graph(tg), tf=anchor_first_node(g.num_nodes),
        poses=np.asarray(g.poses))


@pytest.fixture(scope="module")
def problem():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    return _case(graph.add_random_outliers(8, seed=2))


def _systems(c, robust):
    E = c["te"].num_edges
    js = jlinearize(jnp.asarray(c["poses"]), jnp.ones(E), c["je"], c["jf"],
                    model=JSE2, robust=robust, **LIN)
    ts = linearize(torch.as_tensor(c["poses"]),
                   torch.ones(E, dtype=torch.float64), c["te"], c["tf"],
                   model=SE2Model, robust=robust, **LIN)
    return js, ts


def test_ops_partition_edges(problem):
    """The low-rank edges and their endpoints are the JAX one-hots'
    (each non-consecutive edge exactly once); U's plan puts edge c's
    blocks in column block c at its endpoints' rows."""
    c = problem
    ij = c["g"].edges_ij
    jops = jbuild(ij, c["g"].num_nodes, dtype=jnp.float64)
    ops = build_woodbury_ops(ij, c["g"].num_nodes)
    sel = np.asarray(jops.sel)
    np.testing.assert_array_equal(ops.lowrank.numpy(), sel.argmax(axis=1))
    np.testing.assert_array_equal(ops.plan_a.idx.numpy(),
                                  np.asarray(jops.inc_a).argmax(axis=1))
    np.testing.assert_array_equal(ops.plan_b.idx.numpy(),
                                  np.asarray(jops.inc_b).argmax(axis=1))
    assert ops.num_lowrank == jops.num_lowrank
    C = ops.num_lowrank
    k = np.arange(C)
    np.testing.assert_array_equal(
        ops.plan_u.idx.numpy(),
        np.concatenate([ij[sel.argmax(1), 0] * C + k,
                        ij[sel.argmax(1), 1] * C + k]))


def test_cr_solve_mrhs_matches_single(problem):
    c = problem
    _, ts = _systems(c, "dcs")
    Hd, _ = linear.damped_diag(ts, torch.tensor(1e-3, dtype=torch.float64))
    factors = tridiag.build_cr_factors(*tridiag.extract_tridiag(
        ts, c["te"], Hd))
    R = torch.as_tensor(np.random.default_rng(0).normal(
        size=(c["g"].num_nodes, 3, 5)))
    out = tridiag.cr_solve_mrhs(factors, R)
    for k in range(5):
        np.testing.assert_allclose(
            out[:, :, k].numpy(), tridiag.cr_solve(factors, R[:, :, k]).numpy(),
            atol=1e-12)


@pytest.mark.parametrize("robust", ["none", "dcs", "sc_varpro"])
@pytest.mark.parametrize("lam", [1e-4, 1.0])
def test_woodbury_matches_jax_and_dense(problem, robust, lam):
    c = problem
    ij, n = c["g"].edges_ij, c["g"].num_nodes
    js, ts = _systems(c, robust)
    jdx = jsolve(js, c["je"], jbuild(ij, n, dtype=jnp.float64),
                 jnp.float64(lam))
    lam_t = torch.tensor(lam, dtype=torch.float64)
    dx = woodbury_solve(ts, c["te"], build_woodbury_ops(ij, n), lam_t)
    dense = linear.dense_solve(ts, c["te"], lam_t, linear.dense_plan(c["te"]))
    np.testing.assert_allclose(dx.poses.numpy(), np.asarray(jdx.poses),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(dx.poses.numpy(), dense.poses.numpy(),
                               rtol=0, atol=TOL)


def test_padded_ops_and_edge_set_are_neutral(problem):
    """The bucket-padded edge set of the global solve (inactive (0, 0)
    self-loops, each a low-rank column of weight 0) gives the step of
    the unpadded operators."""
    c = problem
    ij, n = c["g"].edges_ij, c["g"].num_nodes
    _, ts = _systems(c, "dcs")
    lam = torch.tensor(1e-3, dtype=torch.float64)
    ops = build_woodbury_ops(ij, n)
    base = woodbury_solve(ts, c["te"], ops, lam)
    te = edge_set_from_graph(convert.graph_from_jax(c["g"]), pad_to=256)
    tsp = linearize(torch.as_tensor(c["poses"]),
                    torch.ones(256, dtype=torch.float64), te, c["tf"],
                    model=SE2Model, robust="dcs", **LIN)
    pops = build_woodbury_ops(te.ij.numpy(), n)
    assert pops.num_lowrank == ops.num_lowrank + 256 - c["g"].num_edges
    dxp = woodbury_solve(tsp, te, pops, lam)
    np.testing.assert_allclose(dxp.poses.numpy(), base.poses.numpy(),
                               rtol=0, atol=TOL)


def _lm_pair(c, robust):
    ij, n = c["g"].edges_ij, c["g"].num_nodes
    E = c["te"].num_edges
    cfg = SolverConfig(robust=robust, linear_solver="woodbury",
                       dtype="float64")
    j = jlm_solve(jnp.asarray(c["poses"]), jnp.ones(E), c["je"], c["jf"],
                  cfg, partition=jbuild(ij, n, dtype=jnp.float64))
    args = (torch.as_tensor(c["poses"]), torch.ones(E, dtype=torch.float64),
            c["te"], c["tf"])
    t = lm_solve(*args, convert.config_from_jax(cfg),
                 partition=build_woodbury_ops(ij, n))
    return j, t, args, cfg


def test_lm_woodbury_matches_jax_and_dense_trajectory(problem):
    c = problem
    j, t, args, cfg = _lm_pair(c, "dcs")
    assert t.iterations == int(j.iterations)
    assert int(t.accepted) == int(j.accepted)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=TOL)
    d = lm_solve(*args, convert.config_from_jax(
        cfg.replace(linear_solver="dense")))
    assert d.iterations == t.iterations
    np.testing.assert_allclose(t.poses.numpy(), d.poses.numpy(), rtol=0,
                               atol=TOL)


def test_woodbury_joint_sc_matches_jax(problem):
    """Joint SC eliminates its switches first and back-substitutes: the
    JAX trajectory to 1e-9, switches included, and the dense joint
    solve's on/off switch classification (the JAX test's gate)."""
    c = problem
    j, t, args, cfg = _lm_pair(c, "sc")
    assert t.iterations == int(j.iterations)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(t.switches.numpy(), np.asarray(j.switches),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=TOL)
    d = lm_solve(*args, convert.config_from_jax(
        cfg.replace(linear_solver="dense")))
    assert abs(float(t.cost) - float(d.cost)) < 2e-2 * max(1.0,
                                                          float(d.cost))
    loop = c["g"].edge_type != 0
    np.testing.assert_array_equal(t.switches.numpy()[loop] > 0.5,
                                  d.switches.numpy()[loop] > 0.5)


def test_woodbury_no_lowrank_edges():
    """A pure chain: C == 0 takes the cyclic-reduction solve alone."""
    graph, _ = synthetic.circle_se2(n=32, seed=3)
    g = graph.canonical_order()
    keep = np.abs(g.edges_ij[:, 0] - g.edges_ij[:, 1]) == 1
    g = dataclasses.replace(g, edges_ij=g.edges_ij[keep],
                            edges_meas=g.edges_meas[keep],
                            edges_info=g.edges_info[keep],
                            edge_type=g.edge_type[keep])
    c = _case(g)
    ops = build_woodbury_ops(g.edges_ij, g.num_nodes)
    assert ops.num_lowrank == 0
    js, ts = _systems(c, "none")
    lam = torch.tensor(1e-3, dtype=torch.float64)
    dx = woodbury_solve(ts, c["te"], ops, lam)
    jdx = jsolve(js, c["je"], jbuild(g.edges_ij, g.num_nodes,
                                     dtype=jnp.float64), jnp.float64(1e-3))
    dense = jlinear.dense_solve(js, c["je"], jnp.float64(1e-3))
    np.testing.assert_allclose(dx.poses.numpy(), np.asarray(jdx.poses),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(dx.poses.numpy(), np.asarray(dense.poses),
                               rtol=0, atol=TOL)


def _final_cost(log_path):
    with open(log_path) as f:
        line = [ln for ln in f if ln.startswith("[solve] ")][-1]
    return float(dict(w.split("=", 1) for w in line.split()[1:]
                      if "=" in w)["final_cost"])


@pytest.mark.parametrize("method", [0, 2])
def test_cli_woodbury_matches_jax_cli(circle_outliers, tmp_path, method):
    """``--linear-solver woodbury`` through both command lines: the same
    ``[woodbury] lowrank_edges`` record and final cost (method 1's rescue
    runs the same solver over several masks; the global-solve tests hold
    it record for record)."""
    from slam_tpu import cli as jcli
    from slam_tpu_torch import cli

    graph, _ = circle_outliers
    path = str(tmp_path / "circle.g2o")
    g2o.write_g2o(path, graph)
    argv = [path, "5", str(method), "--max-iterations", "10",
            "--linear-solver", "woodbury"]
    assert jcli.main(argv + ["--save-path", str(tmp_path / "j")]) == 0
    assert cli.main(argv + ["--device", "cpu", "--save-path",
                            str(tmp_path / "t")]) == 0
    log = f"method{method}.log"
    for side in ("j", "t"):
        with open(os.path.join(tmp_path, side, log)) as f:
            assert any(ln.startswith("[woodbury] lowrank_edges=")
                       for ln in f)
    np.testing.assert_allclose(_final_cost(tmp_path / "t" / log),
                               _final_cost(tmp_path / "j" / log), rtol=TOL)
    if method == 2:
        assert (tmp_path / "t" / "switches.txt").is_file()
