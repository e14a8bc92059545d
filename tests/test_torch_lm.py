"""The port's LM loop against the JAX package's, float64 on the CPU: the
circle fixture with outliers (dense solver) and a small Schur case.  Costs
agree to 1e-9 and the accept/reject sequences are identical.  Method 2
(joint switches and their variable projection) on the dense, Schur and PCG
solvers: identical accept sequences, cost, poses and switches to 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.config import SolverConfig
from slam_tpu.io import synthetic
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu_torch import convert
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver import lm as tlm
from slam_tpu_torch.solver import problem as tp

STEPS = 12


def _setup(graph, nblocks=None):
    g = graph.canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=256,
                                incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(g),
                                dtype=torch.float64, pad_to=256)
    jf = jp.anchor_first_node(g.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(g.num_nodes)
    jpart = tpart = None
    if nblocks:
        jpart = js.build_partition(np.asarray(je.ij), g.num_nodes, nblocks,
                                   dtype=jnp.float64)
        tpart = convert.partition_from_jax(jpart)
    return dict(g=g, je=je, te=te, jf=jf, tf=tf, jpart=jpart, tpart=tpart,
                solver="schur" if nblocks else "dense")


@pytest.fixture(scope="module")
def dense_case(circle_outliers):
    return _setup(circle_outliers[0])


@pytest.fixture(scope="module")
def schur_case():
    graph, _ = synthetic.circle_se2(n=96, seed=1)
    return _setup(graph.add_random_outliers(8, seed=2), nblocks=4)


def _run_lm_solve(c, cfg):
    p0 = c["g"].poses
    E = c["je"].num_edges
    j = jlm.lm_solve(jnp.asarray(p0), jnp.ones(E), c["je"], c["jf"], cfg,
                     partition=c["jpart"])
    t = tlm.lm_solve(torch.as_tensor(p0), torch.ones(E, dtype=torch.float64),
                     c["te"], c["tf"], convert.config_from_jax(cfg),
                     partition=c["tpart"])
    return convert.lm_result_to_numpy(j), convert.lm_result_to_numpy(t)


@pytest.mark.parametrize("case", ["dense_case", "schur_case"])
@pytest.mark.parametrize("robust,gnc", [("dcs", 0), ("none", 0),
                                        ("dcs", 5)])
def test_lm_solve_matches(request, case, robust, gnc):
    c = request.getfixturevalue(case)
    cfg = SolverConfig(robust=robust, linear_solver=c["solver"],
                       dtype="float64", gnc_anneal_iters=gnc,
                       max_iterations=30, use_pallas="off")
    j, t = _run_lm_solve(c, cfg)
    for name in ("iterations", "accepted", "converged", "lin_iters"):
        assert int(t[name]) == int(j[name]), name
    for name in ("cost", "initial_cost", "final_lambda", "final_nu"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-9, err_msg=name)
    np.testing.assert_allclose(t["poses"], j["poses"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", ["dense_case", "schur_case"])
@pytest.mark.parametrize("trust_region", ["nielsen", "ceres"])
def test_lm_fixed_iters_sequence_matches(request, case, trust_region):
    """One iteration at a time, threading lam/nu/it through both packages:
    every step's cost and accept/reject decision agree."""
    c = request.getfixturevalue(case)
    cfg = SolverConfig(robust="dcs", linear_solver=c["solver"],
                       dtype="float64", trust_region=trust_region,
                       use_pallas="off")
    E = c["je"].num_edges
    jp_, tp_ = jnp.asarray(c["g"].poses), torch.as_tensor(c["g"].poses)
    jstate = tstate = (None, None, None)
    seq_j, seq_t = [], []
    for _ in range(STEPS):
        j = jlm.lm_fixed_iters(jp_, jnp.ones(E), c["je"], c["jf"], cfg, 1,
                               partition=c["jpart"], lam0=jstate[0],
                               nu0=jstate[1], it0=jstate[2])
        t = tlm.lm_fixed_iters(tp_, torch.ones(E, dtype=torch.float64),
                               c["te"], c["tf"], convert.config_from_jax(cfg),
                               1,
                               partition=c["tpart"], lam0=tstate[0],
                               nu0=tstate[1], it0=tstate[2])
        seq_j.append((int(j.accepted), float(j.cost)))
        seq_t.append((int(t.accepted), float(t.cost)))
        jp_, tp_ = j.poses, t.poses
        jstate = (j.final_lambda, j.final_nu, j.iterations)
        tstate = (t.final_lambda, t.final_nu, t.iterations)
    assert [a for a, _ in seq_t] == [a for a, _ in seq_j]
    np.testing.assert_allclose([x for _, x in seq_t], [x for _, x in seq_j],
                               rtol=1e-9)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=0,
                               atol=1e-8)


def test_lm_fixed_iters_one_call_matches(schur_case):
    c = schur_case
    cfg = SolverConfig(robust="dcs", linear_solver="schur", dtype="float64",
                       use_pallas="off")
    E = c["je"].num_edges
    j = jlm.lm_fixed_iters(jnp.asarray(c["g"].poses), jnp.ones(E), c["je"],
                           c["jf"], cfg, STEPS, partition=c["jpart"])
    t = tlm.lm_fixed_iters(torch.as_tensor(c["g"].poses),
                           torch.ones(E, dtype=torch.float64), c["te"],
                           c["tf"], convert.config_from_jax(cfg), STEPS,
                           partition=c["tpart"])
    assert int(t.accepted) == int(j.accepted)
    assert t.iterations == int(j.iterations) == STEPS
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-9)


def test_unported_solvers_raise(dense_case):
    c = dense_case
    E = c["je"].num_edges
    args = (torch.as_tensor(c["g"].poses), torch.ones(E, dtype=torch.float64),
            c["te"], c["tf"])
    from slam_tpu.solver.woodbury import build_woodbury_ops as jbuild
    from slam_tpu_torch.solver.woodbury import build_woodbury_ops

    ij, n = np.asarray(c["je"].ij), c["g"].num_nodes  # the padded edges
    for robust in ("sc", "dcs"):
        # Woodbury needs its operators, as in the JAX package.
        cfg = SolverConfig(robust=robust, linear_solver="woodbury",
                           dtype="float64")
        with pytest.raises(ValueError, match="WoodburyOps"):
            tlm.lm_solve(*args, convert.config_from_jax(cfg))
    # With them it runs and matches the JAX solve (joint SC on Woodbury:
    # tests/test_torch_woodbury.py).
    j = jlm.lm_solve(jnp.asarray(c["g"].poses), jnp.ones(E), c["je"],
                     c["jf"], cfg, partition=jbuild(ij, n, dtype=jnp.float64))
    t = tlm.lm_solve(*args, convert.config_from_jax(cfg),
                     partition=build_woodbury_ops(ij, n))
    assert t.iterations == int(j.iterations)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0,
                               atol=1e-9)
    with pytest.raises(ValueError):
        tlm.lm_solve(*args, convert.config_from_jax(
            SolverConfig(robust="dcs", linear_solver="schur",
                         dtype="float64")))
    # A pose-only dense plan does not serve the joint switch system.
    with pytest.raises(ValueError, match="dense plan"):
        tlm.lm_solve(*args, convert.config_from_jax(
            SolverConfig(robust="sc", linear_solver="dense",
                         dtype="float64")),
            partition=linear.dense_plan(c["te"]))


# Method 2 on each linear solver: the joint dense system, the switch
# elimination before the Schur solver (4 blocks), and PCG on the joint
# system (the circle fixture, no partition).
SWITCH_CASES = [("dense_case", "dense"), ("schur_case", "schur"),
                ("dense_case", "pcg")]


def _switch_cfg(c, solver, robust, **kw):
    return SolverConfig(robust=robust, linear_solver=solver, dtype="float64",
                        use_pallas="off", **kw)


def _close_results(t, j, lin_slack=0):
    assert int(t["iterations"]) == int(j["iterations"])
    assert int(t["accepted"]) == int(j["accepted"])
    assert bool(t["converged"]) == bool(j["converged"])
    assert abs(int(t["lin_iters"]) - int(j["lin_iters"])) <= lin_slack
    for name in ("cost", "initial_cost"):
        np.testing.assert_allclose(t[name], j[name], rtol=1e-8, err_msg=name)
    for name in ("poses", "switches"):
        np.testing.assert_allclose(t[name], j[name], rtol=0, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("case,solver", SWITCH_CASES)
@pytest.mark.parametrize("robust", ["sc", "sc_varpro"])
def test_lm_solve_switches_match(request, case, solver, robust):
    """The whole solve: iteration and accept counts identical; cost, poses
    and switches to 1e-8; on PCG the CG iterations within one per LM
    iteration (a stopping test at its threshold may flip)."""
    c = request.getfixturevalue(case)
    j, t = _run_lm_solve(c, _switch_cfg(c, solver, robust,
                                        max_iterations=30))
    slack = int(j["iterations"]) if solver == "pcg" else 0
    if solver == "pcg":
        assert int(j["lin_iters"]) > 0
    _close_results(t, j, lin_slack=slack)
    if robust == "sc":  # the switches moved
        assert np.abs(t["switches"] - 1.0).max() > 1e-3


@pytest.mark.parametrize("case,solver", SWITCH_CASES)
@pytest.mark.parametrize("robust", ["sc", "sc_varpro"])
def test_lm_fixed_iters_switches_sequence_matches(request, case, solver,
                                                  robust):
    """One iteration at a time: every step's accept/reject decision is the
    JAX package's, and the costs agree to 1e-8."""
    c = request.getfixturevalue(case)
    cfg = _switch_cfg(c, solver, robust)
    E = c["je"].num_edges
    jp_, tp_ = jnp.asarray(c["g"].poses), torch.as_tensor(c["g"].poses)
    js_, ts_ = jnp.ones(E), torch.ones(E, dtype=torch.float64)
    jstate = tstate = (None, None, None)
    seq_j, seq_t = [], []
    for _ in range(STEPS):
        j = jlm.lm_fixed_iters(jp_, js_, c["je"], c["jf"], cfg, 1,
                               partition=c["jpart"], lam0=jstate[0],
                               nu0=jstate[1], it0=jstate[2])
        t = tlm.lm_fixed_iters(tp_, ts_, c["te"], c["tf"],
                               convert.config_from_jax(cfg), 1,
                               partition=c["tpart"], lam0=tstate[0],
                               nu0=tstate[1], it0=tstate[2])
        seq_j.append((int(j.accepted), float(j.cost)))
        seq_t.append((int(t.accepted), float(t.cost)))
        jp_, tp_, js_, ts_ = j.poses, t.poses, j.switches, t.switches
        jstate = (j.final_lambda, j.final_nu, j.iterations)
        tstate = (t.final_lambda, t.final_nu, t.iterations)
    assert [a for a, _ in seq_t] == [a for a, _ in seq_j]
    np.testing.assert_allclose([x for _, x in seq_t], [x for _, x in seq_j],
                               rtol=1e-8)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=0,
                               atol=1e-8)


def test_lm_fixed_iters_pcg_counts_cg_iterations(dense_case):
    """``lin_iters`` of a fixed-iteration PCG run sums the CG iterations
    of every LM iteration; with rtol = 0 each runs ``pcg_max_iters``."""
    c = dense_case
    cfg = _switch_cfg(c, "pcg", "sc", pcg_max_iters=9, pcg_rtol=0.0)
    E = c["je"].num_edges
    j = jlm.lm_fixed_iters(jnp.asarray(c["g"].poses), jnp.ones(E), c["je"],
                           c["jf"], cfg, 4)
    t = tlm.lm_fixed_iters(torch.as_tensor(c["g"].poses),
                           torch.ones(E, dtype=torch.float64), c["te"],
                           c["tf"], convert.config_from_jax(cfg), 4)
    assert t.lin_iters == int(j.lin_iters) == 36
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-8)
