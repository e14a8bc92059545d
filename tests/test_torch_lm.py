"""The port's LM loop against the JAX package's, float64 on the CPU: the
circle fixture with outliers (dense solver) and a small Schur case.  Costs
agree to 1e-9 and the accept/reject sequences are identical."""

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
from slam_tpu_torch.solver import lm as tlm
from slam_tpu_torch.solver import problem as tp

STEPS = 12


def _setup(graph, nblocks=None):
    g = graph.canonical_order()
    je = jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=256,
                                incidence=False)
    te = tp.edge_set_from_graph(g, dtype=torch.float64, pad_to=256)
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
                     c["te"], c["tf"], cfg, partition=c["tpart"])
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
                               c["te"], c["tf"], cfg, 1,
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
                           c["tf"], cfg, STEPS, partition=c["tpart"])
    assert int(t.accepted) == int(j.accepted)
    assert t.iterations == int(j.iterations) == STEPS
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-9)


def test_unported_solvers_raise(dense_case):
    c = dense_case
    E = c["je"].num_edges
    args = (torch.as_tensor(c["g"].poses), torch.ones(E, dtype=torch.float64),
            c["te"], c["tf"])
    for cfg in (SolverConfig(robust="sc", linear_solver="dense",
                             dtype="float64"),
                SolverConfig(robust="dcs", linear_solver="pcg",
                             dtype="float64")):
        with pytest.raises(NotImplementedError):
            tlm.lm_solve(*args, cfg)
    with pytest.raises(ValueError):
        tlm.lm_solve(*args, SolverConfig(robust="dcs", linear_solver="schur",
                                         dtype="float64"))
