"""The managers' candidate evaluations folded into one batched short solve
(``solver/batch.py``: ``candidate_plan``, ``lm_fixed_iters_candidates``;
``methods/batched.py``; ``ShortSolves`` and the fused engines), float64
on the CPU.

The fixture is the dirty circle of ``tests/test_torch_methods.py``
(``synthetic.circle_se2(n=64, seed=1)`` plus 6 outliers, seed 9).  The
Schur eval takes ``BLOCKS`` index blocks in both packages; the PCG eval
the managers' accuracy (``LayeringConfig``'s ``eval_pcg_rtol`` and
``eval_pcg_max_iters``), each lane with its own CG scalars and stopping
test.  Tolerances:
each folded lane against the JAX package's ``vmap`` of ``lm_fixed_iters``
(``slam_tpu/methods/batched.py``, and the fused engines' eval with the
partition) within ``JAX_TOL``, and against the port's own solve of that
candidate alone within ``SELF_TOL``, the rows its free mask holds equal
to the bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.io import synthetic
from slam_tpu.methods import batched as jbatched
from slam_tpu.solver import schur as js
from slam_tpu.solver.lm import lm_fixed_iters as jlm_fixed_iters
from slam_tpu.solver.problem import FreeMask as JFreeMask, \
    anchor_first_node as janchor, edge_set_from_graph as jedges
from slam_tpu_torch import convert
from slam_tpu_torch.config import LayeringConfig, MctsConfig, SolverConfig
from slam_tpu_torch.methods import batched, layering_fused, mcts_fused
from slam_tpu_torch.methods.layering import LayeringManager, ShortSolves
from slam_tpu_torch.methods.mcts import MctsManager
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.utils.logging import RunLogger

BLOCKS = 4
JAX_TOL = 1e-9
SELF_TOL = 1e-12
WIDTHS = (1, 2, 3, 10)
SOLVERS = ("schur", "dense", "pcg")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def circle():
    graph, _ = synthetic.circle_se2(n=64, seed=1)
    j = graph.add_random_outliers(6, seed=9)
    return j, convert.graph_from_jax(j).canonical_order()


def _pcg_kw(solver) -> dict:
    """The managers' PCG accuracy on the PCG eval."""
    if solver != "pcg":
        return {}
    lc = LayeringConfig()
    return dict(pcg_rtol=lc.eval_pcg_rtol,
                pcg_max_iters=lc.eval_pcg_max_iters)


def port_setup(t, solver, trust_region="nielsen"):
    """(eval config, edge set, single plan) of the port."""
    cfg = SolverConfig(linear_solver=solver, dtype="float64", robust="none",
                       trust_region=trust_region, **_pcg_kw(solver))
    e = edge_set_from_graph(t, dtype=torch.float64)
    plan = (ts.build_partition(t.edges_ij, t.num_nodes, BLOCKS)
            if solver == "schur" else batched.eval_plan(cfg, e))
    return cfg, e, plan


def jax_setup(j, solver, trust_region="nielsen"):
    cfg = jcfg.SolverConfig(linear_solver=solver, dtype="float64",
                            robust="none", trust_region=trust_region,
                            **_pcg_kw(solver))
    e = jedges(j.canonical_order(), dtype=jnp.float64)
    part = (js.build_partition(np.asarray(e.ij), j.num_nodes, BLOCKS,
                               dtype=jnp.float64)
            if solver == "schur" else None)
    return cfg, e, part


def jax_solves(j, solver, trust_region, poses, masks, frees, iters):
    """``(poses, costs)`` of the JAX package's ``vmap``: on the dense and
    PCG evals its ``batched_masked_solve``, on the Schur eval the same
    ``vmap`` with the partition (as its fused engines' eval passes it)."""
    cfg, e, part = jax_setup(j, solver, trust_region)
    if part is None:
        p, c = jbatched.batched_masked_solve(poses, masks, frees, e, cfg,
                                             iters)
        return np.asarray(p), np.asarray(c)

    def one(p, a, f):
        res = jlm_fixed_iters(p, jnp.ones((e.num_edges,), jnp.float64),
                              e._replace(active=a), JFreeMask(node=f), cfg,
                              iters, partition=part)
        return res.poses, res.cost

    p, c = jax.vmap(one)(jnp.asarray(poses), jnp.asarray(masks),
                         jnp.asarray(frees))
    return np.asarray(p), np.asarray(c)


def candidates(t, width, seed, free_kinds=("first",)):
    """``width`` candidates: perturbed poses, random closure masks over the
    odometry, and free masks of the given kinds in turn ("first": node 0
    held; "window": method 3's commit window; "scattered": every third
    node held)."""
    rng = np.random.default_rng(seed)
    n = t.num_nodes
    loop = t.edge_type != 0
    poses = np.stack([t.poses + rng.normal(scale=0.05, size=t.poses.shape)
                      for _ in range(width)])
    masks = np.stack([~loop | (rng.random(loop.shape) < 0.5)
                      for _ in range(width)]).astype(np.float64)
    frees = []
    for k in range(width):
        kind = free_kinds[k % len(free_kinds)]
        f = np.ones(n)
        if kind == "first":
            f[0] = 0.0
        elif kind == "window":
            lo, hi = 5 + 4 * k, 26 + 4 * k
            f[:] = 0.0
            f[lo + 1:hi + 1] = 1.0
            inside = np.zeros(n, bool)
            inside[lo:hi + 1] = True
            masks[k] *= inside[t.edges_ij[:, 0]] & inside[t.edges_ij[:, 1]]
        else:
            f[k % 3::3] = 0.0
        frees.append(f)
    return poses, masks, np.stack(frees)


def alone(t, solver, trust_region, poses, masks, frees, iters):
    """Each candidate through the port's single masked solve."""
    cfg, e, plan = port_setup(t, solver, trust_region)
    out = [batched.masked_solve(torch.as_tensor(p), torch.as_tensor(m),
                                torch.as_tensor(f), e, cfg, iters, plan)
           for p, m, f in zip(poses, masks, frees)]
    return (np.stack([p.numpy() for p, _ in out]),
            np.array([float(c) for _, c in out]))


# ---------------------------------------------------------------------------
# The folded functions against the JAX vmap and against each lane alone
# ---------------------------------------------------------------------------

def fold_eval_cost(t, solver, trust_region, poses, masks):
    cfg, e, plan = port_setup(t, solver, trust_region)
    got = batched.batched_eval_cost(
        torch.as_tensor(poses), torch.as_tensor(masks), e,
        anchor_first_node(t.num_nodes), cfg, 2,
        tb.candidate_plan(e, cfg, plan, len(poses))).numpy()
    assert got.shape == (len(poses),)
    return got


def fold_masked_solve(t, solver, trust_region, poses, masks, frees):
    cfg, e, plan = port_setup(t, solver, trust_region)
    got_p, got_c = batched.batched_masked_solve(
        torch.as_tensor(poses), torch.as_tensor(masks),
        torch.as_tensor(frees), e, cfg, 2, plan)
    return got_p.numpy(), got_c.numpy()


#: Each width against the JAX vmap under one trust region, both regions
#: over the widths (a JAX compile per case); against each lane alone
#: under both.
JAX_CASES = [(s, w, "nielsen" if w in (1, 3) else "ceres")
             for s in SOLVERS for w in WIDTHS]
SELF_CASES = [(s, w, tr) for s in SOLVERS for w in WIDTHS
              for tr in ("nielsen", "ceres")]
MASKED_FREE = ("window", "scattered")


@pytest.mark.parametrize("solver,width,trust_region", JAX_CASES)
def test_folded_eval_cost_matches_the_jax_vmap(circle, solver, width,
                                               trust_region):
    j, t = circle
    poses, masks, frees = candidates(t, width, seed=width)
    got = fold_eval_cost(t, solver, trust_region, poses, masks)
    if solver in ("dense", "pcg"):
        jc, je, _ = jax_setup(j, solver, trust_region)
        want = np.asarray(jbatched.batched_eval_cost(
            poses, masks, je, janchor(t.num_nodes, dtype=jnp.float64), jc,
            2))
    else:
        _, want = jax_solves(j, solver, trust_region, poses, masks, frees,
                             2)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("solver,width,trust_region", SELF_CASES)
def test_folded_eval_cost_matches_each_lane_alone(circle, solver, width,
                                                  trust_region):
    _, t = circle
    poses, masks, frees = candidates(t, width, seed=width)
    got = fold_eval_cost(t, solver, trust_region, poses, masks)
    _, solo = alone(t, solver, trust_region, poses, masks, frees, 2)
    np.testing.assert_allclose(got, solo, rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("solver,width,trust_region", JAX_CASES)
def test_folded_masked_solve_matches_the_jax_vmap(circle, solver, width,
                                                  trust_region):
    """Windowed and scattered free masks in turns over the lanes."""
    j, t = circle
    poses, masks, frees = candidates(t, width, seed=20 + width,
                                     free_kinds=MASKED_FREE)
    got_p, got_c = fold_masked_solve(t, solver, trust_region, poses, masks,
                                     frees)
    want_p, want_c = jax_solves(j, solver, trust_region, poses, masks,
                                frees, 2)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=JAX_TOL)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("solver,width,trust_region", SELF_CASES)
def test_folded_masked_solve_matches_each_lane_alone(circle, solver, width,
                                                     trust_region):
    """Every lane pins its own rows, which stay equal to the bit."""
    _, t = circle
    poses, masks, frees = candidates(t, width, seed=20 + width,
                                     free_kinds=MASKED_FREE)
    got_p, got_c = fold_masked_solve(t, solver, trust_region, poses, masks,
                                     frees)
    solo_p, solo_c = alone(t, solver, trust_region, poses, masks, frees, 2)
    np.testing.assert_allclose(got_p, solo_p, rtol=0, atol=SELF_TOL)
    np.testing.assert_allclose(got_c, solo_c, rtol=0, atol=SELF_TOL)
    for k in range(width):
        fixed = frees[k] == 0
        assert fixed.any() and not fixed.all()
        np.testing.assert_array_equal(got_p[k][fixed], poses[k][fixed])
        assert not np.array_equal(got_p[k][~fixed], poses[k][~fixed])


@pytest.mark.parametrize("solver", SOLVERS)
def test_a_plan_of_another_width_is_refused(circle, solver):
    _, t = circle
    cfg, e, plan = port_setup(t, solver)
    poses, masks, frees = candidates(t, 3, seed=0)
    with pytest.raises(ValueError, match="2 lanes for a batch of 3"):
        batched.batched_masked_solve(
            torch.as_tensor(poses), torch.as_tensor(masks),
            torch.as_tensor(frees), e, cfg, 1,
            tb.candidate_plan(e, cfg, plan, 2))


# ---------------------------------------------------------------------------
# The engines: one folded call per spec group
# ---------------------------------------------------------------------------

def _count_calls(mp):
    """Count the folded calls and the single solves of the short solves."""
    n = {"folded": 0, "single": 0}
    fold, single = tb.lm_fixed_iters_candidates, batched.lm_fixed_iters

    def counted(key, fn):
        def call(*a, **k):
            n[key] += 1
            return fn(*a, **k)
        return call

    mp.setattr(tb, "lm_fixed_iters_candidates", counted("folded", fold))
    mp.setattr(batched, "lm_fixed_iters", counted("single", single))
    return n


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("method", [3, 4])
def test_fused_chunks_make_one_folded_call_per_spec_group(circle, method,
                                                          solver):
    """Per candidate: layering one folded call of 10 lanes and the
    commit; MCTS the split check's 3 lanes, the commit, the reward's 2;
    the stacked plans built before the first chunk, none inside one."""
    _, t = circle
    kw = dict(eval_linear=solver, eval_schur_blocks=BLOCKS, scan_chunk=4)
    if method == 3:
        cls, cfg, widths = (layering_fused.FusedLayeringManager,
                            LayeringConfig(local_iters=2, max_layers=8, **kw),
                            (10,))
    else:
        cls, cfg, widths = (mcts_fused.FusedMctsManager,
                            MctsConfig(max_layers=8, conflict_tau=0.0, **kw),
                            (3, 2))
    mgr = cls(t, cfg, SolverConfig(dtype="float64"), RunLogger(echo=False),
              device="cpu")
    assert sorted(mgr.ss.stacked) == sorted(widths)
    with pytest.MonkeyPatch.context() as mp:
        n = _count_calls(mp)
        mp.setattr(batched.batch, "candidate_plan", None)
        mgr.run()
    C = len(mgr.loop_indices)
    folds = 1 if method == 3 else 2
    assert n == {"folded": folds * C, "single": C}
    assert mgr.ss.calls == (folds + 1) * C
    assert mgr.ss.solves == (11 if method == 3 else 6) * C


@pytest.mark.parametrize("method", [3, 4])
def test_host_engines_fold_each_batch(circle, method):
    """The host engines: each ``ShortSolves.costs`` batch is one folded
    call (4-10 lanes a layering step; 3 and 2 a MCTS step), each width's
    plan built once; the commits are single solves."""
    _, t = circle
    solver = SolverConfig(linear_solver="dense", dtype="float64")
    if method == 3:
        mgr = LayeringManager(t, LayeringConfig(local_iters=2, max_layers=8),
                              solver, RunLogger(echo=False), device="cpu")
    else:
        mgr = MctsManager(t, MctsConfig(max_layers=8, conflict_tau=0.0),
                          solver, RunLogger(echo=False), device="cpu")
    built = []
    plan = tb.candidate_plan
    with pytest.MonkeyPatch.context() as mp:
        n = _count_calls(mp)
        mp.setattr(tb, "candidate_plan",
                   lambda *a: built.append(a[-1]) or plan(*a))
        mgr.run()
    assert len(built) == len(set(built)) == len(mgr.ss.stacked)
    assert n["folded"] + n["single"] == mgr.ss.calls < mgr.ss.solves
    if method == 3:
        assert n["single"] == n["folded"] == len(mgr.loop_indices)
        assert set(built) <= set(range(3, 11))
    else:
        assert set(built) <= {2, 3}


def test_short_solves_count_lanes_and_calls(circle):
    _, t = circle
    cfg, _, _ = port_setup(t, "dense")
    ss = ShortSolves(t, cfg, "cpu", widths=(4,))
    poses = ss.tensor(np.stack([t.poses] * 4))
    masks = ss.tensor(np.ones((4, t.num_edges)))
    got = ss.device_costs(poses, masks, 2)
    assert (ss.solves, ss.iterations, ss.calls) == (4, 8, 1)
    want = ss.costs([(p, np.ones(t.num_edges, bool)) for p in poses], 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(ss.stacked) == [4]


# ---------------------------------------------------------------------------
# The stack's factor and solve (the dense batch, the batched separators)
# ---------------------------------------------------------------------------

def test_cholesky_each_is_each_matrix_alone():
    """Each factor equals its matrix's factor alone to the bit, and a lane
    that is not SPD reports its own info (and no other lane's)."""
    from slam_tpu_torch.ops.stack_chol import stack_cholesky
    from slam_tpu_torch.solver.linear import cho_solve_stack

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(4, 30, 30)))
    A = X @ X.mT + 30 * torch.eye(30, dtype=torch.float64)
    A[2, 5, 5] = -1.0
    L, info = stack_cholesky(A)
    assert info.tolist() == [0, 0, 6, 0]
    for k in (0, 1, 3):
        assert torch.equal(L[k], torch.linalg.cholesky_ex(A[k])[0])
    ok = [0, 1, 3]
    b = torch.as_tensor(rng.normal(size=(3, 30, 2)))
    x = cho_solve_stack(L[ok], b)
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(A[ok], b).numpy(),
                               rtol=0, atol=1e-12)
