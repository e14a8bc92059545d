"""Joint switchable constraints (``robust="sc"``, method 2) in the port's
batch (``slam_tpu_torch/solver/batch.py``) on the CPU, float64: B seeds'
problems in one ``lm_fixed_iters_batch`` / ``lm_solve_batch`` on the
Schur (native and blocked), dense joint, PCG and Woodbury solvers,
against the JAX package's ``jax.vmap`` of ``lm_fixed_iters`` /
``lm_solve`` over the stacked edge sets and plans, and against the port's
unbatched run of each seed alone.

The fixture is ``tests/test_torch_batch.py``'s: the circle of
``tests/conftest.py`` (64 nodes) with the bogus loops of three seeds, 4
Schur index blocks padded to the seeds' maxima, 10 iterations, from the
circle's poses and from the hard start (each pose moved by N(0, 1)), where
steps are rejected.  Tolerances: against the JAX vmap 1e-9 relative in
cost, initial cost and final lambda, 1e-8 in poses and switches, accepted
steps equal (measured: at most 1.6e-12 relative and 2.0e-10 absolute).
Against each seed alone on its share of the batch's shapes (its padded
edges; on Schur its partition at the batch's pad shapes): 1e-12 relative
and 1e-11 absolute (measured: equal to the bit), and on the blocked Schur
factorisation 1e-9 and 1e-8 (measured: 4.8e-14 relative and 4.9e-12
absolute from the circle's start, 1.4e-12 and 3.9e-11 from the hard
start; the blocked factor's matmuls on the stacked separators and on one
round apart, as in ``tests/test_torch_batch.py``, and the rejections
amplify it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.io import synthetic
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu.solver import woodbury as jwood
from slam_tpu_torch import convert
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.lm import _solve_linear, lm_fixed_iters, lm_solve
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.solver.woodbury import build_woodbury_ops
from test_torch_batch import BLOCKS, ITERS, JAX_RTOL, SELF_RTOL, \
    _calls_per_iteration, graphs, hard, port_alone, rel  # noqa: F401

#: Each configuration: its solver and the SolverConfig fields it sets.
CONFIGS = {
    "schur-native": ("schur", {}),
    "schur-blocked": ("schur", dict(schur_blocked=True, schur_panel=16)),
    "dense": ("dense", {}),
    "pcg": ("pcg", {}),
    "woodbury": ("woodbury", {}),
}
JAX_ATOL = 1e-8
BLOCKED_SELF_RTOL = 1e-9
LAMS = (1e-4, 1e-2, 1.0)
KW = dict(dcs_phi=1.0, huber_delta=1.0, sc_prior_lambda=1.0)

torch.set_num_threads(2)


def jax_config(name: str, **kw) -> jcfg.SolverConfig:
    solver, fields = CONFIGS[name]
    return jcfg.SolverConfig(robust="sc", linear_solver=solver,
                             dtype="float64", **fields, **kw)


def jax_plans(solver: str, sets: list, n: int):
    """Each seed's JAX plan, padded to shared shapes as the port pads its
    own (``bench.py``'s partitions, ``scripts/bench_woodbury.py``'s
    ``pad_to``); None for the dense and PCG solvers."""
    ijs = [np.asarray(e.ij) for e in sets]
    if solver == "schur":
        stats = [js.partition_stats(ij, n, BLOCKS) for ij in ijs]
        pad = tuple(max(s[i] for s in stats) for i in range(len(stats[0])))
        return [js.build_partition(ij, n, BLOCKS, dtype=jnp.float64,
                                   pad_shapes=pad) for ij in ijs]
    if solver == "woodbury":
        cmax = max(jwood.build_woodbury_ops(ij, n).num_lowrank
                   for ij in ijs)
        return [jwood.build_woodbury_ops(ij, n, dtype=jnp.float64,
                                         pad_to=cmax) for ij in ijs]
    return None


@functools.lru_cache(maxsize=None)
def _jax_solver(cfg, n, e, iters):
    """The jitted ``vmap`` of ``lm_fixed_iters`` (``lm_solve`` when
    ``iters`` is None) under ``cfg``, compiled once for both starts."""
    free = jp.anchor_first_node(n, dtype=jnp.float64)
    sw0 = jnp.ones((e,), jnp.float64)

    def one(p, es, part):
        if iters is None:
            return jlm.lm_solve(p, sw0, es, free, cfg, partition=part)
        return jlm.lm_fixed_iters(p, sw0, es, free, cfg, iters,
                                  partition=part)

    return jax.jit(jax.vmap(one))


def jax_batch(start, jc, iters=ITERS) -> dict:
    """The JAX package's vmap over the stacked seeds."""
    e = max(g.num_edges for g in start)
    n = start[0].num_nodes
    sets = [jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=e,
                                   incidence=False) for g in start]
    plans = jax_plans(jc.linear_solver, sets, n)

    def stack(xs):
        return None if xs is None else jax.tree.map(
            lambda *x: jnp.stack(x), *xs)

    p0 = jnp.stack([jnp.asarray(g.poses, jnp.float64) for g in start])
    return convert.lm_result_to_numpy(_jax_solver(jc, n, e, iters)(
        p0, stack(sets), stack(plans)))


def port_plan(b: tb.SeedBatch, solver: str):
    """The batch's plan: the stacked partition on Schur, else
    :func:`tb.batch_plan` under joint SC."""
    if solver == "schur":
        return b.partition
    return tb.batch_plan(b.edges, solver, b.seeds, "sc")


def seed_batch(start) -> tb.SeedBatch:
    return tb.seed_batch([convert.graph_from_jax(g) for g in start], BLOCKS)


def alone_plan(solver: str, e, n: int):
    """One seed's own plan on its padded edges (Schur's is built by
    :func:`port_alone`)."""
    if solver == "dense":
        return linear.dense_plan(e, switches=True)
    if solver == "woodbury":
        return build_woodbury_ops(e.ij.numpy(), n)
    return None


def run_alone(g, b, cfg, iters=ITERS):
    """One seed alone on its share of the batch's shapes."""
    if cfg.linear_solver == "schur":
        return port_alone(g, cfg, iters=iters, batch=b)
    e = edge_set_from_graph(convert.graph_from_jax(g).canonical_order(),
                            pad_to=b.switches0.shape[1])
    args = (torch.as_tensor(g.poses, dtype=torch.float64),
            torch.ones(e.num_edges, dtype=torch.float64), e,
            anchor_first_node(g.num_nodes), cfg)
    plan = alone_plan(cfg.linear_solver, e, g.num_nodes)
    if iters is None:
        return lm_solve(*args, partition=plan)
    return lm_fixed_iters(*args, iters, partition=plan)


def assert_lanes(got: dict, want: dict, rtol: float, atol: float,
                 what: str) -> None:
    """Cost, initial cost and final lambda within ``rtol``; poses and
    switches within ``atol``; accepted steps equal."""
    for f in ("cost", "initial_cost", "final_lambda"):
        assert rel(got[f], want[f]).max() <= rtol, (what, f, got[f],
                                                    want[f])
    for f in ("poses", "switches"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=atol,
                                   err_msg=f"{what} {f}")
    np.testing.assert_array_equal(got["accepted"], want["accepted"],
                                  err_msg=what)


def lane_of(res: dict, i: int) -> dict:
    return {k: v[i] for k, v in res.items()
            if isinstance(v, np.ndarray) and v.ndim}


@pytest.mark.parametrize("start", ["circle", "hard"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sc_batch_matches_jax_vmap_and_each_seed_alone(graphs, hard, name,
                                                       start):
    """(a) each lane against the JAX vmap's; (b) against its seed alone."""
    seeds = graphs if start == "circle" else hard
    jc = jax_config(name)
    cfg = convert.config_from_jax(jc)
    b = seed_batch(seeds)
    res = tb.lm_fixed_iters_batch(*b.args, cfg, ITERS,
                                  partition=port_plan(b, cfg.linear_solver))
    got = convert.lm_result_to_numpy(res)
    assert got["poses"].shape == (3, 64, 3)
    assert got["switches"].shape == (3, b.switches0.shape[1])
    assert_lanes(got, jax_batch(seeds, jc), JAX_RTOL, JAX_ATOL, "jax")
    tol = BLOCKED_SELF_RTOL if cfg.schur_blocked else SELF_RTOL
    for i, g in enumerate(seeds):
        alone = convert.lm_result_to_numpy(run_alone(g, b, cfg))
        assert_lanes(lane_of(got, i), alone, tol, tol * 10, f"seed {i}")
        if cfg.linear_solver == "pcg":
            assert got["lin_iters"][i] == alone["lin_iters"] > 0
    if start == "hard":  # steps are rejected
        assert (got["accepted"] < ITERS).any()


def test_sc_lm_solve_batch_matches_jax_vmap_and_each_seed(graphs):
    """(c) ``lm_solve_batch`` under joint SC (Schur, native) against
    ``jax.vmap(lm_solve)`` and each lane alone: each stops at its own
    convergence (a function tolerance of 1e-3, where the lanes converge
    after 18, 4 and 5 iterations; at the default none converges in 40)."""
    jc = jax_config("schur-native", max_iterations=40,
                    function_tolerance=1e-3)
    cfg = convert.config_from_jax(jc)
    b = seed_batch(graphs)
    got = convert.lm_result_to_numpy(tb.lm_solve_batch(
        *b.args, cfg, b.partition))
    want = jax_batch(graphs, jc, iters=None)
    assert_lanes(got, want, JAX_RTOL, JAX_ATOL, "jax")
    for f in ("iterations", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["converged"].all() and len(set(got["iterations"])) > 1
    for i, g in enumerate(graphs):
        alone = convert.lm_result_to_numpy(run_alone(g, b, cfg, None))
        assert_lanes(lane_of(got, i), alone, SELF_RTOL, SELF_RTOL * 10,
                     f"seed {i}")
        for f in ("iterations", "converged"):
            assert got[f][i] == alone[f], (i, f)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sc_batched_iteration_launches_as_one_seed(graphs, name):
    """(d) per LM iteration the batch calls each kernel wrapper as often
    as one seed alone, and joint SC never the fused linearisation (it
    takes the plain chain).  Blocked: float32 with the panel kernel, 8
    blocks; PCG: every CG run to 12 iterations."""
    solver, fields = CONFIGS[name]
    blocked = name == "schur-blocked"
    dtype = torch.float32 if blocked else torch.float64
    blocks = 8 if blocked else BLOCKS
    cfg = tb.SolverConfig(
        robust="sc", linear_solver=solver,
        dtype=str(dtype).replace("torch.", ""), **fields,
        **(dict(schur_pallas_micro=True) if blocked else {}),
        **(dict(pcg_rtol=0.0, pcg_max_iters=12) if solver == "pcg"
           else {}))
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], blocks,
                      dtype=dtype)
    plan = port_plan(b, solver)
    g = convert.graph_from_jax(graphs[0]).canonical_order()
    e = edge_set_from_graph(g, dtype=dtype, pad_to=b.switches0.shape[1])
    if solver == "schur":
        own = ts.partition_from_slots(
            ts.build_slots(np.asarray(e.ij), 64, blocks,
                           pad_shapes=b.pad_shapes), dtype=dtype)
    else:
        own = alone_plan(solver, e, 64)
    alone = (torch.as_tensor(g.poses, dtype=dtype),
             torch.ones(e.num_edges, dtype=dtype), e,
             anchor_first_node(64, dtype=dtype))
    per_batch = _calls_per_iteration(lambda k: tb.lm_fixed_iters_batch(
        *b.args, cfg, k, partition=plan))
    per_seed = _calls_per_iteration(lambda k: lm_fixed_iters(
        *alone, cfg, k, partition=own))
    assert per_batch == per_seed
    assert per_batch.get("fused_linearize_se2_indexed", 0) == 0
    assert per_batch["gather_rows"] > 0
    assert per_batch.get("scatter_add_rows", 0) + per_batch.get(
        "scatter_add_groups", 0) > 0
    assert per_batch.get("micro_chol_inv", 0) == (
        -(-b.partition.ni_max * 3 // 16) if blocked else 0)


def linearised_lanes(outliers: tuple) -> dict:
    """Seeds of the circle with ``outliers`` bogus loops each (their edge
    sets padded to the largest), linearised under joint SC at moved poses
    as one batch and each alone."""
    g0, _ = synthetic.circle_se2(n=64, seed=1)
    gs = [convert.graph_from_jax(g0.add_random_outliers(k, seed=s)
                                 .canonical_order())
          for s, k in enumerate(outliers)]
    b = tb.seed_batch(gs, BLOCKS)
    S, E = b.seeds, b.switches0.shape[1]
    rng = np.random.default_rng(3)
    poses = b.poses0.numpy() + rng.normal(scale=0.05, size=(S, 64, 3))
    sw = 1.0 - 0.5 * rng.random((S, E))
    system = tl.linearize(torch.as_tensor(poses).reshape(-1, 3),
                          torch.as_tensor(sw).reshape(-1), b.edges, b.free,
                          model=SE2Model, robust="sc", seeds=S, **KW)
    alone = []
    for k, g in enumerate(gs):
        e = edge_set_from_graph(g, pad_to=E)
        alone.append((tl.linearize(torch.as_tensor(poses[k]),
                                   torch.as_tensor(sw[k]), e,
                                   anchor_first_node(64), model=SE2Model,
                                   robust="sc", **KW), e))
    lam = linear.lane_rows(torch.tensor(LAMS, dtype=torch.float64),
                           torch.zeros(S * 64, 3), S)
    return dict(batch=b, system=system, alone=alone, lam=lam, S=S, E=E)


@pytest.mark.parametrize("outliers", [(7, 4, 2), (8, 8, 5)])
def test_joint_batch_plan_assembles_each_lane_as_alone(outliers,
                                                       monkeypatch):
    """(e) lane k's assembled joint matrix (padded switch rows included)
    is its ``JointPlan`` matrix alone to the bit, with lane edge counts
    that are not multiples of D; and each lane's solve is its solve
    alone."""
    lanes = linearised_lanes(outliers)
    S, E, b = lanes["S"], lanes["E"], lanes["batch"]
    assert E % 3 != 0
    held = []
    finish = linear._finish_dense
    monkeypatch.setattr(linear, "_finish_dense", lambda H, *a: (
        held.append(H), finish(H, *a))[1])
    plan = linear.dense_plan(b.edges, switches=True, seeds=S)
    assert plan.seeds == S and plan.row_sel.shape == (S * E, 3)
    dx = linear.dense_solve(lanes["system"], b.edges, lanes["lam"], plan)
    H = held.pop()
    dim = 64 * 3 + E
    assert H.shape == (S, dim, dim)
    for k, (system, e) in enumerate(lanes["alone"]):
        one = linear.dense_solve(system, e, torch.tensor(
            LAMS[k], dtype=torch.float64), linear.dense_plan(
                e, switches=True))
        assert torch.equal(H[k], held.pop())
        np.testing.assert_allclose(dx.poses[k * 64:(k + 1) * 64],
                                   one.poses, rtol=0, atol=1e-12)
        np.testing.assert_allclose(dx.switches[k * E:(k + 1) * E],
                                   one.switches, rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver", ["schur", "woodbury"])
def test_eliminate_switches_damps_each_lane_with_its_lambda(solver):
    """(f) on lanes at different lambda, each lane's reduced system and
    back-substitution are its own alone to the bit; and the batched step
    of the Schur / Woodbury solver is each lane's step alone."""
    lanes = linearised_lanes((6, 6, 6))
    S, E, b = lanes["S"], lanes["E"], lanes["batch"]
    reduced, backsub = linear.eliminate_switches(
        lanes["system"], b.edges, lanes["lam"], S)
    xp = torch.as_tensor(np.random.default_rng(5).normal(size=(S * 64, 3)))
    xs = backsub(xp)
    for k, (system, e) in enumerate(lanes["alone"]):
        lam = torch.tensor(LAMS[k], dtype=torch.float64)
        one, back = linear.eliminate_switches(system, e, lam)
        nodes, edges = slice(k * 64, (k + 1) * 64), slice(k * E, (k + 1) * E)
        for f in ("Hdiag", "g"):
            assert torch.equal(getattr(reduced, f)[nodes], getattr(one, f))
        for f in ("Hoff", "Hss", "gs"):
            assert torch.equal(getattr(reduced, f)[edges], getattr(one, f))
        assert torch.equal(xs[edges], back(xp[nodes]))
    cfg = tb.SolverConfig(robust="sc", linear_solver=solver,
                          dtype="float64")
    if solver == "schur":
        plan = b.partition
    else:
        plan = tb.batch_plan(b.edges, solver, S, "sc")
    dx, _ = _solve_linear(lanes["system"], b.edges, lanes["lam"], cfg, plan)
    for k, (system, e) in enumerate(lanes["alone"]):
        if solver == "schur":
            own = ts.partition_from_slots(ts.build_slots(
                e.ij.numpy(), 64, BLOCKS, pad_shapes=b.pad_shapes))
        else:
            own = build_woodbury_ops(e.ij.numpy(), 64)
        one, _ = _solve_linear(system, e, torch.tensor(
            LAMS[k], dtype=torch.float64), cfg, own)
        np.testing.assert_allclose(dx.poses[k * 64:(k + 1) * 64], one.poses,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(dx.switches[k * E:(k + 1) * E],
                                   one.switches, rtol=0, atol=1e-12)


@pytest.mark.parametrize("robust", ["sc", "dcs"])
def test_a_dense_batch_plan_of_the_other_kind_raises(graphs, robust):
    """(g) a pose-only dense batch plan under joint SC, or a joint one
    under DCS, is refused as a single problem's is."""
    b = seed_batch(graphs)
    cfg = tb.SolverConfig(robust=robust, linear_solver="dense",
                          dtype="float64")
    other = tb.batch_plan(b.edges, "dense", b.seeds,
                          "dcs" if robust == "sc" else "sc")
    with pytest.raises(ValueError, match="does not match"):
        tb.lm_fixed_iters_batch(*b.args, cfg, 1, partition=other)
