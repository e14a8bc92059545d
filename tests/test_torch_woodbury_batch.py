"""The batched Woodbury solver of the port on the CPU, float64: B problems'
chain + low-rank solves as one solve over their lanes
(``woodbury.build_woodbury_ops(seeds=)``, ``woodbury_solve``; the Woodbury
seed and chain batches of ``solver/batch.py``), against the JAX package's
``jax.vmap(woodbury_solve)`` over ops built with ``pad_to`` (as
``scripts/bench_woodbury.py`` builds them) and against each lane alone.

The fixture is the circle of ``tests/conftest.py`` (64 nodes) with the
bogus loops of three seeds (``OUTLIERS`` each); the third seed's graph
lacks one odometry edge, so that its low-rank count (13, with the
self-loop that pads its edges) is not the others' (12), and their ops
are padded.  The solves are linearised at poses moved by N(0, 0.05) and
damped with a different lambda per lane.  Tolerances: each lane against
the JAX vmap within ``JAX_TOL`` (relative to the largest entry), against
the port's solve of that lane alone within ``SELF_TOL`` (measured: the
unpadded lane equal to the bit, the padded ones within 4.3e-14: their
cores are one column larger).  The LM runs take at most ``ITERS``
iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.methods import global_solve as jgs
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import woodbury as jwood
from slam_tpu.solver.models import SE2Model as JSE2
from slam_tpu_torch import convert
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear as tlin
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver.linearize import loop_psi
from slam_tpu_torch.solver.lm import lm_fixed_iters, lm_solve
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.solver.woodbury import build_woodbury_ops, \
    woodbury_solve
from test_torch_batch import _calls_per_iteration
from test_torch_rescue_batch import chains, dirty  # noqa: F401 (fixtures)

SEEDS = (0, 1, 2)
OUTLIERS = 6
BLOCKS = 4
ITERS = 5
LAMS = (1e-4, 1e-2, 1.0)
KW = dict(dcs_phi=1.0, huber_delta=1.0, sc_prior_lambda=1.0)
JAX_TOL = 1e-9
SELF_TOL = 1e-12

torch.set_num_threads(2)


def _close(t, j, tol, err_msg=""):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale,
                               err_msg=err_msg)


def _drop_odometry_edge(g, k):
    """``g`` without its ``k``-th edge between consecutive nodes."""
    keep = np.ones(g.num_edges, bool)
    keep[np.flatnonzero(np.abs(g.edges_ij[:, 0] - g.edges_ij[:, 1])
                        == 1)[k]] = False
    return dataclasses.replace(g, edges_ij=g.edges_ij[keep],
                               edges_meas=g.edges_meas[keep],
                               edges_info=g.edges_info[keep],
                               edge_type=g.edge_type[keep])


@pytest.fixture(scope="module")
def graphs(circle):
    g, _ = circle
    out = [g.add_random_outliers(OUTLIERS, seed=s).canonical_order()
           for s in SEEDS]
    out[2] = _drop_odometry_edge(out[2], 20)
    return out


def _jax_sets(graphs):
    E = max(g.num_edges for g in graphs)
    sets = [jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=E,
                                   incidence=False) for g in graphs]
    n = graphs[0].num_nodes
    cmax = max(jwood.build_woodbury_ops(np.asarray(e.ij), n).num_lowrank
               for e in sets)
    ops = [jwood.build_woodbury_ops(np.asarray(e.ij), n, dtype=jnp.float64,
                                    pad_to=cmax) for e in sets]
    stack = lambda xs: jax.tree.map(lambda *x: jnp.stack(x), *xs)  # noqa
    return sets, stack(sets), stack(ops), cmax


@pytest.fixture(scope="module")
def lanes(graphs):
    """The seeds' problems linearised at moved poses: the port's batch and
    each seed alone, and the JAX package's stacked systems and ops."""
    n = graphs[0].num_nodes
    rng = np.random.default_rng(4)
    poses = np.stack([g.poses + rng.normal(scale=0.05, size=g.poses.shape)
                      for g in graphs])
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    S, E = b.seeds, b.switches0.shape[1]
    system = tl.linearize(torch.as_tensor(poses).reshape(-1, 3),
                          b.switches0.reshape(-1), b.edges, b.free,
                          model=SE2Model, robust="dcs", seeds=S, **KW)
    alone = []
    for k, g in enumerate(graphs):
        e = edge_set_from_graph(convert.graph_from_jax(g), pad_to=E)
        alone.append((tl.linearize(torch.as_tensor(poses[k]),
                                   torch.ones(E, dtype=torch.float64), e,
                                   anchor_first_node(n), model=SE2Model,
                                   robust="dcs", **KW), e))
    sets, jedges, jops, cmax = _jax_sets(graphs)
    jf = jp.anchor_first_node(n, dtype=jnp.float64)
    jsys = [jl.linearize(jnp.asarray(p), jnp.ones(E), e, jf, model=JSE2,
                         robust="dcs", **KW) for p, e in zip(poses, sets)]
    return dict(batch=b, system=system, alone=alone, S=S, n=n, E=E,
                cmax=cmax, jedges=jedges, jops=jops,
                jsys=jax.tree.map(lambda *x: jnp.stack(x), *jsys))


def _lam_nodes(lams, S, n):
    return tlin.lane_rows(torch.tensor(lams, dtype=torch.float64),
                          torch.zeros(S * n, 3), S)


def _ops(lanes):
    b = lanes["batch"]
    return build_woodbury_ops(b.edges.ij.numpy(), b.edges.num_nodes,
                              seeds=lanes["S"])


def test_batched_woodbury_matches_the_jax_vmap_and_each_lane(lanes):
    S, n = lanes["S"], lanes["n"]
    ops = tb.batch_plan(lanes["batch"].edges, "woodbury", S)
    counts = [build_woodbury_ops(e.ij.numpy(), n).num_lowrank
              for _, e in lanes["alone"]]
    assert counts == [12, 12, 13] and ops.num_lowrank == lanes["cmax"] == 13
    assert ops.seeds == S and ops.lowrank.shape == (S * 13,)
    dx = woodbury_solve(lanes["system"], lanes["batch"].edges, ops,
                        _lam_nodes(LAMS, S, n))
    jdx = jax.vmap(jwood.woodbury_solve)(
        lanes["jsys"], lanes["jedges"], lanes["jops"], jnp.asarray(LAMS))
    poses = dx.poses.reshape(S, n, 3)
    _close(poses, jdx.poses, JAX_TOL)
    assert not dx.switches.any()
    for k, (system, e) in enumerate(lanes["alone"]):
        one = woodbury_solve(system, e, build_woodbury_ops(e.ij.numpy(), n),
                             torch.tensor(LAMS[k], dtype=torch.float64))
        _close(poses[k], one.poses, SELF_TOL, f"lane {k}")


def test_padding_is_neutral(lanes):
    """Lanes 0 and 1 (12 low-rank edges) are padded to lane 2's 13 with a
    column that is in no plan (no diagonal block, a zero column of U, an
    identity row of the core): each padded lane is its solve alone."""
    S, n, E = lanes["S"], lanes["n"], lanes["E"]
    ops = _ops(lanes)
    C = ops.num_lowrank
    assert C == 13
    real = [k for s, c in enumerate((12, 12, 13))
            for k in range(C * s, C * s + c)]
    for plan in (ops.plan_a, ops.plan_b):
        assert sorted(plan.src.tolist()) == real
    assert sorted(ops.plan_u.src.tolist()) == real + [k + S * C
                                                      for k in real]
    # A padded column reads its lane's first edge, and no plan takes it.
    pad = sorted(set(range(S * C)) - set(real))
    assert pad == [12, 25]
    assert all(int(ops.lowrank[k]) == (k // C) * E for k in pad)
    lam = _lam_nodes(LAMS, S, n)
    dx = woodbury_solve(lanes["system"], lanes["batch"].edges, ops,
                        lam).poses.reshape(S, n, 3)
    for k in (0, 1):
        system, e = lanes["alone"][k]
        alone = build_woodbury_ops(e.ij.numpy(), n)
        assert alone.num_lowrank == 12
        one = woodbury_solve(system, e, alone,
                             torch.tensor(LAMS[k], dtype=torch.float64))
        _close(dx[k], one.poses, SELF_TOL, f"lane {k}")


def test_a_failed_core_is_nan_in_its_lane_only(lanes):
    """A lane damped negative enough that its core is not positive
    definite gives NaN in its own lane, as alone; the others are theirs."""
    S, n = lanes["S"], lanes["n"]
    lams = (1e-2, -0.9, 1.0)
    dx = woodbury_solve(lanes["system"], lanes["batch"].edges, _ops(lanes),
                        _lam_nodes(lams, S, n)).poses.reshape(S, n, 3)
    assert torch.isnan(dx[1]).all()
    for k, (system, e) in enumerate(lanes["alone"]):
        one = woodbury_solve(system, e, build_woodbury_ops(e.ij.numpy(), n),
                             torch.tensor(lams[k], dtype=torch.float64))
        if k == 1:
            assert torch.isnan(one.poses).all()
        else:
            assert torch.isfinite(dx[k]).all()
            _close(dx[k], one.poses, SELF_TOL, f"lane {k}")


def test_seed_batch_on_woodbury_matches_the_jax_vmap_and_each_seed(graphs):
    """``lm_fixed_iters_batch`` on Woodbury (``batch_plan``: the seeds'
    ops padded to the largest count) against bench_woodbury's vmap over
    ops built with ``pad_to``, and each seed alone."""
    jc = jcfg.SolverConfig(robust="dcs", linear_solver="woodbury",
                           dtype="float64")
    cfg = convert.config_from_jax(jc)
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    plan = tb.batch_plan(b.edges, "woodbury", b.seeds)
    got = convert.lm_result_to_numpy(tb.lm_fixed_iters_batch(
        *b.args, cfg, ITERS, partition=plan))
    _, eb, ob, _ = _jax_sets(graphs)
    n = graphs[0].num_nodes
    free = jp.anchor_first_node(n, dtype=jnp.float64)
    p0 = jnp.asarray(graphs[0].poses)
    sw0 = jnp.ones((b.switches0.shape[1],), jnp.float64)
    want = convert.lm_result_to_numpy(jax.jit(jax.vmap(
        lambda e, o: jlm.lm_fixed_iters(p0, sw0, e, free, jc, ITERS,
                                        partition=o)))(eb, ob))
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    for f in ("cost", "initial_cost", "final_lambda"):
        _close(got[f], want[f], JAX_TOL, f)
    _close(got["poses"], want["poses"], JAX_TOL, "poses")
    assert (got["lin_iters"] == 0).all()
    for k, g in enumerate(graphs):
        e = edge_set_from_graph(convert.graph_from_jax(g),
                                pad_to=b.switches0.shape[1])
        alone = convert.lm_result_to_numpy(lm_fixed_iters(
            b.poses0[k], b.switches0[k], e, anchor_first_node(n), cfg,
            ITERS, partition=build_woodbury_ops(e.ij.numpy(), n)))
        assert got["accepted"][k] == alone["accepted"], k
        _close(got["cost"][k], alone["cost"], SELF_TOL, f"seed {k}")
        _close(got["poses"][k], alone["poses"], SELF_TOL, f"seed {k}")


def test_a_batched_woodbury_iteration_launches_as_one_seed(graphs):
    """Per LM iteration the batch calls each kernel wrapper as often as one
    seed alone: the linearisation, the cost's gather and the low-rank
    rows' gather, the linearisation's, the chain's and the low-rank
    scatter."""
    cfg = tb.SolverConfig(robust="dcs", linear_solver="woodbury",
                          dtype="float64")
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    plan = tb.batch_plan(b.edges, "woodbury", b.seeds)
    e = edge_set_from_graph(convert.graph_from_jax(graphs[0]),
                            pad_to=b.switches0.shape[1])
    per_batch = _calls_per_iteration(lambda k: tb.lm_fixed_iters_batch(
        *b.args, cfg, k, partition=plan))
    per_seed = _calls_per_iteration(lambda k: lm_fixed_iters(
        b.poses0[0], b.switches0[0], e, anchor_first_node(64), cfg, k,
        partition=build_woodbury_ops(e.ij.numpy(), 64)))
    assert per_batch == per_seed
    assert per_batch["fused_linearize_se2_indexed"] == 1
    assert per_batch["gather_rows"] == 2
    assert per_batch.get("scatter_add_rows", 0) + per_batch.get(
        "scatter_add_groups", 0) == 3


def test_woodbury_chain_batch_matches_jax_lanes(dirty, chains):  # noqa: F811
    """``lm_solve_batch`` of the rescue fixture's four chains on Woodbury
    (at most ``ITERS`` iterations; the chains share one problem's
    low-rank edges, so their ops need no padding) against the JAX
    ``_chain_solve_batch`` lanes on one shared ``partition=ops``, and each
    lane against its chain alone."""
    cfg = tb.SolverConfig(robust="dcs", linear_solver="woodbury",
                          dtype="float64", max_iterations=ITERS)
    C = len(chains["masks"])
    e1 = chains["edges"]
    single = build_woodbury_ops(e1.ij.numpy(), e1.num_nodes)
    cb = tb.chain_batch(chains["poses0"], chains["switches0"], e1,
                        chains["free"], cfg, single, C)
    assert cb.partition.seeds == C
    assert cb.partition.num_lowrank == single.num_lowrank
    res = tb.lm_solve_batch(cb.poses0, cb.switches0, cb.masked(
        chains["masks"]), cb.free, cfg, cb.partition)
    psi = loop_psi(res.poses.reshape(-1, 3), cb.edges, SE2Model,
                   cfg.dcs_phi).reshape(C, -1).numpy()
    got = convert.lm_result_to_numpy(res)
    pad, f64 = e1.num_edges, jnp.float64
    e = jp.edge_set_from_graph(dirty.canonical_order(), dtype=f64,
                               pad_to=pad)
    jres, jpsi = jgs._chain_solve_batch(
        jnp.asarray(dirty.canonical_order().poses, f64), jnp.ones(pad, f64),
        e, jnp.asarray(chains["masks"], f64),
        jp.anchor_first_node(dirty.num_nodes, dtype=f64),
        jcfg.SolverConfig(robust="dcs", linear_solver="woodbury",
                          dtype="float64", max_iterations=ITERS), JSE2,
        jwood.build_woodbury_ops(np.asarray(e.ij), dirty.num_nodes,
                                 dtype=f64))
    want = convert.lm_result_to_numpy(jres)
    for f in ("iterations", "accepted", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("cost", "initial_cost", "final_lambda", "final_nu"):
        _close(got[f], want[f], JAX_TOL, f)
    _close(got["poses"], want["poses"], JAX_TOL, "poses")
    _close(psi, jpsi, JAX_TOL, "psi")
    for c, mask in enumerate(chains["masks"]):
        alone = convert.lm_result_to_numpy(lm_solve(
            chains["poses0"], chains["switches0"],
            e1._replace(active=torch.as_tensor(mask)), chains["free"], cfg,
            partition=single))
        for f in ("iterations", "accepted", "converged"):
            assert got[f][c] == alone[f], (c, f)
        _close(got["cost"][c], alone["cost"], SELF_TOL, f"chain {c}")
        _close(got["poses"][c], alone["poses"], SELF_TOL, f"chain {c}")


def test_lane_ops_check_their_lanes(lanes):
    b = lanes["batch"]
    with pytest.raises(ValueError, match="not 2 problems"):
        build_woodbury_ops(b.edges.ij.numpy(), b.edges.num_nodes, seeds=2)
