"""The per-seed batch of the port (``slam_tpu_torch/solver/batch.py``) on
the CPU: B seeds' problems in one ``lm_fixed_iters_batch`` against the
JAX package's ``jax.vmap(lm_fixed_iters)`` over the stacked edge sets and
partitions (as ``bench.py`` builds them), and against the port's
unbatched ``lm_fixed_iters`` of each seed alone.

The fixture is the circle of ``tests/conftest.py`` (64 nodes) with the
bogus loops of three seeds, each edge set padded to the most any seed has
(as ``seed_batch`` pads, on both sides), the Schur
partition of 4 index blocks padded to the seeds' maxima; every step of
its 10 iterations is accepted.  A second start moves each pose by N(0, 1)
(``HARD_NOISE``), so that steps are rejected, a different number for
each seed.  Tolerances: 1e-9 relative per seed against the JAX package in
float64 (the two factor permuted matrices, ``solver/schur.py``).  Against
the port's unbatched runs of each seed alone, 1e-12 from the fixture's
start (measured: 1.1e-14 and below), and from the hard start, on the
seed's share of the padded shapes, 1e-12 native (measured: equal to the
bit) and 1e-9 blocked (measured 6.4e-11: the blocked factor's matmuls on
the stacked (B, n, n) separators and on one (n, n) round apart, and the
rejections amplify it).  The float32 fold runs 8 blocks, so that the JAX
side takes ``micro_chol_inv_folded_interpret`` (its ``_panel_factor``
takes the kernel for 8 or more panels a problem); its tolerance is
measured below.
"""

import dataclasses
import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.io import synthetic
from slam_tpu.ops import pallas_chol as jchol
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu_torch import convert
from slam_tpu_torch.ops import chol as tchol
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.lm import lm_fixed_iters, lm_solve
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.tools.kernel_times import record

ITERS = 10
HARD_NOISE = 1.0
SEEDS = (0, 1, 2)
OUTLIERS = 6
BLOCKS = 4
JAX_RTOL = 1e-9
SELF_RTOL = 1e-12
# float32 batch (the plain micro_chol_inv on the CPU) against the JAX
# folded interpret kernel: 3 seeds x 10 iterations differ by at most
# 8.3e-7 relative in cost (9.2e-8 in the initial cost) and 1.6e-5 in
# poses (|pose| up to 10.2); each gate is about 5x that.
F32_COST_RTOL = 4e-6
F32_POSE_ATOL = 8e-5
CONFIGS = {
    "native-nielsen": {},
    "native-ceres": dict(trust_region="ceres"),
    "blocked-nielsen": dict(schur_blocked=True, schur_panel=16),
    "blocked-ceres": dict(schur_blocked=True, schur_panel=16,
                          trust_region="ceres"),
}

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def graphs(circle):
    g, _ = circle
    return [g.add_random_outliers(OUTLIERS, seed=s).canonical_order()
            for s in SEEDS]


@pytest.fixture(scope="module")
def hard(graphs):
    rng = np.random.default_rng(11)
    return [dataclasses.replace(
        g, poses=g.poses + rng.normal(0.0, HARD_NOISE, g.poses.shape))
        for g in graphs]


@functools.lru_cache(maxsize=None)
def _jax_solver(cfg, n, e, blocks, iters):
    """The jitted ``vmap(lm_fixed_iters)`` of one configuration, compiled
    once for both starts."""
    dtype = jnp.dtype(cfg.dtype)
    free = jp.anchor_first_node(n, dtype=dtype)
    sw0 = jnp.ones((e,), dtype)

    @jax.jit
    def solve(p, e, part):
        return jax.vmap(lambda p, e, part: jlm.lm_fixed_iters(
            p, sw0, e, free, cfg, iters, partition=part))(p, e, part)

    return solve


def jax_batch(graphs, cfg, blocks=BLOCKS, iters=ITERS):
    """``jax.vmap(lm_fixed_iters)`` over the stacked seeds, as ``bench.py``
    builds the batch (here with the edges padded to the most any seed
    has)."""
    dtype = jnp.dtype(cfg.dtype)
    e = max(g.num_edges for g in graphs)
    sets = [jp.edge_set_from_graph(g, dtype=dtype, pad_to=e,
                                   incidence=False) for g in graphs]
    n = graphs[0].num_nodes
    ijs = [np.asarray(e.ij) for e in sets]
    stats = [js.partition_stats(ij, n, blocks) for ij in ijs]
    pad = tuple(max(s[i] for s in stats) for i in range(len(stats[0])))
    parts = [js.build_partition(ij, n, blocks, dtype=dtype, pad_shapes=pad)
             for ij in ijs]
    eb = jax.tree.map(lambda *xs: jnp.stack(xs), *sets)
    pb = jax.tree.map(lambda *xs: jnp.stack(xs), *parts)
    p0 = jnp.stack([jnp.asarray(g.poses, dtype) for g in graphs])
    solve = _jax_solver(cfg, n, e, blocks, iters)
    return convert.lm_result_to_numpy(solve(p0, eb, pb)), pad


def port_batch(graphs, cfg, blocks=BLOCKS, iters=ITERS):
    dtype = getattr(torch, cfg.dtype)
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], blocks,
                      dtype=dtype)
    return tb.lm_fixed_iters_batch(*b.args, cfg, iters,
                                   partition=b.partition), b


def port_alone(graph, cfg, blocks=BLOCKS, iters=ITERS, batch=None):
    """One seed through the unbatched solver (``lm_solve`` when ``iters``
    is None): its own edges, unpadded, and its own (natural) partition;
    or with ``batch`` its share of the batch's shapes (its edges and pad
    shapes)."""
    g = convert.graph_from_jax(graph).canonical_order()
    dtype = getattr(torch, cfg.dtype)
    e = edge_set_from_graph(
        g, dtype=dtype, pad_to=batch.switches0.shape[1] if batch else None)
    part = ts.partition_from_slots(
        ts.build_slots(np.asarray(e.ij), g.num_nodes, blocks,
                       pad_shapes=batch.pad_shapes if batch else None),
        dtype=dtype)
    args = (torch.as_tensor(g.poses, dtype=dtype),
            torch.ones(e.num_edges, dtype=dtype), e,
            anchor_first_node(g.num_nodes, dtype=dtype), cfg)
    if iters is None:  # to convergence
        return lm_solve(*args, partition=part)
    return lm_fixed_iters(*args, iters, partition=part)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def assert_per_seed(got, want, rtol, pose_atol):
    """Per seed: cost, initial cost and final lambda within ``rtol``,
    poses within ``pose_atol`` of each other."""
    for f in ("cost", "initial_cost", "final_lambda"):
        assert rel(got[f], want[f]).max() <= rtol, (f, got[f], want[f])
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                               atol=pose_atol)


def seed(res: dict, i: int) -> dict:
    return {k: v[i] for k, v in res.items()
            if isinstance(v, np.ndarray) and v.ndim}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batch_matches_jax_vmap_and_each_seed_alone(graphs, hard, name):
    jc = jcfg.SolverConfig(robust="dcs", linear_solver="schur",
                           dtype="float64", **CONFIGS[name])
    cfg = convert.config_from_jax(jc)
    rejected = []
    for start in (graphs, hard):
        want, pad = jax_batch(start, jc)
        res, b = port_batch(start, cfg)
        assert b.pad_shapes == pad
        got = convert.lm_result_to_numpy(res)
        assert got["poses"].shape == want["poses"].shape == (3, 64, 3)
        # Poses: 1e-9 relative to the circle's radius of 10.
        assert_per_seed(got, want, JAX_RTOL, JAX_RTOL * 10)
        np.testing.assert_array_equal(got["accepted"], want["accepted"])
        rejected.append(ITERS - got["accepted"])
        for i, g in enumerate(start):
            if start is graphs:
                alone, tol = port_alone(g, cfg), SELF_RTOL
            else:
                alone = port_alone(g, cfg, batch=b)
                tol = JAX_RTOL if cfg.schur_blocked else SELF_RTOL
            alone = convert.lm_result_to_numpy(alone)
            assert_per_seed(seed(got, i), alone, tol, tol * 10)
            assert int(got["accepted"][i]) == int(alone["accepted"])
    # The fixture's start accepts every step; the hard start rejects
    # some, not as many for each seed.
    assert not rejected[0].any() and len(set(rejected[1])) > 1


@pytest.fixture(scope="module")
def spheres():
    """A small SE(3) sphere with the bogus loops of two seeds."""
    g, _ = synthetic.sphere_se3(n=48, rings=4, seed=0)
    return [g.add_random_outliers(4, seed=s).canonical_order()
            for s in (0, 1)]


@pytest.mark.parametrize("case", ["gnc", "none", "sc_varpro", "blocked-gnc",
                                  "se3"])
def test_batch_matches_each_seed_alone(graphs, spheres, case):
    """The other configurations the batch takes, against the port's
    unbatched runs; ``se3`` is DCS on SE(3) poses."""
    kw = {"gnc": dict(gnc_anneal_iters=4), "none": dict(robust="none"),
          "sc_varpro": dict(robust="sc_varpro"),
          "blocked-gnc": dict(gnc_anneal_iters=4, schur_blocked=True,
                              schur_panel=16),
          "se3": {}}[case]
    start = spheres if case == "se3" else graphs
    cfg = tb.SolverConfig(**{"robust": "dcs", "linear_solver": "schur",
                             "dtype": "float64", **kw})
    res, b = port_batch(start, cfg)
    assert res.iterations == ITERS
    got = convert.lm_result_to_numpy(res)
    assert got["poses"].shape == (len(start), *start[0].poses.shape)
    for i, g in enumerate(start):
        alone = convert.lm_result_to_numpy(port_alone(g, cfg))
        assert_per_seed(seed(got, i), alone, SELF_RTOL, SELF_RTOL * 10)
        assert got["final_nu"][i] == alone["final_nu"]
        assert int(got["accepted"][i]) == int(alone["accepted"]) > 0


def test_padding_is_inert(circle):
    """Seeds with different outlier counts: different edge counts and
    natural partitions (ni, ns, nsk), padded to shared shapes, each end
    where it ends alone."""
    g, _ = circle
    graphs = [g.add_random_outliers(k, seed=s).canonical_order()
              for s, k in ((3, 2), (4, 9), (5, 5))]
    natural = {js.partition_stats(x.edges_ij, x.num_nodes, BLOCKS)
               for x in graphs}
    assert len({s[0] for s in natural}) > 1 and len({s[1] for s in natural}) \
        > 1 and len({s[4] for s in natural}) > 1
    cfg = tb.SolverConfig(robust="dcs", linear_solver="schur",
                          dtype="float64")
    res, b = port_batch(graphs, cfg)
    assert b.edges.num_edges == 3 * max(x.num_edges for x in graphs)
    got = convert.lm_result_to_numpy(res)
    for i, x in enumerate(graphs):
        alone = convert.lm_result_to_numpy(port_alone(x, cfg))
        assert_per_seed(seed(got, i), alone, SELF_RTOL, SELF_RTOL * 10)
        # The padded edges' switches are never moved.
        assert np.all(got["switches"][i, x.num_edges:] == 1.0)


def test_f32_fold_matches_jax_folded_interpret(graphs):
    """float32, blocked with the micro kernel: each panel step folds the
    3 x 8 interiors' panels into one ``micro_chol_inv`` call, as the JAX
    package's ``custom_vmap`` rule folds its vmap axis."""
    jc = jcfg.SolverConfig(robust="dcs", linear_solver="schur",
                           dtype="float32", schur_blocked=True,
                           schur_panel=16, schur_pallas_micro=True)
    want, _ = jax_batch(graphs, jc, blocks=8)
    cfg = convert.config_from_jax(jc)
    out = []
    calls = record(lambda: out.append(port_batch(graphs, cfg, blocks=8)))
    res, b = out[0]
    folded = [args[0] for name, args, _ in calls
              if name == "micro_chol_inv"]
    n_pad = -(-b.partition.ni_max * 3 // 16) * 16
    assert len(folded) == ITERS * n_pad // 16
    assert all(a.shape == (3 * 8, 16, 16) and a.dtype == torch.float32
               for a in folded)
    got = convert.lm_result_to_numpy(res)
    assert got["cost"].dtype == np.float32
    for f in ("cost", "initial_cost"):
        assert rel(got[f], want[f]).max() <= F32_COST_RTOL, f
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                               atol=F32_POSE_ATOL)


@pytest.mark.parametrize("lead", [(3,), (2, 3), (6,), (8,)])
def test_micro_chol_inv_folded_matches_the_jax_fold(lead):
    """``micro_chol_inv_folded`` of ``(*lead, M, p, p)`` against the JAX
    folded interpret kernel under vmap, and against one call per leading
    index (bitwise: the fold is a reshape)."""
    rng = np.random.default_rng(len(lead))
    G = rng.normal(size=(*lead, 4, 8, 8))
    A = (G @ np.swapaxes(G, -1, -2) + 8 * np.eye(8)).astype(np.float32)
    fn = jchol.micro_chol_inv_folded_interpret
    for _ in lead:
        fn = jax.vmap(fn)
    jL, jinv = fn(jnp.asarray(A))
    tL, tinv = tchol.micro_chol_inv_folded(torch.as_tensor(A))
    assert tL.shape == tinv.shape == A.shape
    for t, j in ((tL, jL), (tinv, jinv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-5)
    flat = torch.as_tensor(A).reshape(-1, 4, 8, 8)
    for k in range(flat.shape[0]):
        L, inv = tchol.micro_chol_inv(flat[k])
        assert torch.equal(tL.reshape(-1, 4, 8, 8)[k], L)
        assert torch.equal(tinv.reshape(-1, 4, 8, 8)[k], inv)
    with pytest.raises(ValueError):
        tchol.micro_chol_inv_folded(torch.zeros(4, 8))


def _calls_per_iteration(run) -> dict:
    """Outermost kernel-wrapper calls of one LM iteration: those of a
    2-iteration run less those of a 1-iteration run."""
    def count(iters):
        n = {}
        for name, _, _ in record(lambda: run(iters)):
            n[name] = n.get(name, 0) + 1
        return n

    one, two = count(1), count(2)
    return {k: two.get(k, 0) - one.get(k, 0) for k in set(one) | set(two)}


@pytest.mark.parametrize("blocked", [False, True])
def test_one_launch_per_kernel_call_of_one_seed(graphs, blocked):
    """The batch calls each wrapper as often per iteration as one seed's
    solve does: the linearisation, the gathers, the grouped scatters and,
    blocked, one folded ``micro_chol_inv`` per diagonal panel."""
    kw = dict(schur_blocked=True, schur_panel=16,
              schur_pallas_micro=True) if blocked else {}
    cfg = tb.SolverConfig(robust="dcs", linear_solver="schur",
                          dtype="float32", **kw)
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], 8,
                      dtype=torch.float32)
    g = convert.graph_from_jax(graphs[0]).canonical_order()
    E = b.switches0.shape[1]
    e = edge_set_from_graph(g, dtype=torch.float32, pad_to=E)
    # One seed alone on its share of the padded shapes, so that its
    # interiors have as many panels as the batch's.
    part = ts.partition_from_slots(
        ts.build_slots(np.asarray(e.ij), g.num_nodes, 8,
                       pad_shapes=b.pad_shapes), dtype=torch.float32)
    alone = (torch.as_tensor(g.poses, dtype=torch.float32),
             torch.ones(E), e, anchor_first_node(g.num_nodes,
                                                      dtype=torch.float32))
    per_batch = _calls_per_iteration(lambda n: tb.lm_fixed_iters_batch(
        *b.args, cfg, n, partition=b.partition))
    per_seed = _calls_per_iteration(lambda n: lm_fixed_iters(
        *alone, cfg, n, partition=part))
    assert per_batch == per_seed
    assert per_batch["fused_linearize_se2_indexed"] == 1
    assert per_batch["gather_rows"] == 3
    assert per_batch["scatter_add_rows"] + per_batch.get(
        "scatter_add_groups", 0) == 4
    assert per_batch.get("micro_chol_inv", 0) == (
        -(-b.partition.ni_max * 3 // 16) if blocked else 0)


def test_batch_checks_its_inputs(graphs):
    cfg = tb.SolverConfig(robust="dcs", linear_solver="schur",
                          dtype="float64")
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    single = ts.build_partition(graphs[0].edges_ij, 64, BLOCKS)
    with pytest.raises(ValueError, match="stacked partition"):
        tb.lm_fixed_iters_batch(*b.args, cfg, 1, partition=single)
    with pytest.raises(ValueError, match="do not match"):
        tb.lm_fixed_iters_batch(b.poses0[:2], b.switches0[:2], b.edges,
                                b.free, cfg, 1, partition=b.partition)
    joint = linear.dense_plan(b.edges, switches=True, seeds=b.seeds)
    assert isinstance(joint, linear.JointPlan) and joint.seeds == b.seeds
    for switches in (False, True):
        with pytest.raises(ValueError, match="not 2 problems"):
            linear.dense_plan(b.edges, switches=switches, seeds=2)


def port_alone_edges(graph, batch):
    """One seed's edges on its share of the batch's padded edge count."""
    return edge_set_from_graph(
        convert.graph_from_jax(graph).canonical_order(),
        pad_to=batch.switches0.shape[1])


@pytest.mark.parametrize("name", ["native-nielsen", "native-ceres"])
def test_dense_batch_matches_each_seed_alone(graphs, hard, name):
    """The batched dense solver (``linear.dense_plan(seeds=B)``) under
    ``lm_fixed_iters_batch``, from both starts: each seed against its
    dense run alone on its share of the padded edges."""
    cfg = tb.SolverConfig(robust="dcs", linear_solver="dense",
                          dtype="float64", **CONFIGS[name])
    for start in (graphs, hard):
        b = tb.seed_batch([convert.graph_from_jax(g) for g in start], BLOCKS)
        res = convert.lm_result_to_numpy(tb.lm_fixed_iters_batch(
            *b.args, cfg, ITERS, partition=linear.dense_plan(
                b.edges, seeds=b.seeds)))
        for i, g in enumerate(start):
            e = port_alone_edges(g, b)
            alone = convert.lm_result_to_numpy(lm_fixed_iters(
                b.poses0[i], b.switches0[i], e, anchor_first_node(64), cfg,
                ITERS, partition=linear.dense_plan(e)))
            assert_per_seed(seed(res, i), alone, SELF_RTOL, SELF_RTOL * 10)
            assert res["accepted"][i] == alone["accepted"]


def test_lm_solve_takes_the_seed_batch(graphs):
    """``lm_solve`` on a seed batch (the port of ``jax.vmap(lm_solve)``):
    each seed to its own convergence, as alone."""
    cfg = tb.SolverConfig(robust="dcs", linear_solver="schur",
                          dtype="float64", max_iterations=40)
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    res = convert.lm_result_to_numpy(tb.lm_solve_batch(
        *b.args, cfg, b.partition))
    assert res["iterations"].shape == (3,) and res["converged"].all()
    for i, g in enumerate(graphs):
        alone = convert.lm_result_to_numpy(
            port_alone(g, cfg, iters=None, batch=b))
        assert_per_seed(seed(res, i), alone, SELF_RTOL, SELF_RTOL * 10)
        for f in ("iterations", "accepted", "converged"):
            assert res[f][i] == alone[f], f
