"""The batched PCG of the port on the CPU, float64: B problems' PCG solves
as one solve over their lanes (``solver/linear.py`` ``pcg_solve(seeds=)``,
``linear.PCGPlan``; the lane axis of ``solver/tridiag.py``; the PCG seed
and chain batches of ``solver/batch.py``), against the JAX package's
``jax.vmap`` of the same functions and against each lane alone.

The fixture is the circle of ``tests/conftest.py`` (64 nodes) with the
bogus loops of three seeds (``OUTLIERS`` each, as ``tests/test_torch_batch.py``
builds its seed batch), each edge set padded to the most any seed has.
The solves are linearised at poses moved by N(0, 0.05) and damped with a
different lambda per lane (``LAMS``), so that the lanes stop at different
CG counts.  Tolerances: each lane against the JAX vmap within ``JAX_TOL``
(relative to the largest entry), with equal CG counts; against the port's
solve of that lane alone within ``SELF_TOL``.  The LM runs take at most
``ITERS`` iterations, on ``scripts/bench_pcg.py``'s settings (tridiagonal
preconditioner, rtol 1e-6, 100 CG iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.methods import global_solve as jgs
from slam_tpu.solver import linear as jlin
from slam_tpu.solver import linearize as jl
from slam_tpu.solver import lm as jlm
from slam_tpu.solver import problem as jp
from slam_tpu.solver import tridiag as jtd
from slam_tpu.solver.models import SE2Model as JSE2
from slam_tpu_torch import convert
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear as tlin
from slam_tpu_torch.solver import linearize as tl
from slam_tpu_torch.solver import tridiag as ttd
from slam_tpu_torch.solver.linearize import loop_psi
from slam_tpu_torch.solver.lm import lm_fixed_iters, lm_solve
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from test_torch_batch import _calls_per_iteration
from test_torch_rescue_batch import MAX_ITERS as CHAIN_MAX_ITERS
from test_torch_rescue_batch import chains, dirty  # noqa: F401 (fixtures)

SEEDS = (0, 1, 2)
OUTLIERS = 6
BLOCKS = 4
ITERS = 5
LAMS = (1e-4, 1e-2, 1.0)
KW = dict(dcs_phi=1.0, huber_delta=1.0, sc_prior_lambda=1.0)
JAX_TOL = 1e-9
SELF_TOL = 1e-12
# scripts/bench_pcg.py's settings.
BENCH = dict(robust="dcs", linear_solver="pcg", dtype="float64",
             pcg_rtol=1e-6, pcg_max_iters=100, pcg_preconditioner="tridiag")

torch.set_num_threads(2)


def _close(t, j, tol, err_msg=""):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale,
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def graphs(circle):
    g, _ = circle
    return [g.add_random_outliers(OUTLIERS, seed=s).canonical_order()
            for s in SEEDS]


@pytest.fixture(scope="module")
def lanes(graphs):
    """The seeds' problems linearised at moved poses: the port's batch and
    each seed alone, and the JAX package's stacked systems."""
    E = max(g.num_edges for g in graphs)
    n = graphs[0].num_nodes
    rng = np.random.default_rng(4)
    poses = np.stack([g.poses + rng.normal(scale=0.05, size=g.poses.shape)
                      for g in graphs])
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    S = len(graphs)
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
    jsets = [jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=E,
                                    incidence=False) for g in graphs]
    jf = jp.anchor_first_node(n, dtype=jnp.float64)
    jsys = [jl.linearize(jnp.asarray(p), jnp.ones(E), e, jf, model=JSE2,
                         robust="dcs", **KW) for p, e in zip(poses, jsets)]
    return dict(batch=b, system=system, alone=alone, S=S, n=n, E=E,
                jsys=jax.tree.map(lambda *x: jnp.stack(x), *jsys),
                jedges=jax.tree.map(lambda *x: jnp.stack(x), *jsets))


def _lam_nodes(S, n):
    return tlin.lane_rows(torch.tensor(LAMS, dtype=torch.float64),
                          torch.zeros(S * n, 3), S)


@pytest.mark.parametrize("preconditioner", ["tridiag", "jacobi"])
def test_batched_pcg_matches_the_jax_vmap_and_each_lane_alone(
        lanes, preconditioner):
    S, n, E = lanes["S"], lanes["n"], lanes["E"]
    kw = dict(max_iters=250, rtol=1e-8, preconditioner=preconditioner)
    dx, iters = tlin.pcg_solve(lanes["system"], lanes["batch"].edges,
                               _lam_nodes(S, n), seeds=S, **kw)
    assert iters.shape == (S,) and iters.dtype == torch.int64
    # The lanes stop at different CG counts.
    assert len(set(iters.tolist())) == S
    jdx, jit = jax.vmap(lambda s, e, lam: jlin.pcg_solve(s, e, lam, **kw))(
        lanes["jsys"], lanes["jedges"], jnp.asarray(LAMS))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(jit))
    poses, sw = dx.poses.reshape(S, n, 3), dx.switches.reshape(S, E)
    _close(poses, jdx.poses, JAX_TOL, "poses")
    _close(sw, jdx.switches, JAX_TOL, "switches")
    for k, (system, e) in enumerate(lanes["alone"]):
        one, it = tlin.pcg_solve(system, e, torch.tensor(LAMS[k],
                                                        dtype=torch.float64),
                                 **kw)
        assert it.shape == () and int(it) == int(iters[k]), k
        _close(poses[k], one.poses, SELF_TOL, f"lane {k}")
        _close(sw[k], one.switches, SELF_TOL, f"lane {k}")


def test_pcg_launches_as_one_problem(lanes):
    """Per CG iteration the batch makes one gather and one grouped scatter
    for all lanes, as one problem's solve does."""
    from slam_tpu_torch.tools.kernel_times import record

    S, n = lanes["S"], lanes["n"]

    def calls(fn):
        return [name for name, _, _ in record(fn)]

    out = []
    batch = calls(lambda: out.append(tlin.pcg_solve(
        lanes["system"], lanes["batch"].edges, _lam_nodes(S, n), seeds=S,
        max_iters=9, rtol=0.0)))
    system, e = lanes["alone"][0]
    one = calls(lambda: tlin.pcg_solve(system, e, torch.tensor(1e-2,
                                       dtype=torch.float64), max_iters=9,
                                       rtol=0.0))
    assert batch == one
    assert batch.count("gather_rows") == 9
    assert out[0][1].tolist() == [9] * S


@pytest.mark.parametrize("n", [7, 64])
def test_lane_axis_cyclic_reduction(n):
    """``(S, N, B, B)`` chains: each lane equal to its chain alone (to the
    bit here) and to ``jax.vmap`` of the JAX functions, one and several
    right-hand sides."""
    S, B, K = 3, 3, 4
    rng = np.random.default_rng(n)
    G = rng.normal(size=(S, n, B, 2 * B))
    D = G @ np.swapaxes(G, -1, -2) + 5.0 * np.eye(B)
    U = rng.normal(size=(S, n - 1, B, B)) * 0.3
    r = rng.normal(size=(S, n, B))
    R = rng.normal(size=(S, n, B, K))
    f = ttd.build_cr_factors(torch.as_tensor(D), torch.as_tensor(U))
    z = ttd.cr_solve(f, torch.as_tensor(r))
    Z = ttd.cr_solve_mrhs(f, torch.as_tensor(R))
    assert z.shape == (S, n, B) and Z.shape == (S, n, B, K)
    jz = jax.vmap(lambda d, u, v: jtd.cr_solve(jtd.build_cr_factors(d, u),
                                               v))(D, U, r)
    jZ = jax.vmap(lambda d, u, v: jtd.cr_solve_mrhs(
        jtd.build_cr_factors(d, u), v))(D, U, R)
    _close(z, jz, SELF_TOL)
    _close(Z, jZ, SELF_TOL)
    for k in range(S):
        fk = ttd.build_cr_factors(torch.as_tensor(D[k]), torch.as_tensor(U[k]))
        assert torch.equal(z[k], ttd.cr_solve(fk, torch.as_tensor(r[k])))
        assert torch.equal(Z[k], ttd.cr_solve_mrhs(fk, torch.as_tensor(R[k])))


def test_extract_tridiag_lanes(lanes):
    """The lanes' blocks are each lane's alone; the couplings across a lane
    boundary are sliced away."""
    S, n = lanes["S"], lanes["n"]
    Hd = tlin.damped_blocks(lanes["system"], _lam_nodes(S, n))
    D, U = ttd.extract_tridiag(lanes["system"], lanes["batch"].edges, Hd, S)
    assert D.shape == (S, n, 3, 3) and U.shape == (S, n - 1, 3, 3)
    for k, (system, e) in enumerate(lanes["alone"]):
        Dk, Uk = ttd.extract_tridiag(system, e, tlin.damped_blocks(
            system, torch.tensor(LAMS[k], dtype=torch.float64)))
        assert torch.equal(D[k], Dk) and torch.equal(U[k], Uk)


def _jax_seed_batch(graphs, cfg, iters):
    """``scripts/bench_pcg.py``'s ``jax.vmap(lm_fixed_iters)`` over the
    stacked edge sets (padded to the most any seed has)."""
    E = max(g.num_edges for g in graphs)
    n = graphs[0].num_nodes
    sets = [jp.edge_set_from_graph(g, dtype=jnp.float64, pad_to=E,
                                   incidence=False) for g in graphs]
    eb = jax.tree.map(lambda *x: jnp.stack(x), *sets)
    free = jp.anchor_first_node(n, dtype=jnp.float64)
    p0 = jnp.asarray(graphs[0].poses)
    sw0 = jnp.ones((E,), jnp.float64)
    return convert.lm_result_to_numpy(jax.jit(jax.vmap(
        lambda e: jlm.lm_fixed_iters(p0, sw0, e, free, cfg, iters)))(eb))


def test_seed_batch_on_pcg_matches_the_jax_vmap_and_each_seed(graphs):
    """``lm_fixed_iters_batch`` on PCG (``batch_plan``) against bench_pcg's
    vmap and each seed alone: cost, poses and CG iterations per lane."""
    jc = jcfg.SolverConfig(**BENCH)
    cfg = convert.config_from_jax(jc)
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    plan = tb.batch_plan(b.edges, "pcg", b.seeds)
    assert plan == tlin.PCGPlan(3)
    got = convert.lm_result_to_numpy(tb.lm_fixed_iters_batch(
        *b.args, cfg, ITERS, partition=plan))
    want = _jax_seed_batch(graphs, jc, ITERS)
    np.testing.assert_array_equal(got["lin_iters"], want["lin_iters"])
    np.testing.assert_array_equal(got["accepted"], want["accepted"])
    for f in ("cost", "initial_cost", "final_lambda"):
        _close(got[f], want[f], JAX_TOL, f)
    _close(got["poses"], want["poses"], JAX_TOL, "poses")
    assert got["lin_iters"].shape == (3,) and (got["lin_iters"] > 0).all()
    for k, g in enumerate(graphs):
        e = edge_set_from_graph(convert.graph_from_jax(g),
                                pad_to=b.switches0.shape[1])
        alone = convert.lm_result_to_numpy(lm_fixed_iters(
            b.poses0[k], b.switches0[k], e, anchor_first_node(64), cfg,
            ITERS))
        assert got["lin_iters"][k] == alone["lin_iters"], k
        assert got["accepted"][k] == alone["accepted"], k
        _close(got["cost"][k], alone["cost"], SELF_TOL, f"seed {k}")
        _close(got["poses"][k], alone["poses"], SELF_TOL, f"seed {k}")


def test_a_batched_pcg_iteration_launches_as_one_seed(graphs):
    """Per LM iteration the batch calls each kernel wrapper as often as the
    seed whose CG runs longest does alone."""
    cfg = tb.SolverConfig(**dict(BENCH, pcg_rtol=0.0, pcg_max_iters=12))
    b = tb.seed_batch([convert.graph_from_jax(g) for g in graphs], BLOCKS)
    plan = tb.batch_plan(b.edges, "pcg", b.seeds)
    e = edge_set_from_graph(convert.graph_from_jax(graphs[0]),
                            pad_to=b.switches0.shape[1])
    per_batch = _calls_per_iteration(lambda k: tb.lm_fixed_iters_batch(
        *b.args, cfg, k, partition=plan))
    per_seed = _calls_per_iteration(lambda k: lm_fixed_iters(
        b.poses0[0], b.switches0[0], e, anchor_first_node(64), cfg, k))
    assert per_batch == per_seed
    assert per_batch["gather_rows"] == 12 + 1
    assert per_batch["fused_linearize_se2_indexed"] == 1


def test_pcg_chain_batch_matches_jax_lanes(dirty, chains):  # noqa: F811
    """``lm_solve_batch`` of the rescue fixture's four chains on PCG (at
    most ``ITERS`` iterations) against the JAX ``_chain_solve_batch``
    lanes, and each lane against its chain alone."""
    assert ITERS < CHAIN_MAX_ITERS
    cfg = tb.SolverConfig(robust="dcs", linear_solver="pcg",
                          dtype="float64", max_iterations=ITERS)
    C = len(chains["masks"])
    cb = tb.chain_batch(chains["poses0"], chains["switches0"],
                        chains["edges"], chains["free"], cfg, None, C)
    assert cb.partition == tlin.PCGPlan(C)
    res = tb.lm_solve_batch(cb.poses0, cb.switches0, cb.masked(
        chains["masks"]), cb.free, cfg, cb.partition)
    psi = loop_psi(res.poses.reshape(-1, 3), cb.edges, SE2Model,
                   cfg.dcs_phi).reshape(C, -1).numpy()
    got = convert.lm_result_to_numpy(res)
    pad = chains["edges"].num_edges
    f64 = jnp.float64
    e = jp.edge_set_from_graph(dirty.canonical_order(), dtype=f64,
                               pad_to=pad)
    jres, jpsi = jgs._chain_solve_batch(
        jnp.asarray(dirty.canonical_order().poses, f64), jnp.ones(pad, f64),
        e, jnp.asarray(chains["masks"], f64),
        jp.anchor_first_node(dirty.num_nodes, dtype=f64),
        jcfg.SolverConfig(robust="dcs", linear_solver="pcg", dtype="float64",
                          max_iterations=ITERS), JSE2, None)
    want = convert.lm_result_to_numpy(jres)
    for f in ("iterations", "accepted", "converged", "lin_iters"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("cost", "initial_cost", "final_lambda", "final_nu"):
        _close(got[f], want[f], JAX_TOL, f)
    _close(got["poses"], want["poses"], JAX_TOL, "poses")
    _close(psi, jpsi, JAX_TOL, "psi")
    for c, mask in enumerate(chains["masks"]):
        alone = convert.lm_result_to_numpy(lm_solve(
            chains["poses0"], chains["switches0"],
            chains["edges"]._replace(active=torch.as_tensor(mask)),
            chains["free"], cfg))
        for f in ("iterations", "accepted", "converged", "lin_iters"):
            assert got[f][c] == alone[f], (c, f)
        _close(got["cost"][c], alone["cost"], SELF_TOL, f"chain {c}")
        _close(got["poses"][c], alone["poses"], SELF_TOL, f"chain {c}")


def test_plans_and_checks():
    """The PCG plan's lanes reach the LM loop; a single problem's plan and
    none are one problem's."""
    from slam_tpu_torch.solver.lm import linear_plan

    cfg = tb.SolverConfig(linear_solver="pcg")
    assert linear_plan(cfg, None) == tlin.PCGPlan()
    assert linear_plan(cfg, None, tlin.PCGPlan(4)).seeds == 4
    assert tb.PLANS["pcg"] is tlin.PCGPlan and "woodbury" in tb.PLANS
    with pytest.raises(ValueError, match="no batch plan"):
        tb.batch_plan(None, "schur", 2)
