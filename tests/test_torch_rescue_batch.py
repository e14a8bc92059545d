"""The DCS rescue's consensus rounds as one batched ``lm_solve`` on the CPU
(``solver/batch.py``: ``chain_batch``, ``lm_solve_batch``; the batched
dense solver of ``solver/linear.py``; ``methods/global_solve.py``).

The fixture is the circle of ``tests/conftest.py`` (64 nodes) with 40
bogus loops of seed 3 (the rescue fixture of
``tests/test_torch_global_solve.py``), its edges padded to 256 as the
pipeline pads them, and four chain masks: every edge, every edge but the
bogus loops, and two random halves of the loops.  Under ``MAX_ITERS``
the four lanes stop at 16, 20 (the limit; alone that chain converges at
27), 10 and 14 iterations.  Tolerances, float64: each lane against the JAX package's
``_chain_solve_batch`` lane (``jax.vmap(lm_solve)``) within ``JAX_TOL``
in cost (relative), poses and psi (absolute; the circle's radius is 10),
and against the port's ``lm_solve`` of that chain alone within
``SELF_TOL`` (measured: equal to the bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_batch import _calls_per_iteration
from test_torch_global_solve import Capture, compare_runs

from slam_tpu import config as jcfg
from slam_tpu.methods import global_solve as jgs
from slam_tpu.solver import problem as jp
from slam_tpu.solver import schur as js
from slam_tpu.solver.models import SE2Model as JSE2
from slam_tpu_torch import convert
from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.methods import global_solve as tgs
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear as tl
from slam_tpu_torch.solver import schur as ts
from slam_tpu_torch.solver.linearize import linearize, loop_psi
from slam_tpu_torch.solver.lm import lm_solve
from slam_tpu_torch.solver.models import SE2Model
from slam_tpu_torch.solver.problem import anchor_first_node, \
    edge_set_from_graph
from slam_tpu_torch.tools.kernel_times import record

OUTLIERS = 40
SEED = 3
PAD = 256
BLOCKS = 4
MAX_ITERS = 20
JAX_TOL = 1e-9
SELF_TOL = 1e-12
SOLVERS = ("dense", "schur")

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dirty(circle):
    return circle[0].add_random_outliers(OUTLIERS, seed=SEED)


@pytest.fixture(scope="module")
def chains(dirty):
    """The port's problem and the four chain masks."""
    g = convert.graph_from_jax(dirty).canonical_order()
    e = edge_set_from_graph(g, pad_to=PAD)
    act, loop = e.active.numpy(), e.loop_f.numpy()
    bogus = np.zeros(PAD)
    bogus[:g.num_edges] = g.edge_type == 2
    halves = [np.random.default_rng(k).random(PAD) < 0.5 for k in (0, 2)]
    masks = np.stack([act, act * (1 - bogus)]
                     + [act * np.where(loop > 0, h, 1) for h in halves])
    return dict(graph=g, edges=e, masks=masks,
                poses0=torch.as_tensor(g.poses),
                switches0=torch.ones(PAD, dtype=torch.float64),
                free=anchor_first_node(g.num_nodes))


def solver_cfg(solver, **kw) -> SolverConfig:
    return SolverConfig(robust="dcs", linear_solver=solver, dtype="float64",
                        max_iterations=MAX_ITERS, **kw)


def single_plan(ch, solver):
    e = ch["edges"]
    return (ts.build_partition(e.ij.numpy(), e.num_nodes, BLOCKS)
            if solver == "schur" else tl.dense_plan(e))


def port_round(ch, cfg):
    """One consensus round of the four chains through the port: the
    batched result and each lane's psi against the base edges."""
    cb = tb.chain_batch(ch["poses0"], ch["switches0"], ch["edges"],
                        ch["free"], cfg, single_plan(ch, cfg.linear_solver),
                        len(ch["masks"]))
    res = tb.lm_solve_batch(cb.poses0, cb.switches0, cb.masked(ch["masks"]),
                            cb.free, cfg, cb.partition)
    psi = loop_psi(res.poses.reshape(-1, 3), cb.edges, SE2Model,
                   cfg.dcs_phi).reshape(len(ch["masks"]), -1)
    return convert.lm_result_to_numpy(res), psi.numpy()


def jax_round(dirty, ch, solver):
    """The same round through the JAX package's ``_chain_solve_batch``,
    on its edge set and (Schur) partition built from the same ``ij``."""
    jc = jcfg.SolverConfig(robust="dcs", linear_solver=solver,
                           dtype="float64", max_iterations=MAX_ITERS)
    f64 = jnp.float64
    e = jp.edge_set_from_graph(dirty.canonical_order(), dtype=f64,
                               pad_to=PAD)
    part = (js.build_partition(np.asarray(e.ij), dirty.num_nodes, BLOCKS,
                               dtype=f64) if solver == "schur" else None)
    res, psi = jgs._chain_solve_batch(
        jnp.asarray(dirty.canonical_order().poses, f64), jnp.ones(PAD, f64),
        e, jnp.asarray(ch["masks"], f64),
        jp.anchor_first_node(dirty.num_nodes, dtype=f64), jc, JSE2, part)
    return convert.lm_result_to_numpy(res), np.asarray(psi)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


@pytest.mark.parametrize("solver", SOLVERS)
def test_batched_lm_solve_matches_the_jax_lanes_and_each_chain_alone(
        dirty, chains, solver):
    cfg = solver_cfg(solver)
    got, psi = port_round(chains, cfg)
    want, jpsi = jax_round(dirty, chains, solver)
    for f in ("iterations", "accepted", "converged"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # The lanes stop at different iterations; one runs to the limit.
    assert len(set(got["iterations"])) == len(chains["masks"])
    assert MAX_ITERS in got["iterations"]
    assert not got["converged"].all() and got["converged"].any()
    for f in ("cost", "initial_cost", "final_lambda", "final_nu"):
        assert rel(got[f], want[f]).max() <= JAX_TOL, f
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=0,
                               atol=JAX_TOL)
    np.testing.assert_allclose(psi, jpsi, rtol=0, atol=JAX_TOL)
    plan = single_plan(chains, solver)
    for c, mask in enumerate(chains["masks"]):
        alone = convert.lm_result_to_numpy(lm_solve(
            chains["poses0"], chains["switches0"],
            chains["edges"]._replace(active=torch.as_tensor(mask)),
            chains["free"], cfg, partition=plan))
        for f in ("iterations", "accepted", "converged"):
            assert got[f][c] == alone[f], (c, f)
        for f in ("cost", "initial_cost", "final_lambda", "final_nu"):
            assert rel(got[f][c], alone[f]) <= SELF_TOL, (c, f)
        np.testing.assert_allclose(got["poses"][c], alone["poses"], rtol=0,
                                   atol=SELF_TOL)


@pytest.mark.parametrize("solver", SOLVERS)
def test_a_lane_is_its_own_to_the_bit(chains, solver):
    """A lane's result depends on its own mask only, to the bit: with
    lanes 0 and 2 swapped, every lane's poses, switches, cost, iterations,
    accepted steps and convergence are what that mask gave before.  So a
    frozen chain, which the rescue re-solves every round as the JAX
    package's vmap does, repeats its result."""
    cfg = solver_cfg(solver)
    every, psi = port_round(chains, cfg)
    order = [2, 1, 0, 3]
    swapped, psi_s = port_round(dict(chains, masks=chains["masks"][order]),
                                cfg)
    for f in ("poses", "switches", "cost", "iterations", "accepted",
              "converged", "final_lambda", "final_nu"):
        np.testing.assert_array_equal(swapped[f], every[f][order],
                                      err_msg=f)
    np.testing.assert_array_equal(psi_s, psi[order])


def test_batched_dense_solve_matches_each_lane(chains):
    """One damped step of the four chains on the batched dense solver:
    one scatter launch assembles all four matrices, one stack factor
    factors them, and each lane's step equals ``dense_solve`` of that
    chain alone."""
    cfg = solver_cfg("dense")
    C = len(chains["masks"])
    cb = tb.chain_batch(chains["poses0"], chains["switches0"],
                        chains["edges"], chains["free"], cfg, None, C)
    kw = dict(model=SE2Model, robust="dcs", dcs_phi=cfg.dcs_phi,
              huber_delta=cfg.huber_delta, sc_prior_lambda=1.0)
    lam = torch.tensor([1e-4, 1e-2, 1.0, 10.0], dtype=torch.float64)
    edges = cb.masked(chains["masks"])
    system = linearize(cb.poses0.reshape(-1, 3), cb.switches0.reshape(-1),
                       edges, cb.free, **kw)
    out = []
    calls = record(lambda: out.append(tl.dense_solve(
        system, edges, lam.repeat_interleave(64)[:, None], cb.partition)))
    assert [name for name, _, _ in calls] == ["scatter_add_rows",
                                              "stack_cholesky"]
    assert calls[0][1][1].grid == ((C,), 64, 64)
    dx = out[0].poses.reshape(C, 64, 3)
    plan = tl.dense_plan(chains["edges"])
    for c, mask in enumerate(chains["masks"]):
        e = chains["edges"]._replace(active=torch.as_tensor(mask))
        alone = tl.dense_solve(
            linearize(chains["poses0"], chains["switches0"], e,
                      chains["free"], **kw), e, lam[c], plan)
        np.testing.assert_allclose(dx[c].numpy(), alone.poses.numpy(),
                                   rtol=0, atol=SELF_TOL)


#: PCG and Woodbury run the rescue capped at 5 LM iterations and 2 rounds.
CAPPED = ("pcg", "woodbury")


def rescue_cfg(solver, n_chains=6) -> jcfg.RunConfig:
    """The JAX package's run of the rescue fixture (as
    ``test_circle_rescue_path_matches`` runs it; capped on the solvers of
    :data:`CAPPED`)."""
    cap = (dict(max_iterations=5, dcs_consensus_rounds=2)
           if solver in CAPPED else dict(max_iterations=15))
    return jcfg.RunConfig(method=1, num_outliers=OUTLIERS, seed=SEED,
                          solver=jcfg.SolverConfig(
                              dtype="float64", linear_solver=solver,
                              dcs_consensus_chains=n_chains,
                              dcs_consensus_drop_frac=0.0, **cap))


@pytest.mark.parametrize("solver,n_chains", [("dense", 6), ("schur", 6),
                                             ("schur", 2), ("pcg", 6),
                                             ("woodbury", 6)])
def test_rescue_matches_the_jax_run(dirty, solver, n_chains):
    """The whole rescue through both packages: identical log records (the
    trigger, rounds, candidates, costs, the chosen chain), poses to
    1e-6."""
    records = compare_runs(dirty, rescue_cfg(solver, n_chains))
    retry = dict(records)["retry"]
    assert retry["candidates"] >= n_chains and retry["rounds"] >= 2


@pytest.mark.parametrize("solver", ["dense", "schur", "pcg", "woodbury"])
def test_a_round_is_one_solve_and_one_psi(dirty, monkeypatch, solver):
    """Each consensus round calls ``lm_solve`` once for all the chains
    and ``loop_psi`` once for all their poses, on every linear solver."""
    calls = {"batched": 0, "psi": 0, "alone": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tb, "lm_solve", counted("batched", tb.lm_solve))
    monkeypatch.setattr(tgs, "lm_solve", counted("alone", tgs.lm_solve))
    monkeypatch.setattr(tgs, "loop_psi", counted("psi", tgs.loop_psi))
    log = Capture()
    cfg = convert.config_from_jax(rescue_cfg(solver))
    tgs.run_global_solve(convert.graph_from_jax(dirty), cfg, log,
                         device="cpu")
    retry = dict(log.records)["retry"]
    gnc = int(retry["candidates"] > cfg.solver.dcs_consensus_chains)
    rounds = retry["rounds"]
    assert rounds >= 2
    assert calls == {"batched": rounds, "psi": 1 + rounds,
                     "alone": 1 + gnc}


@pytest.mark.parametrize("solver", SOLVERS)
def test_a_batched_iteration_launches_as_one_chain(chains, solver):
    """An iteration of the four chains calls each kernel wrapper as often
    as one chain's ``lm_solve``: one linearisation; on the Schur solver
    3 gathers and 4 scatters, on the dense solver the cost's gather, the
    linearisation's scatter and the assembly's."""
    plan = single_plan(chains, solver)
    C = len(chains["masks"])
    cb = tb.chain_batch(chains["poses0"], chains["switches0"],
                        chains["edges"], chains["free"], solver_cfg(solver),
                        plan, C)
    edges = cb.masked(chains["masks"])
    per_batch = _calls_per_iteration(lambda n: tb.lm_solve_batch(
        cb.poses0, cb.switches0, edges, cb.free,
        solver_cfg(solver).replace(max_iterations=n), cb.partition))
    per_chain = _calls_per_iteration(lambda n: lm_solve(
        chains["poses0"], chains["switches0"], chains["edges"],
        chains["free"], solver_cfg(solver).replace(max_iterations=n),
        partition=plan))
    assert per_batch == per_chain
    assert per_batch["fused_linearize_se2_indexed"] == 1
    schur = solver == "schur"
    assert per_batch["gather_rows"] == (3 if schur else 1)
    assert per_batch["scatter_add_rows"] + per_batch.get(
        "scatter_add_groups", 0) == (4 if schur else 2)
