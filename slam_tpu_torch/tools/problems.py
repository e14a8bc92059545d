"""The problems that ``chip_smoke.py`` and the tools here measure.

- INTEL with 50 bogus loops (seed 42), set up as the global solve sets it
  up: auto init, edges padded to a multiple of 256, node 0 anchored, the
  auto Schur partition (16 index blocks), or the dense plan (the joint one
  for switchable constraints), or none for PCG;
- M10000 with 50 bogus loops (seed 0): dataset init, no padding, the auto
  partition (32 spectral blocks).

Either runs plain DCS (method 1 without the rescue), joint switchable
constraints (``"sc"``, method 2) or their variable projection
(``"sc_varpro"``).

- sphere2500 (SE(3)), the recipe of ``bench.py``'s sphere row: 20 loop
  closures moved by N(0, 20) m in translation (``default_rng(5)``) and
  marked bogus, plain DCS, the Schur solver with 4 index blocks,
  :data:`SPHERE_ITERS` ``lm_fixed_iters``.  The partition is built over
  the edge set's own (canonical) order; ``bench.py`` builds it over the
  order before the bogus edges move to the end.

- the seed batch, the recipe of ``bench.py``'s INTEL row: INTEL with 50
  bogus loops of each of seeds 0-7, dataset poses, node 0 anchored, the
  Schur solver with 16 index blocks, each seed's partition padded to the
  maxima of ``partition_stats`` over the seeds, plain DCS, for
  ``solver/batch.py``'s ``lm_fixed_iters_batch``; or the same seeds on
  PCG (``scripts/bench_pcg.py``'s settings: the tridiagonal
  preconditioner, rtol 1e-6, 100 CG iterations) or on the Woodbury
  solver (``scripts/bench_woodbury.py``: each seed's low-rank edges
  padded to the seeds' largest count); each under plain DCS or, for
  method 2, joint switchable constraints (``robust="sc"``: the dense
  solver's plan is then the joint one).

- the chain batch, the DCS rescue's first consensus round on INTEL+50
  seed 42 (method 1, as the global solve sets it up): the plain solve,
  its psi, the first masks of the default chains, and the chains stacked
  by ``solver/batch.py``'s ``chain_batch`` on the Schur, dense, PCG or
  Woodbury solver, for ``lm_solve_batch``.

``CONFIGS`` are the Schur factorisations they are compared under;
:func:`reference_key` and :func:`sphere_reference_key` name the float64
JAX reference of a run in ``slam_tpu_torch/data/reference_costs.json``.
"""

from __future__ import annotations

import functools
import pathlib
from typing import NamedTuple

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
PANEL = 128
CONFIGS = {
    "native": {},
    "blocked_plain": dict(schur_blocked=True, schur_panel=PANEL),
    "blocked_micro": dict(schur_blocked=True, schur_panel=PANEL,
                          schur_pallas_micro=True),
}


ROBUST = ("dcs", "sc", "sc_varpro")
SOLVERS = ("schur", "dense", "pcg")
PROBLEMS = ("intel", "sphere2500", "seed_batch")


def reference_key(robust: str, solver: str, cli: bool = False) -> str:
    """The reference of INTEL+50 under ``robust`` and ``solver``:
    ``lm_fixed_iters`` from the initial poses, or with ``cli`` the
    command-line run (``lm_solve``, method 2 only)."""
    if cli:
        return f"intel50_{robust}_cli"
    if robust == "dcs" and solver == "schur":
        return "intel50_plain_dcs_lm_fixed_iters"
    return f"intel50_{robust}_{solver}_lm_fixed_iters"


def intel50(device, dtype_name: str, method: int = 1, **solver_kw):
    """``setup_problem`` of INTEL+50 seed 42, method ``method``, with
    ``solver_kw`` on the solver config."""
    from slam_tpu_torch.config import RunConfig, SolverConfig
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.methods.global_solve import setup_problem
    from slam_tpu_torch.utils.logging import RunLogger

    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    graph = graph.add_random_outliers(50, seed=42)
    cfg = RunConfig(dataset="INTEL", num_outliers=50, method=method, seed=42,
                    solver=SolverConfig(dtype=dtype_name, **solver_kw))
    return setup_problem(graph, cfg, RunLogger(echo=False), device)


def intel50_plain_dcs(device, dtype_name: str):
    """INTEL+50 for plain DCS: no consensus rescue, no GNC retry."""
    return intel50_plain(device, dtype_name)


def intel50_plain(device, dtype_name: str, robust: str = "dcs",
                  solver: str = "schur"):
    """INTEL+50 under ``robust`` (plain DCS, or method 2's ``sc`` /
    ``sc_varpro``) and the linear solver ``solver``."""
    if robust == "dcs":
        return intel50(device, dtype_name, dcs_consensus=False,
                       dcs_auto_retry=False, linear_solver=solver)
    return intel50(device, dtype_name, method=2, robust=robust,
                   linear_solver=solver)


class FixedCase(NamedTuple):
    """A problem set up for ``lm_fixed_iters`` on the Schur solver."""

    graph: object      # the canonical-order PoseGraph
    args: tuple        # (poses0, switches0, edges, free) for lm_fixed_iters
    cfg: object        # SolverConfig with the Schur solver
    partition: object  # SchurPartition
    spectral: bool     # the auto choice took the spectral scheme


@functools.lru_cache(maxsize=1)
def _m10000_graph():
    """The graph and its partition choice (made once per process)."""
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.solver.schur import choose_partition

    graph = g2o.load_g2o(str(REPO / "data" / "M10000.g2o"))
    graph = graph.add_random_outliers(50, seed=0).canonical_order()
    return graph, choose_partition(graph.edges_ij, graph.num_nodes)


def m10000(device, dtype, robust: str = "dcs") -> FixedCase:
    """M10000+50 under ``robust`` (``"dcs"``, ``"sc"``, ``"sc_varpro"``)
    with the Schur solver."""
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.solver.schur import build_partition

    graph, (nblocks, node_block) = _m10000_graph()
    edges = edge_set_from_graph(graph, dtype=dtype, device=device)
    args = (torch.as_tensor(graph.poses, dtype=dtype, device=device),
            torch.ones((edges.num_edges,), dtype=dtype, device=device),
            edges, anchor_first_node(graph.num_nodes, dtype=dtype,
                                     device=device))
    part = build_partition(graph.edges_ij, graph.num_nodes, nblocks,
                           dtype=dtype, device=device, node_block=node_block)
    cfg = SolverConfig(robust=robust, linear_solver="schur",
                       dtype=str(dtype).replace("torch.", ""))
    return FixedCase(graph, args, cfg, part, node_block is not None)


#: LM iterations of the sphere2500 recipe.
SPHERE_ITERS = 30
#: Index blocks of the sphere2500 recipe's Schur partition.
SPHERE_BLOCKS = 4


def sphere_reference_key(config: str) -> str:
    """The float64 reference of the sphere2500 recipe under a Schur
    factorisation of :data:`CONFIGS` (the blocked ones share theirs: the
    kernel takes float32 panels only)."""
    return ("sphere2500_dcs_schur_native" if config == "native"
            else "sphere2500_dcs_schur_blocked")


@functools.lru_cache(maxsize=1)
def sphere2500_graph():
    """sphere2500 with 20 corrupted closures, in canonical order."""
    import dataclasses

    import numpy as np

    from slam_tpu_torch.io import g2o

    g = g2o.load_g2o(str(REPO / "data" / "sphere2500.g2o")).canonical_order()
    meas = g.edges_meas.copy()
    rng = np.random.default_rng(5)
    loop_idx = np.where(g.edge_type != 0)[0]
    bad = rng.choice(loop_idx, size=20, replace=False)
    meas[bad, :3] += rng.normal(0, 20.0, (20, 3))
    etype = g.edge_type.copy()
    etype[bad] = 2
    return dataclasses.replace(g, edges_meas=meas,
                               edge_type=etype).canonical_order()


def sphere2500(device, dtype) -> FixedCase:
    """The sphere2500 recipe: plain DCS on the Schur solver, 4 index
    blocks, node 0 anchored, no edge padding."""
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.solver.schur import build_partition

    graph = sphere2500_graph()
    edges = edge_set_from_graph(graph, dtype=dtype, device=device)
    args = (torch.as_tensor(graph.poses, dtype=dtype, device=device),
            torch.ones((edges.num_edges,), dtype=dtype, device=device),
            edges, anchor_first_node(graph.num_nodes, dtype=dtype,
                                     device=device))
    part = build_partition(graph.edges_ij, graph.num_nodes, SPHERE_BLOCKS,
                           dtype=dtype, device=device)
    cfg = SolverConfig(robust="dcs", linear_solver="schur",
                       dtype=str(dtype).replace("torch.", ""))
    return FixedCase(graph, args, cfg, part, False)


#: Seeds, Schur index blocks and LM iterations of the seed batch
#: (``bench.py``'s INTEL row: ``BATCH``, ``NUM_BLOCKS``, ``LM_ITERS``).
BATCH_SEEDS = tuple(range(8))
BATCH_BLOCKS = 16
BATCH_ITERS = 50
#: PCG's settings in ``scripts/bench_pcg.py`` (its ``rtol``, ``maxit``).
BENCH_PCG = dict(pcg_rtol=1e-6, pcg_max_iters=100,
                 pcg_preconditioner="tridiag")
#: PCG's settings and LM iterations for the joint-SC seed batch: those of
#: ``chip_smoke.py``'s method-2 PCG check (the CLI's defaults: rtol 1e-8,
#: at most 250 CG iterations), 10 iterations (the CG loop is host-bound).
SC_PCG = dict(pcg_rtol=1e-8, pcg_max_iters=250, pcg_preconditioner="tridiag")
SC_PCG_ITERS = 10
#: The joint-SC seed batch's configurations: (linear solver, the
#: SolverConfig fields it sets).
SC_BATCH_CONFIGS = {
    "native": ("schur", CONFIGS["native"]),
    "blocked_micro": ("schur", CONFIGS["blocked_micro"]),
    "dense": ("dense", {}),
    "woodbury": ("woodbury", {}),
    "pcg": ("pcg", {}),
}


class BatchCase(NamedTuple):
    """The seed batch and what runs each seed alone on its share of it."""

    graphs: list       # each seed's canonical-order PoseGraph
    batch: object      # solver.batch.SeedBatch
    cfg: object        # SolverConfig: its robust mode on the batch's solver
    alone: list        # per seed: (lm_fixed_iters args, its plan)
    plan: object       # the batch's plan (batch.partition on Schur)


def intel50_seed_batch(device, dtype, linear_solver: str = "schur",
                       robust: str = "dcs") -> BatchCase:
    """``bench.py``'s batch: ``add_random_outliers(50, seed=s)`` of INTEL
    for each seed, stacked by ``solver.batch.seed_batch``; and each seed
    alone, with the same poses and free mask and its plan: on Schur its
    partition built with the batch's pad shapes (the shapes it has inside
    the batch), on Woodbury its own low-rank edges, on the dense solver
    its own dense plan.  ``linear_solver`` "pcg" and "woodbury" are
    ``scripts/bench_pcg.py``'s and ``scripts/bench_woodbury.py``'s batches
    of the same seeds.  ``robust``: "dcs" (plain DCS) or "sc" (joint
    switchable constraints, method 2; on PCG :data:`SC_PCG`)."""
    import numpy as np

    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.solver.batch import batch_plan, seed_batch
    from slam_tpu_torch.solver.linear import dense_plan
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.solver.schur import build_partition
    from slam_tpu_torch.solver.woodbury import build_woodbury_ops

    if robust not in ("dcs", "sc"):
        raise ValueError(f"the seed batch runs dcs or sc, not {robust!r}")
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    graphs = [graph.add_random_outliers(50, seed=s).canonical_order()
              for s in BATCH_SEEDS]
    batch = seed_batch(graphs, BATCH_BLOCKS, dtype=dtype, device=device)

    def own_plan(g, edges):
        if linear_solver == "schur":
            return build_partition(np.asarray(g.edges_ij), g.num_nodes,
                                   BATCH_BLOCKS, dtype=dtype, device=device,
                                   pad_shapes=batch.pad_shapes)
        if linear_solver == "woodbury":
            return build_woodbury_ops(edges.ij.cpu().numpy(), g.num_nodes,
                                      device=device)
        if linear_solver == "dense":
            return dense_plan(edges, switches=robust == "sc")
        return None

    alone = []
    for b, g in enumerate(graphs):
        edges = edge_set_from_graph(g, dtype=dtype, device=device,
                                    pad_to=batch.switches0.shape[1])
        alone.append(((batch.poses0[b], batch.switches0[b], edges,
                       anchor_first_node(g.num_nodes, dtype=dtype,
                                         device=device)),
                      own_plan(g, edges)))
    cfg = SolverConfig(robust=robust, linear_solver=linear_solver,
                       dtype=str(dtype).replace("torch.", ""),
                       **(({"dcs": BENCH_PCG, "sc": SC_PCG}[robust])
                          if linear_solver == "pcg" else {}))
    plan = (batch.partition if linear_solver == "schur" else
            batch_plan(batch.edges, linear_solver, batch.seeds, robust))
    return BatchCase(graphs, batch, cfg, alone, plan)


class ChainCase(NamedTuple):
    """The rescue's first consensus round, set up for ``lm_solve_batch``."""

    prob: object       # methods.global_solve.Problem of INTEL+50 seed 42
    chains: object     # solver.batch.ChainBatch
    masks: object      # (C, E) the first round's masks, times the base mask

    @property
    def args(self) -> tuple:
        """``(poses0, switches0, edges, free)`` of the chains, stacked,
        their edges under the first round's masks."""
        c = self.chains
        return (c.poses0, c.switches0, c.masked(self.masks), c.free)

    @property
    def flat_args(self) -> tuple:
        """The same as one flat problem, for ``lm_fixed_iters``."""
        p, s, e, f = self.args
        return (p.reshape(-1, p.shape[-1]), s.reshape(-1), e, f)


def intel50_chains(device, dtype_name: str, linear_solver: str = "auto",
                   masks=None) -> ChainCase:
    """INTEL+50 seed 42 under the rescue's first round: its chains stacked
    on ``linear_solver`` ("auto" is the Schur solver at INTEL's size;
    "dense", "pcg" or "woodbury"), under ``masks`` or the masks the rescue
    builds from the plain solve on that solver."""
    from slam_tpu_torch.methods.global_solve import first_chain_masks
    from slam_tpu_torch.solver.batch import chain_batch
    from slam_tpu_torch.solver.linearize import loop_psi
    from slam_tpu_torch.solver.lm import lm_solve
    from slam_tpu_torch.solver.models import model_for_dim

    prob = intel50(device, dtype_name, linear_solver=linear_solver)
    cfg, edges = prob.scfg, prob.edges
    C = cfg.dcs_consensus_chains
    base = edges.active.cpu().numpy()
    if masks is None:
        res = lm_solve(prob.poses0, prob.switches0, edges, prob.free, cfg,
                       partition=prob.partition)
        psi = loop_psi(res.poses, edges, model_for_dim(res.poses.shape[-1]),
                       cfg.dcs_phi)
        masks = first_chain_masks(
            psi.cpu().numpy(), base * edges.is_loop.cpu().numpy(), base, C,
            42, cfg.dcs_consensus_cut) * base
    return ChainCase(prob, chain_batch(prob.poses0, prob.switches0, edges,
                                       prob.free, cfg, prob.partition, C),
                     masks)

