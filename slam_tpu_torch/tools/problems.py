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
PROBLEMS = ("intel", "sphere2500")


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
