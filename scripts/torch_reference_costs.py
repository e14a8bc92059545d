"""Reference costs for the PyTorch port's on-card check (``chip_smoke.py``).

Runs the JAX package on the CPU in float64 on the problem that
``chip_smoke.py`` phase 4 solves through ``slam_tpu_torch``: INTEL with 50
injected bogus loops (seed 42), plain DCS (no consensus rescue, no GNC
retry), the same set-up as the global solve (auto init, edges padded to a
multiple of 256, node 0 anchored, the auto Schur partition), 50 iterations
of ``lm_fixed_iters``.  Writes ``slam_tpu_torch/data/reference_costs.json``.

    JAX_PLATFORMS=cpu python scripts/torch_reference_costs.py
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from slam_tpu.config import RunConfig, SolverConfig  # noqa: E402
from slam_tpu.io import g2o  # noqa: E402
from slam_tpu.solver.init import apply_init  # noqa: E402
from slam_tpu.solver.lm import lm_fixed_iters  # noqa: E402
from slam_tpu.solver.problem import (  # noqa: E402
    anchor_first_node,
    edge_set_from_graph,
)
from slam_tpu.solver.schur import build_partition, choose_partition  # noqa

ITERS = 50


def plain_dcs_intel50() -> dict:
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    graph = graph.add_random_outliers(50, seed=42)
    solver = SolverConfig(robust="dcs", linear_solver="schur",
                          dtype="float64", dcs_consensus=False,
                          dcs_auto_retry=False, use_pallas="off")
    cfg = RunConfig(dataset="INTEL", num_outliers=50, method=1, seed=42,
                    solver=solver)
    canon = apply_init(graph.canonical_order(), cfg)
    pad_to = -(-canon.num_edges // 256) * 256
    edges = edge_set_from_graph(canon, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    ij = np.asarray(edges.ij)
    nblocks, node_block = choose_partition(ij, canon.num_nodes,
                                           scheme=solver.schur_partition)
    part = build_partition(ij, canon.num_nodes, nblocks, dtype=jnp.float64,
                           node_block=node_block)
    res = lm_fixed_iters(
        jnp.asarray(canon.poses), jnp.ones((edges.num_edges,)), edges,
        anchor_first_node(canon.num_nodes, dtype=jnp.float64), solver,
        ITERS, partition=part)
    return {
        "problem": "INTEL + 50 bogus loops, seed 42, plain DCS, auto init, "
                   "edges padded to a multiple of 256, node 0 anchored, "
                   f"auto Schur partition ({nblocks} blocks, "
                   f"{'graph' if node_block is not None else 'index'})",
        "iterations": ITERS,
        "initial_cost": float(res.initial_cost),
        "final_cost": float(res.cost),
        "accepted": int(res.accepted),
        "dtype": "float64",
        "backend": "slam_tpu (JAX) on CPU",
    }


def main() -> int:
    out = {
        "command": "JAX_PLATFORMS=cpu python scripts/torch_reference_costs.py",
        "intel50_plain_dcs_lm_fixed_iters": plain_dcs_intel50(),
    }
    path = REPO / "slam_tpu_torch" / "data" / "reference_costs.json"
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
