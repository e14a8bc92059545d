"""Reference costs for the PyTorch port's on-card check (``chip_smoke.py``).

Runs the JAX package on the CPU in float64 on the problems that
``chip_smoke.py`` solves through ``slam_tpu_torch``, and writes
``slam_tpu_torch/data/reference_costs.json``:

- INTEL with 50 injected bogus loops (seed 42), set up as the global solve
  sets it up (auto init, edges padded to a multiple of 256, node 0
  anchored, the auto Schur partition), ``lm_fixed_iters`` from the initial
  poses: plain DCS (no consensus rescue, no GNC retry) on the Schur solver,
  50 iterations; joint switchable constraints (method 2) on the Schur and
  the dense solver, 50; their variable projection on the Schur solver, 50;
  plain DCS and joint SC on PCG with the tridiagonal preconditioner, 10;
- the command-line run of method 2, ``INTEL 50 2 --seed 42``, and of
  ``--sc-varpro``: final cost, steps, and the count of loop edges whose
  switch in ``switches.txt`` is below 0.5.

    JAX_PLATFORMS=cpu python scripts/torch_reference_costs.py
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import tempfile

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
from slam_tpu.methods.global_solve import run_from_config  # noqa: E402
from slam_tpu.solver.init import apply_init  # noqa: E402
from slam_tpu.solver.lm import lm_fixed_iters  # noqa: E402
from slam_tpu.solver.problem import (  # noqa: E402
    anchor_first_node,
    edge_set_from_graph,
)
from slam_tpu.solver.schur import build_partition, choose_partition  # noqa

BACKEND = "slam_tpu (JAX) on CPU"
# (key, robust, linear solver, iterations) of the lm_fixed_iters runs.
FIXED = [
    ("intel50_plain_dcs_lm_fixed_iters", "dcs", "schur", 50),
    ("intel50_sc_schur_lm_fixed_iters", "sc", "schur", 50),
    ("intel50_sc_dense_lm_fixed_iters", "sc", "dense", 50),
    ("intel50_sc_varpro_schur_lm_fixed_iters", "sc_varpro", "schur", 50),
    ("intel50_dcs_pcg_lm_fixed_iters", "dcs", "pcg", 10),
    ("intel50_sc_pcg_lm_fixed_iters", "sc", "pcg", 10),
]


def fixed_iters(robust: str, solver_name: str, iters: int) -> dict:
    graph = g2o.load_g2o(g2o.find_dataset("INTEL"))
    graph = graph.add_random_outliers(50, seed=42)
    solver = SolverConfig(robust=robust, linear_solver=solver_name,
                          dtype="float64", dcs_consensus=False,
                          dcs_auto_retry=False, use_pallas="off")
    cfg = RunConfig(dataset="INTEL", num_outliers=50,
                    method=1 if robust == "dcs" else 2, seed=42,
                    solver=solver)
    canon = apply_init(graph.canonical_order(), cfg)
    pad_to = -(-canon.num_edges // 256) * 256
    edges = edge_set_from_graph(canon, dtype=jnp.float64, pad_to=pad_to,
                                incidence=False)
    part, what = None, solver_name
    if solver_name == "schur":
        ij = np.asarray(edges.ij)
        nblocks, node_block = choose_partition(ij, canon.num_nodes,
                                               scheme=solver.schur_partition)
        part = build_partition(ij, canon.num_nodes, nblocks,
                               dtype=jnp.float64, node_block=node_block)
        what = (f"auto Schur partition ({nblocks} blocks, "
                f"{'graph' if node_block is not None else 'index'})")
    elif solver_name == "pcg":
        what = (f"PCG ({solver.pcg_preconditioner} preconditioner, "
                f"rtol {solver.pcg_rtol:g}, at most "
                f"{solver.pcg_max_iters} iterations)")
    elif solver_name == "dense":
        what = "dense joint Cholesky" if robust == "sc" else "dense Cholesky"
    res = lm_fixed_iters(
        jnp.asarray(canon.poses), jnp.ones((edges.num_edges,)), edges,
        anchor_first_node(canon.num_nodes, dtype=jnp.float64), solver,
        iters, partition=part)
    label = {"dcs": "plain DCS", "sc": "joint switchable constraints",
             "sc_varpro": "switchable constraints by variable projection"}
    return {
        "problem": f"INTEL + 50 bogus loops, seed 42, {label[robust]}, auto "
                   "init, edges padded to a multiple of 256, node 0 "
                   f"anchored, {what}",
        "iterations": iters,
        "initial_cost": float(res.initial_cost),
        "final_cost": float(res.cost),
        "accepted": int(res.accepted),
        "cg_iterations": int(res.lin_iters),
        "dtype": "float64",
        "backend": BACKEND,
    }


def cli_run(robust: str) -> dict:
    """``python -m slam_tpu.cli INTEL 50 2 --seed 42`` (``--sc-varpro``
    for ``sc_varpro``) in float64."""
    with tempfile.TemporaryDirectory() as save:
        cfg = RunConfig(dataset="INTEL", num_outliers=50, method=2, seed=42,
                        save_path=save, solver=SolverConfig(
                            robust="sc_varpro" if robust == "sc_varpro"
                            else "none", dtype="float64"))
        out = run_from_config(cfg)
        with open(os.path.join(save, "switches.txt")) as f:
            rows = [line.split() for line in f]
    loops = [float(r[4]) for r in rows if len(r) == 5 and r[2] != "0"]
    res = out.result
    flag = " --sc-varpro" if robust == "sc_varpro" else ""
    return {
        "problem": f"python -m slam_tpu.cli INTEL 50 2 --seed 42{flag} "
                   "(auto init, auto solver: Schur, 16 index blocks)",
        "iterations": int(res.iterations),
        "initial_cost": float(res.initial_cost),
        "final_cost": float(res.cost),
        "accepted": int(res.accepted),
        "loop_edges": len(loops),
        "loop_switches_below_half": int(sum(v < 0.5 for v in loops)),
        "dtype": "float64",
        "backend": BACKEND,
    }


def main() -> int:
    out = {"command": "JAX_PLATFORMS=cpu python "
                      "scripts/torch_reference_costs.py"}
    for key, robust, solver, iters in FIXED:
        out[key] = fixed_iters(robust, solver, iters)
        print(key, out[key]["final_cost"], flush=True)
    for robust in ("sc", "sc_varpro"):
        out[f"intel50_{robust}_cli"] = cli_run(robust)
    path = REPO / "slam_tpu_torch" / "data" / "reference_costs.json"
    path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
