"""How far the float64 PCG path of method 2 moves under rounding noise.

Runs ``lm_solve`` of ``python -m slam_tpu.cli INTEL 50 2 --seed 42
--linear-solver pcg`` (auto init, joint switchable constraints, PCG with
the tridiagonal preconditioner, float64) in the JAX package and in the
PyTorch port, both on the CPU, from the initial poses and from
``--perturb`` copies multiplied by ``1 + 1e-15 N(0, 1)``.  Once the CG
solves reach their iteration cap, differences of the last bit grow from
one LM iteration to the next, so the two packages agree only as far as
each agrees with itself under such noise.  Prints one line per input and
a JSON summary.

    JAX_PLATFORMS=cpu python scripts/torch_pcg_spread.py [--perturb 3]
"""

from __future__ import annotations

import argparse
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
import torch  # noqa: E402

from slam_tpu.config import RunConfig, SolverConfig, \
    solver_config_for_method  # noqa: E402
from slam_tpu.io import g2o  # noqa: E402
from slam_tpu.solver import lm as jlm  # noqa: E402
from slam_tpu.solver.init import apply_init  # noqa: E402
from slam_tpu.solver.problem import anchor_first_node, \
    edge_set_from_graph  # noqa: E402
from slam_tpu_torch import convert  # noqa: E402
from slam_tpu_torch.solver import lm as tlm  # noqa: E402
from slam_tpu_torch.solver import problem as tp  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--perturb", type=int, default=3)
    args = ap.parse_args(argv)
    graph = g2o.load_g2o(g2o.find_dataset("INTEL")).add_random_outliers(
        50, seed=42)
    cfg = RunConfig(dataset="INTEL", num_outliers=50, method=2, seed=42,
                    solver=SolverConfig(linear_solver="pcg",
                                        dtype="float64"))
    scfg = solver_config_for_method(2, cfg.solver)
    canon = apply_init(graph.canonical_order(), cfg)
    pad_to = -(-canon.num_edges // 256) * 256
    je = edge_set_from_graph(canon, dtype=jnp.float64, pad_to=pad_to,
                             incidence=False)
    te = tp.edge_set_from_graph(convert.graph_from_jax(canon),
                                dtype=torch.float64, pad_to=pad_to)
    jf = anchor_first_node(canon.num_nodes, dtype=jnp.float64)
    tf = tp.anchor_first_node(canon.num_nodes)
    E = je.num_edges
    runs = {"jax": [], "torch": []}
    for s in range(-1, args.perturb):
        p0 = canon.poses if s < 0 else canon.poses * (
            1 + 1e-15 * np.random.default_rng(s).normal(
                size=canon.poses.shape))
        j = jlm.lm_solve(jnp.asarray(p0), jnp.ones(E), je, jf, scfg)
        t = tlm.lm_solve(torch.as_tensor(p0),
                         torch.ones(E, dtype=torch.float64), te, tf,
                         convert.config_from_jax(scfg))
        for name, r in (("jax", j), ("torch", t)):
            runs[name].append({"input": s, "final_cost": float(r.cost),
                               "accepted": int(r.accepted),
                               "cg_iterations": int(r.lin_iters)})
        print(f"input {s}: jax {float(j.cost):.10f} ({int(j.lin_iters)} "
              f"CG) torch {float(t.cost):.10f} ({int(t.lin_iters)} CG)",
              flush=True)
    ref = runs["jax"][0]["final_cost"]
    summary = {name: {"min_rel_to_jax": min(r["final_cost"] / ref - 1
                                            for r in rs),
                      "max_rel_to_jax": max(r["final_cost"] / ref - 1
                                            for r in rs)}
               for name, rs in runs.items()}
    print(json.dumps({"runs": runs, "spread": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
