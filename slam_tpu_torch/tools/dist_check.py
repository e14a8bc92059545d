"""Scale check of the block-per-rank distributed Schur LM.

    python -m slam_tpu_torch.tools.dist_check [--device cuda|cpu]
        [--ranks 8] [--iters 5] [--dtype float32|float64]

The port's counterpart of ``scripts/dist_scale_check.py``: M3500 with 50
bogus loops (seed 0, 3500 nodes), plain DCS, ``--ranks`` map blocks, one
per rank, spawned by ``parallel.mesh.launch`` (gloo ranks sharing the
card on CUDA, or on the CPU); contiguous blocks and the spectral cut
(``solver.partition.graph_partition``, passed as ``node_block``).  The
reference is the single-process partitioned Schur ``lm_fixed_iters`` at
the same block count.  Gates, as that script's: each distributed
initial cost within 1e-3 (relative, floor 1) of the reference's; the
final cost below 0.7 x the initial cost for all three runs.  It prints
each run's ``(ni, ns, ek)``, the separator reduction's bytes per
iteration (``(D ns)^2 + D ns`` values) against all the bytes reduced per
iteration, the wall per iteration, the share of it spent in collectives
(each timed with the device synchronised on both sides), then one JSON
line; the exit code is 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

INIT_RTOL = 1e-3
CONVERGED_FRAC = 0.7


def problem(seed: int = 0, outliers: int = 50):
    """M3500 with ``outliers`` bogus loops, canonical order."""
    from slam_tpu_torch.io import g2o

    graph = g2o.load_g2o(g2o.find_dataset("M3500"))
    return graph.add_random_outliers(outliers, seed=seed).canonical_order()


def single_process(g, ranks: int, cfg, iters: int, device) -> dict:
    """The single-process Schur ``lm_fixed_iters`` at ``ranks`` index
    blocks: its costs, wall and poses (NumPy)."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.solver.schur import build_partition

    dtype = getattr(torch, cfg.dtype)
    edges = edge_set_from_graph(g, dtype=dtype, device=device)
    free = anchor_first_node(g.num_nodes, dtype=dtype, device=device)
    poses0 = torch.as_tensor(g.poses, dtype=dtype, device=device)
    sw0 = torch.ones((edges.num_edges,), dtype=dtype, device=device)
    part = build_partition(g.edges_ij, g.num_nodes, ranks, dtype=dtype,
                           device=device)
    t0 = time.perf_counter()
    res = lm_fixed_iters(poses0, sw0, edges, free, cfg, iters,
                         partition=part)
    cost = float(res.cost)  # synchronises
    return dict(cost0=float(res.initial_cost), cost=cost,
                wall_s=time.perf_counter() - t0,
                poses=res.poses.cpu().numpy())


def run(device="cuda", ranks: int = 8, iters: int = 5,
        dtype: str = "float32") -> dict:
    """Every run's numbers and the gates' verdicts."""
    from slam_tpu_torch import runtime
    from slam_tpu_torch.config import SolverConfig
    from slam_tpu_torch.parallel import mesh
    from slam_tpu_torch.parallel.schur_dist import schur_lm_job
    from slam_tpu_torch.solver.models import model_for_dim
    from slam_tpu_torch.solver.partition import graph_partition

    dev = runtime.setup_device(device)
    g = problem()
    cfg = SolverConfig(robust="dcs", linear_solver="schur", dtype=dtype)
    ref = single_process(g, ranks, cfg, iters, dev)
    del ref["poses"]
    nb = graph_partition(g.edges_ij, g.num_nodes, ranks)
    t0 = time.perf_counter()
    out = mesh.launch(ranks, mesh.run_jobs, [
        (schur_lm_job, (g, ranks, cfg, iters, None, True)),
        (schur_lm_job, (g, ranks, cfg, iters, nb, True))], device=dev,
        timeout=1200, all_ranks=True)
    launch_s = time.perf_counter() - t0
    item = torch.finfo(getattr(torch, dtype)).bits // 8
    runs = {}
    for i, name in enumerate(("contiguous", "spectral")):
        r = [rank[i] for rank in out]
        r0 = r[0]
        D = model_for_dim(g.dim).tangent_dim
        sep = ((D * r0["ns"]) ** 2 + D * r0["ns"]) * item
        runs[name] = dict(
            ni=r0["ni"], ns=r0["ns"], ek=r0["ek"], cost0=r0["cost0"],
            cost=r0["cost"], backend=r0["backend"],
            ranks_bitwise_equal=mesh.bitwise_equal([x["poses"] for x in r]),
            wall_s=max(x["wall_s"] for x in r),
            wall_per_iter_s=max(x["wall_s"] for x in r) / iters,
            separator_bytes_per_iter=sep,
            reduced_bytes_per_iter=r0["bytes"] / iters,
            collectives_per_iter=r0["calls"] / iters,
            collective_share=max(x["seconds"] / x["wall_s"] for x in r),
            setup_s=max(x["setup_s"] for x in r),
            launches_rank0=r0["launches"])
    scale = max(1.0, abs(ref["cost0"]))
    init_ok = all(abs(v["cost0"] - ref["cost0"]) < INIT_RTOL * scale
                  for v in runs.values())
    converged = ref["cost"] < CONVERGED_FRAC * ref["cost0"] and all(
        v["cost"] < CONVERGED_FRAC * v["cost0"] for v in runs.values())
    same = all(v["ranks_bitwise_equal"] for v in runs.values())
    return dict(device=dev.type, ranks=ranks, iters=iters, dtype=dtype,
                single_process=ref, launch_s=launch_s, **runs,
                separator_reduction=runs["contiguous"][
                    "separator_bytes_per_iter"]
                / runs["spectral"]["separator_bytes_per_iter"],
                init_ok=init_ok, converged=converged, ranks_agree=same,
                ok=init_ok and converged and same)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args(argv)
    res = run(args.device, args.ranks, args.iters, args.dtype)
    ref = res["single_process"]
    print(f"single-process schur P={args.ranks}: {ref['cost0']:.6f} -> "
          f"{ref['cost']:.6f} ({ref['wall_s']:.2f} s)")
    for name in ("contiguous", "spectral"):
        r = res[name]
        print(f"distributed schur {args.ranks} ranks ({name}): ni={r['ni']} "
              f"ns={r['ns']} ek={r['ek']}; {r['cost0']:.6f} -> "
              f"{r['cost']:.6f}; {r['wall_per_iter_s'] * 1e3:.1f} ms/iter, "
              f"collectives {100 * r['collective_share']:.1f}% of the wall; "
              f"separator reduction {r['separator_bytes_per_iter'] / 1e6:.2f}"
              f" MB/iter of {r['reduced_bytes_per_iter'] / 1e6:.2f} MB "
              "reduced")
    print(f"separator reduction contiguous / spectral: "
          f"{res['separator_reduction']:.2f}x")
    print("initial-cost match:", "PASS" if res["init_ok"] else "FAIL")
    print("convergence gate:  ", "PASS" if res["converged"] else "FAIL")
    print("ranks agree:       ", "PASS" if res["ranks_agree"] else "FAIL")
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
