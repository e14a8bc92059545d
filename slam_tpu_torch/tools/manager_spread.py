"""Methods 3 and 4 through the CLI, held to the manager oracle's streams.

    python3 -m slam_tpu_torch.tools.manager_spread [--device cuda|cpu]
        [--dtype float32|float64] [--cells intel50_m4,...] [--out FILE]

Each cell runs ``python -m slam_tpu_torch.cli DATASET 50 METHOD --seed S``
(its log lines go to a file, not to stdout), parses the run's log and
diffs its decision stream against the oracle's in
``slam_tpu_torch/data/manager_decisions.json``: the identical prefix, the
first divergence, the largest Delta / split-value / residual differences
before it, the chosen layer, and (method 3) the assignments.  It prints
one JSON line per cell with the run's wall seconds and its count of short
solves.  ``chip_smoke.py`` runs the same cells on the card and gates
them; this tool measures the spread of the differences on any device and
dtype.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np

from slam_tpu_torch.tools import manager_streams as ms

# name: (oracle cell, method, extra CLI arguments)
CELLS = {
    "intel50_m4": ("intel50", 4, []),
    "intel50_m3_ceres": ("intel50", 3, ["--eval-trust-region", "ceres"]),
    "intel50_m3": ("intel50", 3, []),
    "csail50_m3": ("csail50", 3, []),
    "csail50_m4": ("csail50", 4, []),
}
FILES = {
    3: ("init_nodes.txt", "init_edges.txt", "layers.txt",
        "opt_nodes_method3.txt", "opt_nodes.txt",
        "opt_nodes_most_selected.txt", "method3.log", "plot_best.png",
        "plot_most_selected.png"),
    4: ("init_nodes.txt", "init_edges.txt", "opt_nodes.txt",
        "opt_nodes_most_visited.txt", "opt_nodes_most_edges.txt",
        "method4_stats.txt", "method4.log", "method4_comparison.png"),
}


def engine_record(lines) -> dict:
    """The fields of a run log's ``[engine]`` line."""
    for line in lines:
        if line.startswith("[engine] "):
            return dict(w.split("=", 1) for w in line.split()[1:]
                        if "=" in w)
    raise ValueError("no [engine] line in the log")


def run_cell(name: str, device: str = "cuda", dtype: str | None = None,
             stdout_path: str | None = None) -> dict:
    """Run cell ``name`` through ``cli.main`` and diff it against the
    oracle; the CLI's stdout goes to ``stdout_path`` (default: discarded
    with the run's save directory)."""
    from slam_tpu_torch import cli

    cell, method, extra = CELLS[name]
    ref = ms.reference(cell)
    oracle = ref[f"m{method}"]
    with tempfile.TemporaryDirectory() as save:
        argv = [ref["dataset"], str(ref["outliers"]), str(method), "--seed",
                str(ref["seed"]), "--device", device, "--save-path", save,
                *extra]
        if dtype:
            argv += ["--dtype", dtype]
        out_path = stdout_path or os.path.join(save, "stdout.txt")
        with open(out_path, "w") as out, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: cli.main returned {rc}")
        # The plots need matplotlib (the run logs a [plot] line without).
        plots = importlib.util.find_spec("matplotlib") is not None
        missing = [f for f in FILES[method]
                   if (plots or not f.endswith(".png"))
                   and not os.path.isfile(os.path.join(save, f))]
        if missing:
            raise AssertionError(f"{name}: the run wrote no {missing}")
        with open(os.path.join(save, f"method{method}.log")) as f:
            lines = f.read().splitlines()
        from slam_tpu_torch.io import g2o

        poses = g2o.load_nodes(os.path.join(save, "opt_nodes.txt"))
        if poses.shape != (ref["nodes"], 3) or not np.isfinite(poses).all():
            raise AssertionError(f"{name}: opt_nodes {poses.shape} or "
                                 "non-finite")
        eng = engine_record(lines)
        row = dict(cell=name, method=method, device=device,
                   dtype=eng["dtype"], linear_solver=eng["linear_solver"],
                   wall_s=wall, engine_wall_s=float(eng["wall_s"]),
                   short_solves=int(eng["short_solves"]),
                   lm_iterations=int(eng["lm_iterations"]),
                   candidates=ref["candidates"])
        if method == 3:
            d = ms.diff_m3(ms.parse_m3_log(lines), oracle["decisions"],
                           oracle["tau"])
            with open(os.path.join(save, "layers.txt")) as f:
                assign = [[int(v) for v in ln.split()] for ln in f]
            row["assignments_equal"] = assign == oracle["assignments"]
        else:
            d = ms.diff_m4(ms.parse_m4_log(lines), oracle["decisions"],
                           oracle["tau"], oracle["residual_high"])
        row.update(d)
        row["best_layer"] = ms.best_layer(lines, method)
        row["oracle_best_layer"] = oracle["best_layer"]
    return row


def profile_short_solve(name: str, iters: int = 2, top: int = 8) -> dict:
    """Where one short solve's time goes on the card: an ``iters``-iteration
    solve of cell ``name``'s graph in float32, every edge active, anchored
    at node 0, timed and then profiled as ``tools/profile_lm`` does."""
    import torch

    from slam_tpu_torch.config import LayeringConfig, SolverConfig
    from slam_tpu_torch.methods.layering import ShortSolves, \
        eval_solver_config
    from slam_tpu_torch.tools.profile_lm import profile_case, wall_case

    ref = ms.reference(CELLS[name][0])
    graph = ms.cell_graph(ref["dataset"], ref["outliers"],
                          ref["seed"]).canonical_order()
    cfg = eval_solver_config(SolverConfig(), LayeringConfig(),
                             graph.num_nodes)
    ss = ShortSolves(graph, cfg, "cuda")
    poses = ss.tensor(graph.poses)
    args = (poses, torch.ones_like(ss.edges.active), ss.edges,
            ss.free_first)
    wall = wall_case(args, cfg, ss.plan, iters)
    return dict(cell=name, nodes=graph.num_nodes, iters=iters,
                card=torch.cuda.get_device_name(0),
                **profile_case(args, cfg, ss.plan, iters, top, wall))


def short_solve_inputs(graph, method: int, device, dtype: str,
                       candidates: int) -> tuple:
    """The short solves' inputs as a manager gives them: method ``method``
    with the CLI's defaults on ``graph`` (initialised), cut to its first
    ``candidates`` closures.  Returns ``(ss, cases)``: the manager's
    :class:`ShortSolves` and, per kind, the ``lm_fixed_iters`` arguments
    ``(poses, switches, edges, free)`` of its last such solve --
    ``"candidate"``, a cost evaluation (odometry, a layer's closures and
    the new closure, anchored at node 0), and ``"window"``, a masked solve
    whose free mask holds every node outside one window (method 3's commit
    window, method 4's nodes of the active edges, of the layer that took
    the most closures)."""
    import torch

    from slam_tpu_torch import cli
    from slam_tpu_torch.methods import layering, mcts
    from slam_tpu_torch.solver.problem import FreeMask
    from slam_tpu_torch.utils.logging import RunLogger

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["graph", "0", str(method), "--dtype", dtype]))
    engine = layering if method == 3 else mcts
    mgr = engine.make_manager(graph, cfg, RunLogger(echo=False), device)
    ss, seen = mgr.ss, {}
    costs, solve = ss.costs, ss.solve

    def record_costs(specs, num_iters):
        seen["candidate"] = (*specs[-1], ss.free_first.node)
        return costs(specs, num_iters)

    def record_solve(poses, mask, free, num_iters):
        if isinstance(free, np.ndarray):
            seen["window"] = (poses, mask, free)
        return solve(poses, mask, free, num_iters)

    ss.costs, ss.solve = record_costs, record_solve
    mgr.loop_indices = mgr.loop_indices[:candidates]
    mgr.run()
    if method == 4:
        # Method 4's window solve comes with an expansion, which is rare
        # early in a run: the window solve of the layer with the most
        # closures, by the manager's own code.
        lid = max(mgr.layers, key=lambda k: int(mgr.layers[k].added.sum()))
        mgr._optimize_local_window(lid, mgr.cfg.local_window)
    if set(seen) != {"candidate", "window"}:
        raise AssertionError(f"method {method}: no {'window' if seen else ''}"
                             f" solve in {candidates} candidates")
    cases = {}
    for kind, (poses, mask, free) in seen.items():
        edges = ss.edges._replace(active=ss.tensor(mask))
        cases[kind] = (poses, torch.ones_like(edges.active), edges,
                       FreeMask(node=ss.tensor(free)
                                if isinstance(free, np.ndarray) else free))
    return ss, cases


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default=None, choices=["float32", "float64"])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--out", default=None,
                   help="also append each JSON line to this file")
    p.add_argument("--profile", action="store_true",
                   help="instead, profile one short solve of each cell's "
                        "graph on the card")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("manager_spread: no CUDA device", file=sys.stderr)
            return 1
    for name in args.cells.split(","):
        row = (profile_short_solve(name) if args.profile
               else run_cell(name, args.device, args.dtype))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
