"""Methods 3 and 4 through the CLI, held to the manager oracle's streams.

    python3 -m slam_tpu_torch.tools.manager_spread [--device cuda|cpu]
        [--dtype float32|float64] [--fused on|off] [--eval-linear S]
        [--cells intel50_m4,...] [--out FILE]

Each cell runs ``python -m slam_tpu_torch.cli DATASET 50 METHOD --seed S``
(its log lines go to a file, not to stdout; ``--fused`` and
``--eval-linear`` are passed on, the CLI's engine rule applies without
them), parses the run's log and diffs its decision stream against the
oracle's in ``slam_tpu_torch/data/manager_decisions.json``: the identical
prefix, the first divergence, the largest Delta / split-value / residual
differences before it, the chosen layer, and (method 3) the assignments.
It prints one JSON line per cell with the run's wall seconds, its engine,
its chunks and its count of short solves.  The M3500 cells have no oracle
stream: their line is the run's record (its layers, the chosen,
most-visited and most-edges layers, and the chosen layer's ATE against
the golden trajectory).  ``chip_smoke.py`` runs the same cells on the
card and gates them; this tool measures the spread of the differences on
any device and dtype.  ``--profile`` profiles one short solve of each
cell's graph on the card, and with ``--fused on`` the fused engine's run
cut to 16 closures (its busy share and launches per candidate).  Imports
no JAX.
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

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# name: (oracle cell, method, extra CLI arguments)
CELLS = {
    "intel50_m4": ("intel50", 4, []),
    "intel50_m3_ceres": ("intel50", 3, ["--eval-trust-region", "ceres"]),
    "intel50_m3": ("intel50", 3, []),
    "csail50_m3": ("csail50", 3, []),
    "csail50_m4": ("csail50", 4, []),
    "m3500_m4": ("m3500", 4, []),
    "m3500_m3": ("m3500", 3, []),
}
#: Cells without an oracle stream: (dataset, outliers, seed, nodes, the
#: golden trajectory under results/golden).
RECORD_CELLS = {"m3500": ("M3500", 50, 0, 3500, "M3500_50out_seed0.npy")}
DEFAULT_CELLS = [k for k, v in CELLS.items() if v[0] not in RECORD_CELLS]
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


def _summary(lines) -> dict:
    """The fields of a run log's ``[summary]`` and ``[finish]`` lines."""
    out = {}
    for line in lines:
        tag, fields = ms._parse_line(line)
        if tag in ("summary", "finish") and "layer" not in fields:
            out.update(fields)
    return out


def _record(name: str, method: int, lines, poses, golden: str) -> dict:
    """What a cell without an oracle stream reports."""
    from slam_tpu_torch.eval import metrics

    s = _summary(lines)
    parse = ms.parse_m3_log if method == 3 else ms.parse_m4_log
    init = next(ms._parse_line(ln)[1] for ln in lines
                if ln.startswith("[init]") and "candidates=" in ln)
    row = dict(candidates=int(init["candidates"]),
               decisions=len(parse(lines)),
               best_layer=ms.best_layer(lines, method))
    if method == 3:
        row.update(layers=int(s["total_layers"]),
                   most_selected=s["most_selected_layer"])
    else:
        row.update(layers=int(s["total_layers"]),
                   most_visited=s["most_visited"],
                   most_edges=s["most_edges"])
    ref = np.load(os.path.join(REPO, "results", "golden", golden))
    row["ate_best_m"] = metrics.ate(poses, ref)
    return row


def run_cell(name: str, device: str = "cuda", dtype: str | None = None,
             stdout_path: str | None = None, fused: str | None = None,
             eval_linear: str | None = None) -> dict:
    """Run cell ``name`` through ``cli.main`` and diff it against the
    oracle (or, without one, give its record); the CLI's stdout goes to
    ``stdout_path`` (default: discarded with the run's save directory).
    ``fused`` and ``eval_linear`` are the CLI's ``--fused`` and
    ``--eval-linear``."""
    from slam_tpu_torch import cli

    cell, method, extra = CELLS[name]
    if cell in RECORD_CELLS:
        dataset, outliers, seed, nodes, golden = RECORD_CELLS[cell]
        ref = dict(dataset=dataset, outliers=outliers, seed=seed,
                   nodes=nodes)
    else:
        ref = ms.reference(cell)
    with tempfile.TemporaryDirectory() as save:
        argv = [ref["dataset"], str(ref["outliers"]), str(method), "--seed",
                str(ref["seed"]), "--device", device, "--save-path", save,
                *extra]
        if dtype:
            argv += ["--dtype", dtype]
        if fused:
            argv += ["--fused", fused]
        if eval_linear:
            argv += ["--eval-linear", eval_linear]
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
                   fused=eng["fused"] == "True", chunks=int(eng["chunks"]),
                   wall_s=wall, engine_wall_s=float(eng["wall_s"]),
                   short_solves=int(eng["short_solves"]),
                   lm_iterations=int(eng["lm_iterations"]))
        if cell in RECORD_CELLS:
            row.update(_record(name, method, lines, poses, golden))
            return row
        oracle = ref[f"m{method}"]
        row["candidates"] = ref["candidates"]
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


def profile_fused(name: str, candidates: int = 16, top: int = 8) -> dict:
    """Where the fused engine's time goes on the card: cell ``name``'s run
    with the CLI's defaults (float32, the Schur eval) cut to its first
    ``candidates`` closures, once to warm up, once for the wall clock and
    once under ``torch.profiler``, each on a fresh manager: wall and
    summed device time per candidate, their ratio (the device's busy
    share), device launches and hand-written kernel launches per
    candidate, and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch import cli, ops
    from slam_tpu_torch.methods import layering, mcts
    from slam_tpu_torch.tools.profile_lm import device_us
    from slam_tpu_torch.utils.logging import RunLogger

    cell, method, extra = CELLS[name]
    if cell in RECORD_CELLS:
        dataset, outliers, seed = RECORD_CELLS[cell][:3]
    else:
        ref = ms.reference(cell)
        dataset, outliers, seed = ref["dataset"], ref["outliers"], ref["seed"]
    graph = ms.cell_graph(dataset, outliers, seed)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        [dataset, str(outliers), str(method), *extra]))
    engine = layering if method == 3 else mcts

    def manager():
        mgr = engine.make_manager(graph, cfg, RunLogger(echo=False), "cuda",
                                  fused="on")
        mgr.loop_indices = mgr.loop_indices[:candidates]
        return mgr

    manager().run()
    mgr = manager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / candidates
    mgr = manager()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mgr.run()
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    kernels = [(e.key, device_us(e) / 1e3 / candidates, e.count / candidates)
               for e in prof.key_averages() if device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    return dict(
        cell=name, fused=True, candidates=candidates,
        linear_solver=mgr.eval_cfg.linear_solver,
        lm_iterations_per_candidate=mgr.ss.iterations / candidates,
        wall_ms_per_candidate=wall_ms,
        device_ms_per_candidate=device_ms, busy_share=device_ms / wall_ms,
        kernel_launches_per_candidate=sum(k[2] for k in kernels),
        launches_per_candidate={k: n / candidates
                                for k, n in counts.items()},
        top_kernels=[dict(name=k[:60], ms=ms_, count=c)
                     for k, ms_, c in kernels[:top]],
        card=torch.cuda.get_device_name(0))


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
    mgr = engine.make_manager(graph, cfg, RunLogger(echo=False), device,
                              fused="off")
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


def fused_solve_inputs(graph, device, dtype: str, candidates: int) -> tuple:
    """The fused method-3 engine's short-solve inputs, as
    :func:`short_solve_inputs` gives the host engines': the fused engine
    with the CLI's defaults on ``graph`` (its Schur plan on the card), cut
    to its first ``candidates`` closures.  Returns ``(ss, cases)``:
    ``"candidate"``, the last candidate evaluation (a spec's edge mask,
    every node but node 0 free), and ``"window"``, the last windowed
    commit."""
    import torch

    from slam_tpu_torch import cli
    from slam_tpu_torch.methods import layering
    from slam_tpu_torch.solver.problem import FreeMask
    from slam_tpu_torch.utils.logging import RunLogger

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["graph", "0", "3", "--dtype", dtype]))
    mgr = layering.make_manager(graph, cfg, RunLogger(echo=False), device,
                                fused="on")
    ss, seen = mgr.ss, {}
    solve = ss.device_solve

    def record(poses, active, free, num_iters):
        kind = "candidate" if free is ss.free_first.node else "window"
        seen[kind] = (poses, active, free)
        return solve(poses, active, free, num_iters)

    ss.device_solve = record
    mgr.loop_indices = mgr.loop_indices[:candidates]
    mgr.run()
    cases = {kind: (poses, torch.ones_like(active),
                    ss.edges._replace(active=active), FreeMask(node=free))
             for kind, (poses, active, free) in seen.items()}
    return ss, cases


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dtype", default=None, choices=["float32", "float64"])
    p.add_argument("--fused", default=None, choices=["on", "off"],
                   help="the CLI's --fused (default: its auto rule)")
    p.add_argument("--eval-linear", default=None,
                   choices=["schur", "pcg", "dense"],
                   help="the CLI's --eval-linear (fused engines)")
    p.add_argument("--cells", default=",".join(DEFAULT_CELLS),
                   help=f"of {','.join(CELLS)}")
    p.add_argument("--out", default=None,
                   help="also append each JSON line to this file")
    p.add_argument("--profile", action="store_true",
                   help="instead, profile one short solve of each cell's "
                        "graph on the card (with --fused on: the fused "
                        "engine's run cut to 16 closures)")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("manager_spread: no CUDA device", file=sys.stderr)
            return 1
    for name in args.cells.split(","):
        if args.profile and args.fused == "on":
            row = profile_fused(name)
        else:
            row = (profile_short_solve(name) if args.profile
                   else run_cell(name, args.device, args.dtype,
                                 fused=args.fused,
                                 eval_linear=args.eval_linear))
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
