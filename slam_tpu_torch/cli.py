"""Command-line driver of the PyTorch port, methods 0-4.

Same positional interface as ``slam_tpu.cli`` (the reference's
``./main DATASET NUM_OUTLIER_LOOPS METHOD``):

    python -m slam_tpu_torch.cli INTEL 50 1 --seed 42 --save-path save

Methods 3 (layering) and 4 (MCTS) run the fused engines (the decision
loop on the device) on CUDA and the host-driven engines on the CPU, unless
``--fused`` says otherwise; ``--checkpoint`` makes any method resumable.
``--sweep`` runs the outlier grid of ``eval/harness.py`` instead of one
solve, and ``--profile DIR`` writes a ``torch.profiler`` trace of the
solve into DIR.
The device is CUDA unless ``--device cpu`` is given; the dtype is float32
on CUDA and float64 on CPU unless ``--dtype`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys

from slam_tpu_torch.config import LayeringConfig, MctsConfig, RunConfig, \
    SolverConfig

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam_tpu_torch",
        description="Robust pose-graph SLAM backend (PyTorch/CUDA port)",
    )
    p.add_argument("dataset",
                   help="dataset name (INTEL, M3500, CSAIL, ...) or .g2o path")
    p.add_argument("num_outliers", type=int,
                   help="number of bogus loops to inject")
    p.add_argument("method", type=int, choices=[0, 1, 2, 3, 4],
                   help="0=baseline 1=DCS 2=SC 3=layering 4=MCTS")
    p.add_argument("--sweep", action="store_true",
                   help="run the outlier sweep grid (methods x counts) "
                        "instead of a single solve; num_outliers becomes the "
                        "maximum count and method the maximum method id")
    p.add_argument("--sweep-seeds", type=int, default=1,
                   help="number of outlier seeds per sweep cell")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the plain kernel versions)")
    p.add_argument("--save-path", default="save")
    p.add_argument("--seed", type=int, default=0,
                   help="outlier-injection PRNG seed")
    p.add_argument("--dcs-phi", type=float, default=0.5)
    p.add_argument("--gnc-iters", type=int, default=0,
                   help="graduated non-convexity: anneal DCS phi from "
                        "phi*gnc-scale down to phi over this many LM "
                        "iterations (0 = off, the reference behaviour)")
    p.add_argument("--gnc-scale", type=float, default=1e4,
                   help="initial phi multiplier for --gnc-iters")
    p.add_argument("--no-dcs-auto-retry", action="store_true",
                   help="disable the DCS closure-dropout GNC auto-retry")
    p.add_argument("--init", default="auto",
                   choices=["auto", "dataset", "chordal"],
                   help="initial guess (see slam_tpu/solver/init.py)")
    p.add_argument("--huber-delta", type=float, default=0.01)
    p.add_argument("--sc-lambda", type=float, default=1.0)
    p.add_argument("--sc-varpro", action="store_true",
                   help="method 2 with variable-projection switch "
                        "elimination (closed-form s*)")
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--linear-solver", default="auto",
                   choices=["auto", "dense", "pcg", "schur", "woodbury"],
                   help="auto: dense up to 512 nodes, schur above; pcg: "
                        "CG with the cyclic-reduction chain "
                        "preconditioner; woodbury: the exact chain + "
                        "low-rank solver for closure-sparse graphs")
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "float64"],
                   help="default: float32 on CUDA, float64 on CPU")
    p.add_argument("--plot", action="store_true",
                   help="write trajectory PNG")
    p.add_argument("--eval-against", default=None,
                   help="nodes file to compute ATE against")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="resumable solves: methods 0-2 persist chunked LM "
                        "state, methods 3/4 persist the fused engine's "
                        "state at chunk boundaries (utils/checkpoint.py); "
                        "re-running with the same FILE resumes")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the solve into DIR "
                        "(TensorBoard-loadable)")
    p.add_argument("--report-stages", action="store_true",
                   help="add per-stage (linearize / linear solve / "
                        "retract+cost) times to the solve report")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="methods 3/4 engine: the fused loop (decisions on "
                        "the device) vs the host-driven loop (auto: fused "
                        "on CUDA, and whenever --checkpoint is given)")
    p.add_argument("--scan-chunk", type=int, default=None,
                   help="fused methods 3/4: candidates per chunk, the "
                        "unit of host read-back and checkpoint (default "
                        "64)")
    p.add_argument("--eval-linear", default=None,
                   choices=[None, "auto", "schur", "pcg", "dense"],
                   help="fused methods 3/4: candidate-evaluation solver "
                        "(auto: the exact partitioned Schur solve on CUDA; "
                        "on the CPU dense up to 2048 nodes and loose PCG "
                        "above; pcg is the analog of the reference's 1-2 "
                        "inexact inner Ceres iterations)")
    p.add_argument("--eval-trust-region", default=None,
                   choices=[None, "nielsen", "ceres"],
                   help="methods 3/4: short-solve bookkeeping of the "
                        "candidate evaluations (ceres = stock-Ceres "
                        "acceptance and radius updates, for decision "
                        "parity with the manager oracle; default nielsen)")
    p.add_argument("--eval-pcg-iters", type=int, default=None,
                   help="methods 3/4: CG cap of the PCG candidate "
                        "evaluations, graphs above 2048 nodes (default 64)")
    p.add_argument("--eval-pcg-rtol", type=float, default=None,
                   help="methods 3/4: relative tolerance of the PCG "
                        "candidate evaluations (default 1e-3)")
    return p


def config_from_args(args) -> RunConfig:
    dtype = args.dtype or ("float32" if args.device == "cuda" else "float64")
    solver = SolverConfig(
        robust="sc_varpro" if args.sc_varpro else "none",
        dcs_phi=args.dcs_phi,
        huber_delta=args.huber_delta,
        sc_prior_lambda=args.sc_lambda,
        max_iterations=args.max_iterations,
        linear_solver=args.linear_solver,
        dtype=dtype,
        gnc_anneal_iters=args.gnc_iters,
        gnc_init_scale=args.gnc_scale,
        dcs_auto_retry=not args.no_dcs_auto_retry,
    )
    return RunConfig(
        dataset=args.dataset,
        num_outliers=args.num_outliers,
        method=args.method,
        seed=args.seed,
        save_path=args.save_path,
        init=args.init,
        report_stages=args.report_stages,
        solver=solver,
        layering=LayeringConfig(**_fused_overrides(args)),
        mcts=MctsConfig(**_fused_overrides(args)),
    )


def _fused_overrides(args) -> dict:
    """Methods 3/4 engine and eval overrides from the command line."""
    out = {}
    if args.scan_chunk:
        out["scan_chunk"] = args.scan_chunk
    if args.eval_linear:
        out["eval_linear"] = args.eval_linear
    if args.eval_pcg_iters:
        out["eval_pcg_max_iters"] = args.eval_pcg_iters
    if args.eval_pcg_rtol:
        out["eval_pcg_rtol"] = args.eval_pcg_rtol
    if args.eval_trust_region:
        out["eval_trust_region"] = args.eval_trust_region
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.sweep:
        return _run_sweep(cfg, args)

    import contextlib

    if args.profile:
        from slam_tpu_torch.utils.profiling import trace
        profile_cm = trace(args.profile)
    else:
        profile_cm = contextlib.nullcontext()

    with profile_cm:
        if cfg.method == 3:
            from slam_tpu_torch.methods.layering import run_from_config \
                as run3
            out = run3(cfg, device=args.device, fused=args.fused,
                       checkpoint=args.checkpoint)
        elif cfg.method == 4:
            from slam_tpu_torch.methods.mcts import run_from_config as run4
            out = run4(cfg, device=args.device, fused=args.fused,
                       checkpoint=args.checkpoint)
        elif args.checkpoint:
            out = _run_checkpointed(cfg, args.checkpoint,
                                    device=args.device)
        else:
            from slam_tpu_torch.methods.global_solve import run_from_config
            out = run_from_config(cfg, device=args.device)

    if args.eval_against:
        from slam_tpu_torch.eval import metrics
        from slam_tpu_torch.io import g2o as g2o_io

        ref = g2o_io.load_nodes(args.eval_against)
        print(f"[eval] ATE vs {args.eval_against}: "
              f"{metrics.ate(out.poses, ref):.6f} m")
    if args.plot:
        import os

        from slam_tpu_torch.viz import plot

        # The reference's do_plot.sh dispatch (do_plot.sh:2-9): the
        # dashboard for a method-4 run, else the trajectory overlay.
        if cfg.method == 4:
            plot.plot_method4_dashboard(cfg.save_path)
        else:
            plot.plot_trajectories(
                os.path.join(cfg.save_path, "init_nodes.txt"),
                os.path.join(cfg.save_path, "opt_nodes.txt"),
                os.path.join(cfg.save_path, "trajectory.png"),
            )
    return 0


def _run_sweep(cfg: RunConfig, args) -> int:
    """The outlier sweep grid: counts 0, 10, 50, 100 up to
    ``num_outliers`` (and it), methods 0 and 1 (and 2 when ``method`` is
    2 or more), ``--sweep-seeds`` seeds; the table is printed and written
    with ``sweep.json`` into the save path (the JAX CLI's rule)."""
    import os

    from slam_tpu_torch.eval import harness
    from slam_tpu_torch.utils.logging import RunLogger

    os.makedirs(cfg.save_path, exist_ok=True)
    counts = sorted({0, *(c for c in (10, 50, 100)
                          if c <= cfg.num_outliers), cfg.num_outliers})
    methods = [m for m in (0, 1, 2) if m <= max(cfg.method, 1)]
    logger = RunLogger(os.path.join(cfg.save_path, "sweep.log"))
    try:
        cells = harness.run_sweep(
            cfg.dataset, methods=methods, outlier_counts=counts,
            seeds=list(range(args.sweep_seeds)), solver=cfg.solver,
            reference_nodes=args.eval_against, save_path=cfg.save_path,
            logger=logger, device=args.device)
        print(harness.format_table(cells))
    finally:
        logger.close()
    return 0


def _run_checkpointed(cfg: RunConfig, ckpt_path: str, device="cuda"):
    """Methods 0-2 with chunked checkpoint/resume (``utils/checkpoint.py``):
    the same ``init_*`` and ``opt_*`` files as the global solve and a
    ``[solve] checkpointed=True`` record.  The solver is the configured
    one, with ``auto``/``schur``/``woodbury`` taken as dense up to 2048
    nodes and PCG above, so that no partition is needed."""
    import os

    import torch

    from slam_tpu_torch import runtime
    from slam_tpu_torch.config import solver_config_for_method
    from slam_tpu_torch.io import g2o as g2o_io
    from slam_tpu_torch.methods.global_solve import GlobalSolveOutput
    from slam_tpu_torch.solver.init import apply_init
    from slam_tpu_torch.solver.problem import anchor_first_node, \
        edge_set_from_graph
    from slam_tpu_torch.utils.checkpoint import CheckpointingSolver, \
        load_checkpoint
    from slam_tpu_torch.utils.logging import RunLogger

    dev = runtime.setup_device(device)
    os.makedirs(cfg.save_path, exist_ok=True)
    logger = RunLogger(os.path.join(cfg.save_path, f"method{cfg.method}.log"))
    try:
        graph = g2o_io.load_g2o(g2o_io.find_dataset(cfg.dataset))
        graph = graph.add_random_outliers(cfg.num_outliers, seed=cfg.seed)
        graph = apply_init(graph, cfg, logger)
        g2o_io.write_nodes(os.path.join(cfg.save_path, "init_nodes.txt"),
                           graph.poses)
        g2o_io.write_edges(os.path.join(cfg.save_path, "init_edges.txt"),
                           graph)

        scfg = solver_config_for_method(cfg.method, cfg.solver)
        if scfg.linear_solver in ("auto", "schur", "woodbury"):
            scfg = scfg.replace(
                linear_solver="dense" if graph.num_nodes <= 2048 else "pcg")
        dtype = getattr(torch, scfg.dtype)
        canon = graph.canonical_order()
        edges = edge_set_from_graph(canon, dtype=dtype, device=dev)
        free = anchor_first_node(canon.num_nodes, dtype=dtype, device=dev)
        poses0 = torch.as_tensor(canon.poses, dtype=dtype, device=dev)
        sw0 = torch.ones((edges.num_edges,), dtype=dtype, device=dev)

        solver = CheckpointingSolver(ckpt_path, chunk_iters=10)
        poses, switches, res = solver.run(poses0, sw0, edges, free, scfg,
                                          total_iters=scfg.max_iterations)
        if res is not None:
            final_cost = float(res.cost)
        else:  # resumed at completion: read the recorded cost
            state, _ = load_checkpoint(ckpt_path)
            final_cost = float(state["cost"])
        logger.log("solve", method=cfg.method, robust=scfg.robust,
                   checkpointed=True, final_cost=final_cost,
                   iterations=scfg.max_iterations)
        poses = poses.cpu().numpy()
        g2o_io.write_nodes(os.path.join(cfg.save_path, "opt_nodes.txt"),
                           poses)
        g2o_io.write_edges(os.path.join(cfg.save_path, "opt_edges.txt"),
                           graph)
    finally:
        logger.close()
    return GlobalSolveOutput(graph=graph, poses=poses,
                             switches=switches.cpu().numpy(), result=res,
                             wall_time_s=0.0)


if __name__ == "__main__":
    sys.exit(main())
