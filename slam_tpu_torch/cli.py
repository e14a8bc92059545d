"""Command-line driver of the PyTorch port, methods 0 and 1.

Same positional interface as ``slam_tpu.cli`` (the reference's
``./main DATASET NUM_OUTLIER_LOOPS METHOD``):

    python -m slam_tpu_torch.cli INTEL 50 1 --seed 42 --save-path save

The device is CUDA unless ``--device cpu`` is given; the dtype is float32 on
CUDA and float64 on CPU unless ``--dtype`` says otherwise.
"""

from __future__ import annotations

import argparse
import sys

from slam_tpu.config import RunConfig, SolverConfig

# Flags of the JAX CLI whose code paths are not ported yet, and where the
# ROADMAP queues them.
_NOT_PORTED = {
    "sweep": "A17 (sweeps)",
    "checkpoint": "A17 (checkpointed solves)",
    "profile": "A17 (profiling)",
    "report_stages": "A10 (measure_stages)",
    "sc_varpro": "A9 (method 2)",
}


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
                   help="0=baseline 1=DCS (2=SC 3=layering 4=MCTS are not "
                        "ported yet)")
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
                   help="method 2 variant (not ported yet)")
    p.add_argument("--max-iterations", type=int, default=50)
    p.add_argument("--linear-solver", default="auto",
                   choices=["auto", "dense", "schur"],
                   help="auto: dense up to 512 nodes, schur above")
    p.add_argument("--dtype", default=None,
                   choices=[None, "float32", "float64"],
                   help="default: float32 on CUDA, float64 on CPU")
    p.add_argument("--plot", action="store_true",
                   help="write trajectory PNG")
    p.add_argument("--eval-against", default=None,
                   help="nodes file to compute ATE against")
    p.add_argument("--sweep", action="store_true", help="not ported yet")
    p.add_argument("--checkpoint", default=None, help="not ported yet")
    p.add_argument("--profile", default=None, help="not ported yet")
    p.add_argument("--report-stages", action="store_true",
                   help="not ported yet")
    return p


def config_from_args(args) -> RunConfig:
    dtype = args.dtype or ("float32" if args.device == "cuda" else "float64")
    solver = SolverConfig(
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
        solver=solver,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported yet (ROADMAP "
                f"{item})")
    if args.method == 2:
        raise NotImplementedError("method 2 is not ported yet (ROADMAP A9)")
    if args.method in (3, 4):
        raise NotImplementedError(
            f"method {args.method} is not ported yet (ROADMAP A14)")
    cfg = config_from_args(args)

    from slam_tpu_torch.methods.global_solve import run_from_config

    out = run_from_config(cfg, device=args.device)

    if args.eval_against:
        from slam_tpu.eval import metrics
        from slam_tpu.io import g2o as g2o_io

        ref = g2o_io.load_nodes(args.eval_against)
        print(f"[eval] ATE vs {args.eval_against}: "
              f"{metrics.ate(out.poses, ref):.6f} m")
    if args.plot:
        import os

        from slam_tpu.viz import plot

        plot.plot_trajectories(
            os.path.join(cfg.save_path, "init_nodes.txt"),
            os.path.join(cfg.save_path, "opt_nodes.txt"),
            os.path.join(cfg.save_path, "trajectory.png"),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
