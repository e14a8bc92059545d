"""Where an LM iteration's time goes on the card, per linear solver.

    python -m slam_tpu_torch.tools.profile_lm [--iters 10]
        [--robust dcs|sc|sc_varpro] [--linear-solver schur|dense|pcg]
        [--problem intel|sphere2500]

``--robust``: plain DCS (method 1 without the rescue), joint switchable
constraints or their variable projection (method 2).  With the Schur
solver (the default) it profiles INTEL+50 seed 42 (the global solve's
set-up) and M10000+50 seed 0 (dataset init, auto partition), float32,
under each factorisation -- native, blocked (panel 128) with the plain
panel factor, blocked with ``micro_chol_inv``; with the dense or the PCG
solver, INTEL+50 alone.  ``--problem sphere2500`` profiles the
sphere2500 SE(3) recipe instead (plain DCS, Schur with 4 index blocks;
``tools/problems.py``) under the three factorisations.  Each case runs
``2 x --iters`` ``lm_fixed_iters`` iterations to warm up and ``2 x
--iters`` unprofiled
for the wall clock; then, once every case has its wall clock (a
torch.profiler session leaves the later host-bound work of its process
slower), ``--iters`` (PCG: :data:`PCG_PROFILE_ITERS`) under
``torch.profiler``.  It prints one JSON line per case: wall ms per
iteration, the summed device time of the kernels (events on the CUDA
device, so no operator is counted twice) per iteration, their ratio (the
device's busy share), kernel launches per iteration and the hand-written
kernels' launches per iteration, the kernels with the most device time,
and the linearisation: host µs per call of the solver's ``linearize`` and
of the fused kernel's wrapper alone (DCS; taken with the wall clocks, no
sync), and the kernel's device ms per iteration.  PCG cases add the CG
iterations per LM iteration (in the wall clock's window and in the
profiled one) and the wall ms, device ms, device launches and
hand-written kernel launches per CG iteration; their busy share is taken
per CG iteration.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from slam_tpu_torch.tools.problems import CONFIGS, PROBLEMS, ROBUST, \
    SOLVERS, intel50_plain, m10000, sphere2500

#: LM iterations of a PCG case under the profiler (each runs up to
#: ``pcg_max_iters`` CG iterations of a few hundred launches).
PCG_PROFILE_ITERS = 2


def device_us(event) -> float:
    """Device microseconds of a kernel event (0 for a host operator)."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(event.self_device_time_total)


def wall_case(args, cfg, part, iters: int) -> tuple[float, float]:
    """Wall ms and CG iterations per LM iteration of ``2 x iters``
    iterations after as many to warm up."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    lm_fixed_iters(*args, cfg, 2 * iters, partition=part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lm_fixed_iters(*args, cfg, 2 * iters, partition=part)
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3 / (2 * iters),
            res.lin_iters / (2 * iters))


def linearize_host_us(args, cfg, reps: int = 50) -> dict:
    """Host µs per call, no sync, of the solver's ``linearize`` and of the
    fused kernel's wrapper on the initial poses."""
    from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed
    from slam_tpu_torch.solver.linearize import linearize
    from slam_tpu_torch.solver.models import model_for_dim
    from slam_tpu_torch.tools.kernel_times import host_us

    poses, switches, edges, free = args
    poses = poses.to(getattr(torch, cfg.dtype))
    model = model_for_dim(poses.shape[-1])
    out = {"linearize_host_us": host_us(lambda: linearize(
        poses, switches, edges, free, model=model, robust=cfg.robust,
        dcs_phi=cfg.dcs_phi, huber_delta=cfg.huber_delta,
        sc_prior_lambda=cfg.sc_prior_lambda), reps)}
    if cfg.robust in ("none", "dcs") and model.pose_dim == 3:
        # the fused kernel's modes and graphs
        out["fused_linearize_host_us"] = host_us(
            lambda: fused_linearize_se2_indexed(
                poses, free.node, edges, cfg.dcs_phi, cfg.huber_delta,
                robust=cfg.robust), reps)
    return out


def profile_case(args, cfg, part, iters: int, top: int,
                 wall: tuple[float, float]) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = lm_fixed_iters(*args, cfg, iters, partition=part)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    kernels = [(e.key, device_us(e) / 1e3 / iters, e.count / iters)
               for e in prof.key_averages() if device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    wall_ms, wall_cg = wall
    out = {
        "wall_ms_per_iter": wall_ms,
        "device_ms_per_iter": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_launches_per_iter": launches,
        "wrapper_launches_per_iter": {k: n / iters
                                      for k, n in counts.items()},
        "linearize_kernel_ms_per_iter": sum(
            k[1] for k in kernels if "linearize_se2" in k[0]),
        "top": [{"name": n[:60], "ms_per_iter": ms, "calls_per_iter": c}
                for n, ms, c in kernels[:top]],
    }
    if cfg.linear_solver == "pcg":
        # The wall clock's window runs more CG iterations per LM iteration
        # than the profiled one (from the initial poses): compare them per
        # CG iteration.
        cg = res.lin_iters / iters
        per_cg = device_ms / cg
        out["cg_iters_per_iter"] = {"wall": wall_cg, "profiled": cg}
        out["busy_share"] = per_cg / (wall_ms / wall_cg)
        out["per_cg_iter"] = {
            "wall_ms": wall_ms / wall_cg, "device_ms": per_cg,
            "kernel_launches": launches / cg,
            **{k: n / res.lin_iters for k, n in counts.items()}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--robust", default="dcs", choices=ROBUST)
    ap.add_argument("--linear-solver", default="schur", choices=SOLVERS)
    ap.add_argument("--problem", default="intel", choices=PROBLEMS)
    args = ap.parse_args(argv)
    if args.problem == "sphere2500" and (args.robust != "dcs"
                                         or args.linear_solver != "schur"):
        raise ValueError("sphere2500 is the plain-DCS Schur recipe")
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 1
    from slam_tpu_torch import runtime

    device = runtime.setup_device("cuda")
    solver = args.linear_solver
    configs = {solver: {}}
    if args.problem == "sphere2500":
        m = sphere2500(device, torch.float32)
        cases = {"sphere2500": (m.args, m.cfg, m.partition)}
        configs = CONFIGS
    else:
        prob = intel50_plain(device, "float32", args.robust, solver)
        cases = {"INTEL": ((prob.poses0, prob.switches0, prob.edges,
                            prob.free), prob.scfg, prob.partition)}
    if solver == "schur" and args.problem == "intel":
        m = m10000(device, torch.float32, args.robust)
        cases["M10000"] = (m.args, m.cfg, m.partition)
        configs = CONFIGS
    runs = [(label, name, lm_args, base.replace(**kw), part)
            for label, (lm_args, base, part) in cases.items()
            for name, kw in configs.items()]
    walls = [wall_case(lm_args, cfg, part, args.iters)
             for _, _, lm_args, cfg, part in runs]
    lin = {label: linearize_host_us(lm_args, base)
           for label, (lm_args, base, _) in cases.items()}
    for (label, name, lm_args, cfg, part), wall in zip(runs, walls):
        out = profile_case(lm_args, cfg, part,
                           PCG_PROFILE_ITERS if solver == "pcg"
                           else args.iters, args.top, wall)
        print(json.dumps({"shape": label, "robust": args.robust,
                          "config": name,
                          "card": torch.cuda.get_device_name(0), **out,
                          **lin[label]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
