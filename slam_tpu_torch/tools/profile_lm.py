"""Where an LM iteration's time goes on the card, per Schur factorisation.

    python -m slam_tpu_torch.tools.profile_lm [--iters 10]

For INTEL+50 seed 42 (plain DCS, the global solve's set-up) and M10000+50
seed 0 (dataset init, auto partition), float32, and each factorisation --
native, blocked (panel 128) with the plain panel factor, blocked with
``micro_chol_inv`` -- it runs ``2 x --iters`` ``lm_fixed_iters``
iterations to warm up and ``2 x --iters`` unprofiled for the wall clock;
then, once every case has its wall clock (a torch.profiler session
leaves the later host-bound work of its process slower), ``--iters``
under ``torch.profiler``.  It prints one JSON line per case:
wall ms per iteration, the summed device time of the kernels (events on
the CUDA device, so no operator is counted twice) per iteration, their
ratio (the device's busy share), kernel launches per iteration, the
kernels with the most device time, and the linearisation: host µs per
call of the solver's ``linearize`` and of the fused kernel's wrapper
alone (taken with the wall clocks, no sync), and the kernel's device ms
per iteration.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from slam_tpu_torch.tools.problems import CONFIGS, intel50_plain_dcs, \
    m10000


def device_us(event) -> float:
    """Device microseconds of a kernel event (0 for a host operator)."""
    if event.device_type != torch.autograd.DeviceType.CUDA:
        return 0.0
    return float(event.self_device_time_total)


def wall_case(args, cfg, part, iters: int) -> float:
    """Wall ms per iteration of ``2 x iters`` iterations after as many to
    warm up."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    lm_fixed_iters(*args, cfg, 2 * iters, partition=part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm_fixed_iters(*args, cfg, 2 * iters, partition=part)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (2 * iters)


def linearize_host_us(args, cfg, reps: int = 50) -> dict:
    """Host µs per call, no sync, of the solver's ``linearize`` and of the
    fused kernel's wrapper on the initial poses."""
    from slam_tpu_torch.ops.linearize import fused_linearize_se2_indexed
    from slam_tpu_torch.solver.linearize import linearize
    from slam_tpu_torch.solver.models import SE2Model
    from slam_tpu_torch.tools.kernel_times import host_us

    poses, switches, edges, free = args
    poses = poses.to(getattr(torch, cfg.dtype))
    return {
        "linearize_host_us": host_us(lambda: linearize(
            poses, switches, edges, free, model=SE2Model, robust=cfg.robust,
            dcs_phi=cfg.dcs_phi, huber_delta=cfg.huber_delta,
            sc_prior_lambda=cfg.sc_prior_lambda), reps),
        "fused_linearize_host_us": host_us(
            lambda: fused_linearize_se2_indexed(
                poses, free.node, edges, cfg.dcs_phi, cfg.huber_delta,
                robust=cfg.robust), reps),
    }


def profile_case(args, cfg, part, iters: int, top: int,
                 wall_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch.solver.lm import lm_fixed_iters

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lm_fixed_iters(*args, cfg, iters, partition=part)
        torch.cuda.synchronize()
    kernels = [(e.key, device_us(e) / 1e3 / iters, e.count / iters)
               for e in prof.key_averages() if device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    return {
        "wall_ms_per_iter": wall_ms,
        "device_ms_per_iter": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernel_launches_per_iter": sum(k[2] for k in kernels),
        "linearize_kernel_ms_per_iter": sum(
            k[1] for k in kernels if "linearize_se2" in k[0]),
        "top": [{"name": n[:60], "ms_per_iter": ms, "calls_per_iter": c}
                for n, ms, c in kernels[:top]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 1
    from slam_tpu_torch import runtime

    device = runtime.setup_device("cuda")
    prob = intel50_plain_dcs(device, "float32")
    m = m10000(device, torch.float32)
    cases = {
        "INTEL": ((prob.poses0, prob.switches0, prob.edges, prob.free),
                  prob.scfg, prob.partition),
        "M10000": (m.args, m.cfg, m.partition),
    }
    runs = [(label, name, lm_args, base.replace(**kw), part)
            for label, (lm_args, base, part) in cases.items()
            for name, kw in CONFIGS.items()]
    walls = [wall_case(lm_args, cfg, part, args.iters)
             for _, _, lm_args, cfg, part in runs]
    lin = {label: linearize_host_us(lm_args, base)
           for label, (lm_args, base, _) in cases.items()}
    for (label, name, lm_args, cfg, part), wall_ms in zip(runs, walls):
        out = profile_case(lm_args, cfg, part, args.iters, args.top, wall_ms)
        print(json.dumps({"shape": label, "config": name,
                          "card": torch.cuda.get_device_name(0), **out,
                          **lin[label]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
