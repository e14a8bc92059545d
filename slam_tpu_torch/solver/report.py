"""Structured per-solve report -- the Ceres ``Summary::FullReport()``
analog.  Port of ``slam_tpu/solver/report.py``: termination, step counts
and costs come from the :class:`LMResult`; per-stage times (linearize /
linear solve / retract+cost) from :func:`measure_stages`, one call of each
stage at the final iterate (CLI ``--report-stages``)."""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class SolveReport:
    termination: str          # CONVERGENCE | NO_CONVERGENCE
    termination_detail: str
    initial_cost: float
    final_cost: float
    iterations: int
    accepted_steps: int
    rejected_steps: int
    inner_linear_iters: int
    final_trust_lambda: float
    wall_s: float
    stage_times_s: dict | None = None

    def fields(self) -> dict:
        d = dataclasses.asdict(self)
        st = d.pop("stage_times_s") or {}
        for k, v in st.items():
            d[f"t_{k}_s"] = round(v, 6)
        return d

    def text(self) -> str:
        lines = [
            "Solver report (slam_tpu_torch; FullReport analog of "
            "main.cpp:164)",
            f"  Cost:        initial {self.initial_cost:.6e}  "
            f"final {self.final_cost:.6e}  "
            f"change {self.initial_cost - self.final_cost:.6e}",
            f"  Iterations:  {self.iterations} "
            f"(accepted {self.accepted_steps}, rejected {self.rejected_steps})",
            f"  Inner linear iterations: {self.inner_linear_iters}",
            f"  Final trust-region lambda: {self.final_trust_lambda:.3e}",
            f"  Termination: {self.termination} ({self.termination_detail})",
            f"  Wall time:   {self.wall_s:.3f}s total"
            + (f", {self.wall_s / max(self.iterations, 1):.4f}s/iteration"
               if self.iterations else ""),
        ]
        if self.stage_times_s:
            lines.append("  Per-iteration stage times:")
            for name, dt in self.stage_times_s.items():
                lines.append(f"    {name:<14s} {dt * 1e3:9.3f} ms")
        return "\n".join(lines)


def build_report(res, scfg, wall_s: float,
                 stage_times: dict | None = None) -> SolveReport:
    """Classify termination and assemble the report from an LMResult."""
    it = int(res.iterations)
    acc = int(res.accepted)
    lam = float(res.final_lambda) if res.final_lambda is not None else 0.0
    if bool(res.converged):
        term = "CONVERGENCE"
        detail = (f"relative cost decrease below function_tolerance="
                  f"{scfg.function_tolerance:g} after {it} iterations")
    elif lam >= 0.99 * scfg.max_lambda:
        term = "NO_CONVERGENCE"
        detail = (f"trust region stalled: lambda reached max_lambda="
                  f"{scfg.max_lambda:g} (every recent step rejected)")
    else:
        term = "NO_CONVERGENCE"
        detail = f"max_iterations={scfg.max_iterations} reached"
    return SolveReport(
        termination=term,
        termination_detail=detail,
        initial_cost=float(res.initial_cost),
        final_cost=float(res.cost),
        iterations=it,
        accepted_steps=acc,
        rejected_steps=it - acc,
        inner_linear_iters=int(res.lin_iters),
        final_trust_lambda=lam,
        wall_s=wall_s,
        stage_times_s=stage_times,
    )


def measure_stages(poses, switches, edges, free, scfg, model,
                   partition=None, reps: int = 2) -> dict:
    """Seconds of one call of each stage at the final iterate: linearize,
    linear solve (at ``init_lambda``) and retract+cost; the best of
    ``reps`` after a warm-up call.  On CUDA, CUDA events around each call
    on an idle stream (so the time includes the host's enqueueing); on
    the CPU, the wall clock."""
    from slam_tpu_torch.solver.lm import _cost_kw, _solve_linear, \
        linear_plan
    from slam_tpu_torch.solver.linearize import cost_only, linearize

    kw = _cost_kw(scfg, model)
    plan = linear_plan(scfg, edges, partition)
    lam = torch.as_tensor(scfg.init_lambda, dtype=poses.dtype,
                          device=poses.device)
    cuda = poses.device.type == "cuda"
    times: dict[str, float] = {}

    def timed(name, fn):
        best, out = float("inf"), None
        for r in range(reps + 1):  # call 0 warms up
            if cuda:
                torch.cuda.synchronize(poses.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                out = fn()
                dt = time.perf_counter() - t0
            if r > 0:
                best = min(best, dt)
        times[name] = best
        return out

    system = timed("linearize", lambda: linearize(poses, switches, edges,
                                                  free, **kw))
    dx, _ = timed("linear_solve", lambda: _solve_linear(system, edges, lam,
                                                        scfg, plan))
    timed("retract_cost", lambda: cost_only(
        model.retract(poses, dx.poses), switches + dx.switches, edges, **kw))
    return times
