"""Structured per-solve report -- the Ceres ``Summary::FullReport()``
analog.  Port of ``slam_tpu/solver/report.py:32-106``; per-stage timing
(``measure_stages``) is ROADMAP A10."""

from __future__ import annotations

import dataclasses


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
