"""Whether what the timed path produced is correct.

Every request of a run solves the same lanes from the same start, so the
plain reference (``portbench/reference/lm.py``) solves each lane once, in
float64, and every answer of the window is judged against it: each lane
of each answer is scored by the reference's own objective ``f`` (the
lane's robust objective, in float64) at the poses and switches the
program returned; its excess is

    (f(program's answer) - f(reference's answer)) / f(reference's answer)

(infinite where the answer is not finite).  Two numbers are compared:

    median_lane_excess = max over answers of the median of its lanes'
                         excesses;
    lane_shortfall     = max over answers and lanes of
                         (f(program's answer) - f(reference's answer))
                         / (f(start) - f(reference's answer)),

the share of the reference's own descent from the lane's start that the
program's lane failed to make: a lane left at its start reads exactly 1.

It covers every layer the solve runs: the robust kernel, the residuals
and Jacobians, the assembly and the linear solve, and the LM damping,
acceptance and update all decide where 50 iterations end.  The median
and its sign, not the largest lane's distance: in float32 a lane's 50
iterations can end in another basin of its non-convex objective than the
float64 reference's, lower or higher, on one to four lanes in eight, and
the program itself moves a lane so under a one-ulp change of its start
(PERF.md, Findings); an answer below the reference's objective is a better
solve of the same problem, not a wrong one.  A basin change leaves a lane
far below its start, so ``lane_shortfall`` holds every lane, the one that
the median lets through included.  Answers that equal another to the bit
are scored once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import lm as ref


class Verdict(NamedTuple):
    correct: bool
    failed: int            # answers with a lane over the limit
    numbers: dict          # name -> {"value", "limit"}


def settings(config: dict, traffic: dict) -> ref.Settings:
    s = config["solver"]
    return ref.Settings(
        robust=traffic["robust"], dcs_phi=s["dcs_phi"],
        huber_delta=s["huber_delta"], sc_prior_lambda=s["sc_prior_lambda"],
        init_lambda=s["init_lambda"], min_lambda=s["min_lambda"],
        max_lambda=s["max_lambda"], iters=traffic["lm_iters"])


def lanes(graphs) -> list[ref.Lane]:
    return [ref.Lane(poses=g.poses, ij=g.ij, meas=g.meas, loop=g.etype != 0)
            for g in graphs]


class Target(NamedTuple):
    cost: float            # the reference's final objective of a lane
    cost0: float           # the objective at the lane's start


def reference_targets(graphs, st: ref.Settings, device,
                      tf32: bool = False) -> list[Target]:
    """The reference's final and starting objective of each lane."""
    return [Target(r.cost, r.cost0)
            for r in ref.solve(lanes(graphs), st, device, tf32=tf32)]


def distinct(answers):
    """The answers that differ from every earlier one in some bit, with
    how many answers each stands for."""
    out = []
    for a in answers:
        for k, (b, n) in enumerate(out):
            if torch.equal(a.poses, b.poses) and \
                    torch.equal(a.switches, b.switches):
                out[k] = (b, n + 1)
                break
        else:
            out.append((a, 1))
    return out


def lane_costs(answer, graphs, st: ref.Settings) -> list[float]:
    """The float64 objective of each lane of ``answer`` (poses (B, N, 3),
    switches (B, E)); infinite where the answer is not finite."""
    out = []
    for b, lane in enumerate(lanes(graphs)):
        E = lane.ij.shape[0]
        poses, sw = answer.poses[b], answer.switches[b, :E]
        if not (bool(torch.isfinite(poses).all())
                and bool(torch.isfinite(sw).all())):
            out.append(math.inf)
            continue
        c = ref.lane_cost(lane, st, poses, sw)
        out.append(c if math.isfinite(c) else math.inf)
    return out


def lane_excesses(costs, targets) -> list[float]:
    return [(c - t.cost) / t.cost for c, t in zip(costs, targets)]


def lane_shortfalls(costs, targets) -> list[float]:
    out = []
    for c, t in zip(costs, targets):
        span = t.cost0 - t.cost
        out.append((c - t.cost) / span if span > 0 else
                   (0.0 if c <= t.cost else math.inf))
    return out


def numbers(costs, targets) -> dict:
    """The compared numbers of one answer, from its lanes' objectives."""
    return {"median_lane_excess": median(lane_excesses(costs, targets)),
            "lane_shortfall": max(lane_shortfalls(costs, targets))}


def median(values) -> float:
    """The median (the mean of the middle two of an even count)."""
    return float(np.median(np.asarray(values, dtype=np.float64)))


def judge(answers, graphs, config: dict, traffic: dict, limits: dict,
          device, targets=None) -> Verdict:
    """Judge every answer; ``targets`` when already computed."""
    st = settings(config, traffic)
    if targets is None:
        targets = reference_targets(graphs, st, device)
    worst = {name: -math.inf for name in limits}
    failed = 0
    for answer, count in distinct(answers):
        got = numbers(lane_costs(answer, graphs, st), targets)
        ok = True
        for name, limit in limits.items():
            worst[name] = max(worst[name], got[name])
            ok = ok and got[name] <= limit
        failed += 0 if ok else count
    return Verdict(correct=failed == 0 and bool(answers), failed=failed,
                   numbers={name: {"value": worst[name], "limit": limit}
                            for name, limit in limits.items()})
