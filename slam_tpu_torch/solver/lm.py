"""Levenberg-Marquardt trust-region loop.

Port of ``slam_tpu/solver/lm.py``.  The JAX ``while_loop``/``scan`` become
Python loops over device tensors: the state stays on the device, and
:func:`lm_solve` reads one flag per iteration (``converged``) on the host.
Damping is Marquardt-scaled with the Nielsen update; ``lm_fixed_iters``
also carries the opt-in stock-Ceres bookkeeping (``trust_region="ceres"``).

On a seed batch's plan (the ``seeds`` of a ``SchurPartition``,
``linear.DenseBatchPlan``, ``linear.JointPlan``, ``linear.PCGPlan`` or
``WoodburyOps``, ``solver/batch.py``) both loops run B
problems as one flat problem of B*N nodes and B*E edges, as ``jax.vmap``
runs the JAX loops: cost, lambda, nu and acceptance are ``(B,)``, each
seed's repeated over its own rows, and every sum is each seed's; so are
the inner (CG) iterations, ``lin_iters``.
``lm_solve`` then stops each seed at its own convergence, as a vmapped
``while_loop`` does: the step runs on every seed, and only the seeds still
running take it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver.linearize import _total, cost_only, linearize
from slam_tpu_torch.solver.models import model_for_dim
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


class LMState(NamedTuple):
    poses: Tensor     # (N, 3) or (N, 7)
    switches: Tensor  # (E,)
    cost: Tensor      # scalar current cost ((B,) in a seed batch, as below)
    lam: Tensor       # LM damping
    nu: Tensor        # rejection growth factor
    it: int           # iterations executed
    accepted: Tensor  # accepted steps (int64 scalar)
    converged: Tensor  # bool scalar
    lin_iters: Tensor  # cumulative inner iterations (0 for direct solvers)


class LMResult(NamedTuple):
    poses: Tensor
    switches: Tensor
    cost: Tensor
    initial_cost: Tensor
    iterations: int
    accepted: Tensor
    converged: Tensor
    lin_iters: Tensor
    final_lambda: Tensor | None = None
    final_nu: Tensor | None = None


def _gnc_phi(cfg: SolverConfig, it: int) -> float:
    """Annealed DCS phi at iteration ``it``: ``phi * scale^(1 - min(it,K)/K)``
    (the plain phi when GNC is off)."""
    K = cfg.gnc_anneal_iters
    if not K or cfg.robust != "dcs":
        return cfg.dcs_phi
    frac = min(it / K, 1.0)
    return cfg.dcs_phi * cfg.gnc_init_scale ** (1.0 - frac)


def linear_plan(cfg: SolverConfig, edges: EdgeSet, partition=None):
    """What the configured linear solver needs besides the system: the
    Schur partition or the Woodbury operators; the dense assembly plan
    (pose-only, or the joint one for ``robust="sc"``; a batch's too),
    built when not given; for PCG its :class:`linear.PCGPlan` (one
    problem's when not given)."""
    if cfg.linear_solver == "dense":
        joint = cfg.robust == "sc"
        if partition is None:
            return linear.dense_plan(edges, switches=joint)
        if isinstance(partition, linear.JointPlan) != joint:
            raise ValueError("the dense plan does not match robust="
                             f"{cfg.robust!r} (see linear.dense_plan)")
        return partition
    if cfg.linear_solver == "schur":
        if partition is None:
            raise ValueError("linear_solver='schur' requires a partition")
        return partition
    if cfg.linear_solver == "pcg":
        return (partition if isinstance(partition, linear.PCGPlan)
                else linear.PCGPlan())
    if cfg.linear_solver == "woodbury":
        if partition is None:
            raise ValueError("linear_solver='woodbury' requires WoodburyOps "
                             "(pass as partition)")
        return partition
    raise ValueError(f"unknown linear solver {cfg.linear_solver!r}")


def _solve_linear(system, edges, lam, cfg: SolverConfig,
                  plan) -> tuple[linear.Update, Tensor | int]:
    """The step and its inner (CG) iterations, 0 for the direct solvers.
    Joint SC on the Schur and Woodbury solvers eliminates the switches
    first and recovers them by substitution."""
    if cfg.linear_solver == "dense":
        return linear.dense_solve(system, edges, lam, plan), 0
    if cfg.linear_solver == "pcg":
        return linear.pcg_solve(system, edges, lam,
                                max_iters=cfg.pcg_max_iters,
                                rtol=cfg.pcg_rtol,
                                preconditioner=cfg.pcg_preconditioner,
                                seeds=plan.seeds)
    from slam_tpu_torch.solver import schur, woodbury

    backsub = None
    if cfg.robust == "sc":
        # As in the JAX package, schur_solve assembles from the Jacobians
        # and reads only the diagonal of the reduced Hdiag (its damping and
        # scale): the elimination's couplings do not reach the step
        # (ROADMAP C, reference-side fault 8).  woodbury_solve keeps the
        # chain edges' couplings and the reduced diagonal, as there.
        system, backsub = linear.eliminate_switches(
            system, edges, lam, getattr(plan, "seeds", None))
    if cfg.linear_solver == "woodbury":
        dx = woodbury.woodbury_solve(system, edges, plan, lam)
    else:
        dx = schur.schur_solve(system, edges, plan, lam,
                               blocked=cfg.schur_blocked,
                               panel=cfg.schur_panel,
                               panel_inner=cfg.schur_panel_inner,
                               pallas_micro=cfg.schur_pallas_micro)
    if backsub is not None:
        dx = dx._replace(switches=backsub(dx.poses))
    return dx, 0


def _cost_kw(cfg: SolverConfig, model) -> dict:
    return dict(model=model, robust=cfg.robust, dcs_phi=cfg.dcs_phi,
                huber_delta=cfg.huber_delta,
                sc_prior_lambda=cfg.sc_prior_lambda)


def _propose(s: LMState, edges, free, cfg, model, plan, kw, gnc,
             seeds: int | None = None):
    """One linearise-solve-retract step from ``s``: returns the candidate,
    the model's predicted reduction and the solve's inner iterations
    (each seed's reduction and iterations in a batch of ``seeds``)."""
    kw_t = dict(kw, dcs_phi=_gnc_phi(cfg, s.it))
    with span("lm.linearize"):
        system = linearize(s.poses, s.switches, edges, free, **kw_t)
    # Under GNC the objective changes each iteration; compare at the
    # current phi (system.cost is the objective at s.poses and phi_t).
    prev_cost = system.cost if gnc else s.cost
    lam_x = linear.lane_rows(s.lam, s.poses, seeds)
    with span("lm.linear_solve"):
        dx, inner = _solve_linear(system, edges, lam_x, cfg, plan)
    with span("lm.retract_cost"):
        new_poses = model.retract(s.poses, dx.poses)
        new_switches = s.switches + dx.switches
        new_cost = cost_only(new_poses, new_switches, edges, **kw_t)
        d = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)
        damp = lam_x * torch.clamp(d, linear._DIAG_MIN, linear._DIAG_MAX)
        ds = linear.lane_rows(s.lam, s.switches, seeds) * torch.clamp(
            system.Hss, linear._DIAG_MIN, linear._DIAG_MAX)
        model_red = 0.5 * (
            _total(dx.poses * (damp * dx.poses - system.g), seeds)
            + _total(dx.switches * (ds * dx.switches - system.gs), seeds))
    return new_poses, new_switches, new_cost, prev_cost, model_red, inner


def _scalar(v, shape=(), **kw) -> Tensor:
    """A 0-d tensor of ``v`` (or one entry per seed, ``shape=(B,)``): a
    number is filled in on the device (no host-to-device copy, which would
    synchronise), a tensor converted."""
    if isinstance(v, Tensor):
        v = v.to(**kw)
        return v.expand(shape).clone() if shape else v
    return torch.full(shape, v, **kw)


def _init_state(poses0, switches0, cost0, cfg, lam0=None, nu0=None,
                it0=None) -> LMState:
    """The start; its per-problem entries take ``cost0``'s shape."""
    kw = dict(dtype=poses0.dtype, device=poses0.device)
    shape = cost0.shape
    return LMState(
        poses=poses0, switches=switches0, cost=cost0,
        lam=_scalar(cfg.init_lambda if lam0 is None else lam0, shape, **kw),
        nu=_scalar(2.0 if nu0 is None else nu0, shape, **kw),
        it=0 if it0 is None else int(it0),
        accepted=torch.zeros(shape, dtype=torch.int64, device=poses0.device),
        converged=torch.zeros(shape, dtype=torch.bool,
                              device=poses0.device),
        lin_iters=torch.zeros(shape, dtype=torch.int64,
                              device=poses0.device),
    )


def _result(s: LMState, cost0: Tensor) -> LMResult:
    return LMResult(poses=s.poses, switches=s.switches, cost=s.cost,
                    initial_cost=cost0, iterations=s.it, accepted=s.accepted,
                    converged=s.converged, lin_iters=s.lin_iters,
                    final_lambda=s.lam, final_nu=s.nu)


def _cast(poses0, switches0, cfg):
    dtype = getattr(torch, cfg.dtype)
    return poses0.to(dtype), switches0.to(dtype)


def _step(s: LMState, accept: Tensor, new_poses: Tensor,
          new_switches: Tensor, new_cost: Tensor, prev_cost: Tensor,
          lam_acc: Tensor, lam_rej: Tensor, converged: Tensor, inner,
          seeds: int | None) -> LMState:
    """The state after an iteration from ``s``: the candidate where
    ``accept`` holds (each seed's), and the damping it chose."""
    return LMState(
        poses=torch.where(linear.lane_rows(accept, new_poses, seeds),
                          new_poses, s.poses),
        switches=torch.where(linear.lane_rows(accept, new_switches, seeds),
                             new_switches, s.switches),
        cost=torch.where(accept, new_cost, prev_cost),
        lam=torch.where(accept, lam_acc, lam_rej),
        nu=torch.where(accept, torch.full_like(s.nu, 2.0), s.nu * 2.0),
        it=s.it + 1,
        accepted=s.accepted + accept.to(torch.int64),
        converged=converged,
        lin_iters=s.lin_iters + inner,
    )


def _take(run: Tensor, new: LMState, old: LMState, seeds: int) -> LMState:
    """``new`` in the seeds where ``run`` holds, ``old`` elsewhere (a
    vmapped ``while_loop``'s select); the counters are the loop's."""
    def pick(a, b):
        return torch.where(linear.lane_rows(run, a, seeds), a, b)

    return new._replace(
        poses=pick(new.poses, old.poses),
        switches=pick(new.switches, old.switches),
        **{f: torch.where(run, getattr(new, f), getattr(old, f))
           for f in ("cost", "lam", "nu", "accepted", "converged",
                     "lin_iters")})


def lm_solve(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
             free: FreeMask, cfg: SolverConfig, model=None,
             partition=None) -> LMResult:
    """Run LM to convergence (or ``cfg.max_iterations``).  ``model=None``
    takes the model of the poses' width (SE(2) or SE(3)).  On a seed
    batch's plan (see the module docstring; ``batch.lm_solve_batch`` takes
    the poses stacked) each seed stops at its own convergence, the loop
    ends when none is running, and ``iterations`` is ``(B,)``, each
    seed's."""
    with span("lm.solve"):
        return _lm_solve(poses0, switches0, edges, free, cfg, model,
                         partition)


def _lm_solve(poses0, switches0, edges, free, cfg, model,
              partition) -> LMResult:
    require_type(cfg, SolverConfig, "cfg")
    model = model or model_for_dim(poses0.shape[-1])
    poses0, switches0 = _cast(poses0, switches0, cfg)
    plan = linear_plan(cfg, edges, partition)
    seeds = getattr(plan, "seeds", None)
    kw = dict(_cost_kw(cfg, model), seeds=seeds)
    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"
    cost0 = cost_only(poses0, switches0, edges, **kw)
    s = _init_state(poses0, switches0, cost0, cfg)
    if seeds is not None:
        # Every running seed shares the loop's counter (GNC's phi follows
        # it); each seed's iterations are its own.
        lane_it = torch.zeros((seeds,), dtype=torch.int64,
                              device=poses0.device)
    while s.it < cfg.max_iterations:
        with span("lm.iteration"):
            new_poses, new_switches, new_cost, prev_cost, model_red, inner \
                = _propose(s, edges, free, cfg, model, plan, kw, gnc, seeds)
            rho = (prev_cost - new_cost) / torch.clamp(model_red, min=1e-30)
            accept = new_cost < prev_cost
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                 min=1.0 / 3.0)
            lam_acc = torch.clamp(s.lam * factor, cfg.min_lambda,
                                  cfg.max_lambda)
            lam_rej = torch.clamp(s.lam * s.nu, cfg.min_lambda,
                                  cfg.max_lambda)
            rel_decrease = (prev_cost - new_cost) / torch.clamp(
                prev_cost, min=1e-30)
            converged = accept & (rel_decrease < cfg.function_tolerance)
            if gnc:  # no convergence while phi is still annealing
                converged = converged & (s.it >= cfg.gnc_anneal_iters)
            step = _step(s, accept, new_poses, new_switches, new_cost,
                         prev_cost, lam_acc, lam_rej, converged, inner,
                         seeds)
            if seeds is None:
                s = step
                done = converged
            else:
                run = ~s.converged
                s = _take(run, step, s, seeds)
                lane_it = lane_it + run.to(torch.int64)
                done = s.converged.all()
            if bool(done.item()):
                break
    res = _result(s, cost0)
    return res if seeds is None else res._replace(iterations=lane_it)


def lm_fixed_iters(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
                   free: FreeMask, cfg: SolverConfig, num_iters: int,
                   model=None, partition=None, lam0=None, it0=None,
                   nu0=None) -> LMResult:
    """Exactly ``num_iters`` LM iterations, no host sync inside (on PCG
    but its CG stopping flag, ``linear.CHECK_EVERY``).
    ``lam0``/``nu0``/``it0`` continue from a previous result;
    ``model=None`` takes the model of the poses' width.  On a seed batch's
    partition the flat poses and switches are B seeds' (see the module
    docstring; ``batch.lm_fixed_iters_batch`` takes them stacked)."""
    with span("lm.solve"):
        return _lm_fixed_iters(poses0, switches0, edges, free, cfg,
                               num_iters, model, partition, lam0, it0, nu0)


def _lm_fixed_iters(poses0, switches0, edges, free, cfg, num_iters, model,
                    partition, lam0, it0, nu0) -> LMResult:
    require_type(cfg, SolverConfig, "cfg")
    model = model or model_for_dim(poses0.shape[-1])
    poses0, switches0 = _cast(poses0, switches0, cfg)
    plan = linear_plan(cfg, edges, partition)
    seeds = getattr(plan, "seeds", None)
    kw = dict(_cost_kw(cfg, model), seeds=seeds)
    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"
    ceres = cfg.trust_region == "ceres"
    cost0 = cost_only(poses0, switches0, edges, **kw)
    s = _init_state(poses0, switches0, cost0, cfg, lam0, nu0, it0)
    for _ in range(num_iters):
        with span("lm.iteration"):
            new_poses, new_switches, new_cost, prev_cost, model_red, inner \
                = _propose(s, edges, free, cfg, model, plan, kw, gnc, seeds)
            lam_rej = torch.clamp(s.lam * s.nu, max=cfg.max_lambda)
            if ceres:
                # Stock-Ceres acceptance and accepted-radius update (see
                # the JAX package for why only these two differ).
                rho = (prev_cost - new_cost) / torch.clamp(model_red,
                                                           min=1e-30)
                accept = (model_red > 0.0) & (rho > 1e-3)
                factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                     min=1.0 / 3.0)
                lam_acc = torch.clamp(s.lam * factor, cfg.min_lambda,
                                      cfg.max_lambda)
            else:
                accept = new_cost < prev_cost
                lam_acc = torch.clamp(s.lam / 3.0, min=cfg.min_lambda)
            s = _step(s, accept, new_poses, new_switches, new_cost,
                      prev_cost, lam_acc, lam_rej, s.converged, inner, seeds)
    return _result(s, cost0)
