"""Levenberg-Marquardt trust-region loop.

Port of ``slam_tpu/solver/lm.py``.  The JAX ``while_loop``/``scan`` become
Python loops over device tensors: the state stays on the device, and
:func:`lm_solve` reads one flag per iteration (``converged``) on the host.
Damping is Marquardt-scaled with the Nielsen update; ``lm_fixed_iters``
also carries the opt-in stock-Ceres bookkeeping (``trust_region="ceres"``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.config import SolverConfig
from slam_tpu_torch.runtime import require_type
from slam_tpu_torch.solver import linear
from slam_tpu_torch.solver.linearize import cost_only, linearize
from slam_tpu_torch.solver.models import model_for_dim
from slam_tpu_torch.solver.problem import EdgeSet, FreeMask

Tensor = torch.Tensor


class LMState(NamedTuple):
    poses: Tensor     # (N, 3) or (N, 7)
    switches: Tensor  # (E,)
    cost: Tensor      # scalar current cost
    lam: Tensor       # LM damping
    nu: Tensor        # rejection growth factor
    it: int           # iterations executed
    accepted: Tensor  # accepted steps (int64 scalar)
    converged: Tensor  # bool scalar
    lin_iters: int    # cumulative inner iterations (0 for direct solvers)


class LMResult(NamedTuple):
    poses: Tensor
    switches: Tensor
    cost: Tensor
    initial_cost: Tensor
    iterations: int
    accepted: Tensor
    converged: Tensor
    lin_iters: int
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
    (pose-only, or the joint one for ``robust="sc"``), built when not
    given; nothing for PCG."""
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
        return None
    if cfg.linear_solver == "woodbury":
        if partition is None:
            raise ValueError("linear_solver='woodbury' requires WoodburyOps "
                             "(pass as partition)")
        return partition
    raise ValueError(f"unknown linear solver {cfg.linear_solver!r}")


def _solve_linear(system, edges, lam, cfg: SolverConfig,
                  plan) -> tuple[linear.Update, int]:
    """The step and its inner (CG) iterations, 0 for the direct solvers.
    Joint SC on the Schur and Woodbury solvers eliminates the switches
    first and recovers them by substitution."""
    if cfg.linear_solver == "dense":
        return linear.dense_solve(system, edges, lam, plan), 0
    if cfg.linear_solver == "pcg":
        return linear.pcg_solve(system, edges, lam,
                                max_iters=cfg.pcg_max_iters,
                                rtol=cfg.pcg_rtol,
                                preconditioner=cfg.pcg_preconditioner)
    from slam_tpu_torch.solver import schur, woodbury

    backsub = None
    if cfg.robust == "sc":
        # As in the JAX package, schur_solve assembles from the Jacobians
        # and reads only the diagonal of the reduced Hdiag (its damping and
        # scale): the elimination's couplings do not reach the step
        # (ROADMAP C, reference-side fault 8).  woodbury_solve keeps the
        # chain edges' couplings and the reduced diagonal, as there.
        system, backsub = linear.eliminate_switches(system, edges, lam)
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


def _propose(s: LMState, edges, free, cfg, model, plan, kw, gnc):
    """One linearise-solve-retract step from ``s``: returns the candidate,
    the model's predicted reduction and the solve's inner iterations."""
    kw_t = dict(kw, dcs_phi=_gnc_phi(cfg, s.it))
    system = linearize(s.poses, s.switches, edges, free, **kw_t)
    # Under GNC the objective changes each iteration; compare at the
    # current phi (system.cost is the objective at s.poses and phi_t).
    prev_cost = system.cost if gnc else s.cost
    dx, inner = _solve_linear(system, edges, s.lam, cfg, plan)
    new_poses = model.retract(s.poses, dx.poses)
    new_switches = s.switches + dx.switches
    new_cost = cost_only(new_poses, new_switches, edges, **kw_t)
    d = torch.diagonal(system.Hdiag, dim1=-2, dim2=-1)
    damp = s.lam * torch.clamp(d, linear._DIAG_MIN, linear._DIAG_MAX)
    ds = s.lam * torch.clamp(system.Hss, linear._DIAG_MIN, linear._DIAG_MAX)
    model_red = 0.5 * (
        torch.sum(dx.poses * (damp * dx.poses - system.g))
        + torch.sum(dx.switches * (ds * dx.switches - system.gs)))
    return new_poses, new_switches, new_cost, prev_cost, model_red, inner


def _scalar(v, **kw) -> Tensor:
    """A 0-d tensor of ``v``: a number is filled in on the device (no
    host-to-device copy, which would synchronise), a tensor converted."""
    if isinstance(v, Tensor):
        return v.to(**kw)
    return torch.full((), v, **kw)


def _init_state(poses0, switches0, cost0, cfg, lam0=None, nu0=None,
                it0=None) -> LMState:
    kw = dict(dtype=poses0.dtype, device=poses0.device)
    return LMState(
        poses=poses0, switches=switches0, cost=cost0,
        lam=_scalar(cfg.init_lambda if lam0 is None else lam0, **kw),
        nu=_scalar(2.0 if nu0 is None else nu0, **kw),
        it=0 if it0 is None else int(it0),
        accepted=torch.zeros((), dtype=torch.int64, device=poses0.device),
        converged=torch.zeros((), dtype=torch.bool, device=poses0.device),
        lin_iters=0,
    )


def _result(s: LMState, cost0: Tensor) -> LMResult:
    return LMResult(poses=s.poses, switches=s.switches, cost=s.cost,
                    initial_cost=cost0, iterations=s.it, accepted=s.accepted,
                    converged=s.converged, lin_iters=s.lin_iters,
                    final_lambda=s.lam, final_nu=s.nu)


def _cast(poses0, switches0, cfg):
    dtype = getattr(torch, cfg.dtype)
    return poses0.to(dtype), switches0.to(dtype)


def lm_solve(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
             free: FreeMask, cfg: SolverConfig, model=None,
             partition=None) -> LMResult:
    """Run LM to convergence (or ``cfg.max_iterations``).  ``model=None``
    takes the model of the poses' width (SE(2) or SE(3))."""
    require_type(cfg, SolverConfig, "cfg")
    model = model or model_for_dim(poses0.shape[-1])
    poses0, switches0 = _cast(poses0, switches0, cfg)
    kw = _cost_kw(cfg, model)
    plan = linear_plan(cfg, edges, partition)
    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"
    cost0 = cost_only(poses0, switches0, edges, **kw)
    s = _init_state(poses0, switches0, cost0, cfg)
    while s.it < cfg.max_iterations:
        new_poses, new_switches, new_cost, prev_cost, model_red, inner = \
            _propose(s, edges, free, cfg, model, plan, kw, gnc)
        rho = (prev_cost - new_cost) / torch.clamp(model_red, min=1e-30)
        accept = new_cost < prev_cost
        factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_acc = torch.clamp(s.lam * factor, cfg.min_lambda, cfg.max_lambda)
        lam_rej = torch.clamp(s.lam * s.nu, cfg.min_lambda, cfg.max_lambda)
        rel_decrease = (prev_cost - new_cost) / torch.clamp(prev_cost,
                                                            min=1e-30)
        converged = accept & (rel_decrease < cfg.function_tolerance)
        if gnc:  # no convergence while phi is still annealing
            converged = converged & (s.it >= cfg.gnc_anneal_iters)
        s = LMState(
            poses=torch.where(accept, new_poses, s.poses),
            switches=torch.where(accept, new_switches, s.switches),
            cost=torch.where(accept, new_cost, prev_cost),
            lam=torch.where(accept, lam_acc, lam_rej),
            nu=torch.where(accept, torch.full_like(s.nu, 2.0), s.nu * 2.0),
            it=s.it + 1,
            accepted=s.accepted + accept.to(torch.int64),
            converged=converged,
            lin_iters=s.lin_iters + inner,
        )
        if bool(converged.item()):
            break
    return _result(s, cost0)


def lm_fixed_iters(poses0: Tensor, switches0: Tensor, edges: EdgeSet,
                   free: FreeMask, cfg: SolverConfig, num_iters: int,
                   model=None, partition=None, lam0=None, it0=None,
                   nu0=None) -> LMResult:
    """Exactly ``num_iters`` LM iterations, no host sync inside.
    ``lam0``/``nu0``/``it0`` continue from a previous result;
    ``model=None`` takes the model of the poses' width."""
    require_type(cfg, SolverConfig, "cfg")
    model = model or model_for_dim(poses0.shape[-1])
    poses0, switches0 = _cast(poses0, switches0, cfg)
    kw = _cost_kw(cfg, model)
    plan = linear_plan(cfg, edges, partition)
    gnc = bool(cfg.gnc_anneal_iters) and cfg.robust == "dcs"
    ceres = cfg.trust_region == "ceres"
    cost0 = cost_only(poses0, switches0, edges, **kw)
    s = _init_state(poses0, switches0, cost0, cfg, lam0, nu0, it0)
    for _ in range(num_iters):
        new_poses, new_switches, new_cost, prev_cost, model_red, inner = \
            _propose(s, edges, free, cfg, model, plan, kw, gnc)
        lam_rej = torch.clamp(s.lam * s.nu, max=cfg.max_lambda)
        if ceres:
            # Stock-Ceres acceptance and accepted-radius update (see the
            # JAX package for why only these two differ).
            rho = (prev_cost - new_cost) / torch.clamp(model_red, min=1e-30)
            accept = (model_red > 0.0) & (rho > 1e-3)
            factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_acc = torch.clamp(s.lam * factor, cfg.min_lambda,
                                  cfg.max_lambda)
        else:
            accept = new_cost < prev_cost
            lam_acc = torch.clamp(s.lam / 3.0, min=cfg.min_lambda)
        s = LMState(
            poses=torch.where(accept, new_poses, s.poses),
            switches=torch.where(accept, new_switches, s.switches),
            cost=torch.where(accept, new_cost, prev_cost),
            lam=torch.where(accept, lam_acc, lam_rej),
            nu=torch.where(accept, torch.full_like(s.nu, 2.0), s.nu * 2.0),
            it=s.it + 1,
            accepted=s.accepted + accept.to(torch.int64),
            converged=s.converged,
            lin_iters=s.lin_iters + inner,
        )
    return _result(s, cost0)
