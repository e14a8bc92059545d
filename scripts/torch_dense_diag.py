"""Where the float32 dense joint solve parts between the card and the CPU.

    python scripts/torch_dense_diag.py [--at 0,10,25,49] [--dump DIR]

INTEL with 50 bogus loops (seed 42), joint switchable constraints on the
dense joint system (5220 unknowns), float32 on the CUDA device: the run
of ``lm_fixed_iters`` is taken to each iterate of ``--at``, and there the
damped matrix H and right-hand side of that iteration's dense solve
(what ``solver.linear.dense_solve`` hands ``_finish_dense``) are taken
once and solved step by step
as ``solver.linear._finish_dense`` solves them -- Jacobi scaling,
``cholesky_ex``, ``cholesky_solve``, unscaling -- on the card in
float32, on the CPU in float32 (the same H copied), and in float64 (H
cast up, on the CPU and on the card).  Each step is compared between the
card and the CPU, and each float32 result against float64; a cross solve
(the card's factor solved on the CPU) separates the factor from the
triangular solves, and the card factors again under each of its linear
algebra libraries (``torch.backends.cuda.preferred_linalg_library``).
Residuals are ``|Hs y - b| / |b|`` in float64.  Prints one JSON line per
iterate; ``--dump`` saves each H and right-hand side (``.pt``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def steps(H, rhs) -> dict:
    """``_finish_dense``'s steps, each kept."""
    d = torch.diagonal(H)
    dscale = 1.0 / torch.sqrt(torch.clamp(d, min=1e-12))
    Hs = H * dscale[:, None] * dscale[None, :]
    L, info = torch.linalg.cholesky_ex(Hs)
    b = rhs * dscale
    y = torch.cholesky_solve(b[:, None], L)[:, 0]
    return dict(dscale=dscale, Hs=Hs, L=L, info=int(info), b=b, y=y,
                sol=y * dscale)


def rel(a, b) -> float:
    """``max |a - b| / max |b|`` in float64 on the CPU."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def resid(Hs64, y, b64) -> float:
    y = y.double().cpu()
    return float(torch.linalg.norm(Hs64 @ y - b64) / torch.linalg.norm(b64))


def system_at(prob, k: int):
    """H and the right-hand side of iteration ``k``'s dense solve."""
    from slam_tpu_torch.solver import linear
    from slam_tpu_torch.solver.linearize import linearize
    from slam_tpu_torch.solver.lm import lm_fixed_iters
    from slam_tpu_torch.solver.models import SE2Model

    cfg = prob.scfg
    poses, sw, lam = prob.poses0, prob.switches0, torch.full(
        (), cfg.init_lambda, dtype=prob.poses0.dtype,
        device=prob.poses0.device)
    if k:
        res = lm_fixed_iters(poses, sw, prob.edges, prob.free, cfg, k,
                             partition=prob.partition)
        poses, sw, lam = res.poses, res.switches, res.final_lambda
    system = linearize(poses, sw, prob.edges, prob.free, model=SE2Model,
                       robust=cfg.robust, dcs_phi=cfg.dcs_phi,
                       huber_delta=cfg.huber_delta,
                       sc_prior_lambda=cfg.sc_prior_lambda)
    taken = []
    finish = linear._finish_dense

    def record(H, rhs, *rest):
        taken.append((H, rhs))
        return finish(H, rhs, *rest)

    linear._finish_dense = record
    try:
        linear.dense_solve(system, prob.edges, lam, prob.partition)
    finally:
        linear._finish_dense = finish
    return taken[0]


def diagnose(H, rhs) -> dict:
    card = steps(H, rhs)
    cpu = steps(H.cpu(), rhs.cpu())
    f64 = steps(H.double().cpu(), rhs.double().cpu())
    f64_card = steps(H.double(), rhs.double())
    Hs64, b64 = f64["Hs"], f64["b"]
    cross = torch.cholesky_solve(card["b"].cpu()[:, None],
                                 card["L"].cpu())[:, 0]
    ev = torch.linalg.eigvalsh(f64_card["Hs"])
    out = dict(
        unknowns=H.shape[0], info_card=card["info"], info_cpu=cpu["info"],
        cond_Hs=float(ev[-1] / ev[0]),
        card_vs_cpu={k: rel(card[k], cpu[k])
                     for k in ("dscale", "Hs", "L", "y", "sol")},
        vs_f64={side: {k: rel(s[k], f64[k]) for k in ("L", "y", "sol")}
                for side, s in (("card_f32", card), ("cpu_f32", cpu),
                                ("card_f64", f64_card))},
        residual={"card_f32": resid(Hs64, card["y"], b64),
                  "cpu_f32": resid(Hs64, cpu["y"], b64),
                  "card_factor_cpu_solve": resid(Hs64, cross, b64),
                  "f64": resid(Hs64, f64["y"], b64)},
        # The factor's own backward error |L L^T - Hs| / |Hs|.
        factor_error={side: rel(s["L"].double().cpu()
                                @ s["L"].double().cpu().T, Hs64)
                      for side, s in (("card_f32", card), ("cpu_f32", cpu))},
    )
    libs = {}
    default = torch.backends.cuda.preferred_linalg_library()
    for lib in ("cusolver", "magma"):
        try:
            torch.backends.cuda.preferred_linalg_library(lib)
            s = steps(H, rhs)
            libs[lib] = dict(residual=resid(Hs64, s["y"], b64),
                             L_vs_card_default=rel(s["L"], card["L"]),
                             sol_vs_f64=rel(s["sol"], f64["sol"]))
        except RuntimeError as e:  # a library the build lacks
            libs[lib] = f"unavailable: {str(e)[:120]}"
        finally:
            torch.backends.cuda.preferred_linalg_library(default)
    out["libraries"] = libs
    out["default_library"] = str(default)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--at", default="0,10,25,49",
                    help="LM iterates to take the system at")
    ap.add_argument("--dump", default=None, metavar="DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_diag: no CUDA device", file=sys.stderr)
        return 1
    from slam_tpu_torch import runtime
    from slam_tpu_torch.tools.kernel_times import nvidia_smi
    from slam_tpu_torch.tools.problems import intel50_plain

    device = runtime.setup_device("cuda")
    prob = intel50_plain(device, "float32", "sc", "dense")
    for k in (int(x) for x in args.at.split(",")):
        H, rhs = system_at(prob, k)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            torch.save({"H": H.cpu(), "rhs": rhs.cpu()},
                       os.path.join(args.dump, f"dense_joint_it{k}.pt"))
        print(json.dumps({"iterate": k, **diagnose(H, rhs),
                          "card": nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
