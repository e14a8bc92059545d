"""Spread of the float32 cost of a solve against float64.

    python -m slam_tpu_torch.tools.f32_spread [--device cuda|cpu]
        [--perturb 4] [--robust dcs|sc|sc_varpro]
        [--linear-solver schur|dense|pcg] [--cli]
        [--problem intel|sphere2500]

Runs on the CUDA device unless ``--device cpu`` is given.

The problem is one of ``chip_smoke.py``'s checks: INTEL with 50 bogus
loops (seed 42), auto init, edges padded to a multiple of 256, the auto
Schur partition (or the dense plan, or none for PCG), under ``--robust``:
plain DCS (no rescue), joint switchable constraints or their variable
projection; ``lm_fixed_iters`` for as many iterations as its reference
has, or with ``--cli`` the command-line run's ``lm_solve`` (method 2).
``--problem sphere2500`` takes the sphere2500 SE(3) recipe instead (plain
DCS, Schur with 4 index blocks, 30 ``lm_fixed_iters``;
``tools/problems.py``), each factorisation against its own reference;
there the float64 runs take the perturbed copies too, so that the spread
of float64 under the same input noise tells how much of the float32
spread is the trajectory's own sensitivity.
For each factorisation of the Schur solver -- native, blocked (panel 128)
with the plain panel factor, blocked with ``micro_chol_inv`` -- or the one
dense or PCG solve, it runs float32 from the initial poses and from
``--perturb`` copies whose poses are multiplied by ``1 + 1e-7 N(0, 1)`` in
float64 before the cast (about one float32 ulp), and one unperturbed
float64 run.  It prints each final cost's relative difference from the
float64 JAX reference in ``slam_tpu_torch/data/reference_costs.json``,
then one JSON line.  The spread of the float32 differences is what a
float32 cost gate has to allow for; it is f32 trajectory noise of a
nonconvex problem, not the error of one solve.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from slam_tpu_torch.tools.problems import CONFIGS, PROBLEMS, ROBUST, \
    SOLVERS, SPHERE_ITERS, intel50, intel50_plain, reference_key, \
    sphere2500, sphere_reference_key

REF = pathlib.Path(__file__).resolve().parents[1] / "data" / \
    "reference_costs.json"


def final_cost(args, cfg, partition, iters: int | None) -> float:
    """The final cost from ``args`` (poses, switches, edges, free) of
    ``iters`` ``lm_fixed_iters`` iterations, or of ``lm_solve`` when
    ``iters`` is None."""
    from slam_tpu_torch.solver.lm import lm_fixed_iters, lm_solve

    if iters is None:
        res = lm_solve(*args, cfg, partition=partition)
    else:
        res = lm_fixed_iters(*args, cfg, iters, partition=partition)
    return float(res.cost)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--perturb", type=int, default=4)
    ap.add_argument("--robust", default="dcs", choices=ROBUST)
    ap.add_argument("--linear-solver", default="schur", choices=SOLVERS)
    ap.add_argument("--cli", action="store_true",
                    help="the method-2 command-line run (lm_solve)")
    ap.add_argument("--problem", default="intel", choices=PROBLEMS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("f32_spread: no CUDA device (pass --device cpu for the CPU)",
              file=sys.stderr)
        return 1
    if args.cli and (args.robust == "dcs" or args.linear_solver != "schur"):
        raise ValueError("--cli is the method-2 run on the Schur solver")
    if args.problem == "sphere2500":
        if args.cli or args.robust != "dcs" or args.linear_solver != "schur":
            raise ValueError("sphere2500 is the plain-DCS Schur recipe")
        return sphere_spread(args)
    key = reference_key(args.robust, args.linear_solver, args.cli)
    ref = json.loads(REF.read_text())[key]
    iters = None if args.cli else ref["iterations"]
    ref_cost = ref["final_cost"]
    out = {"device": args.device, "reference": key,
           "reference_f64": ref_cost, "iters": ref["iterations"],
           "lm": "lm_solve" if args.cli else "lm_fixed_iters",
           "perturb": args.perturb}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    configs = CONFIGS if args.linear_solver == "schur" else {
        args.linear_solver: {}}
    t0 = time.perf_counter()
    for dtype_name in ("float32", "float64"):
        prob = (intel50(args.device, dtype_name, method=2,
                        robust=args.robust) if args.cli else
                intel50_plain(args.device, dtype_name, args.robust,
                              args.linear_solver))
        base = prob.canon.poses
        for name, kw in configs.items():
            scfg = prob.scfg.replace(**kw)
            runs = [base] if dtype_name == "float64" else [base] + [
                base * (1.0 + 1e-7 * np.random.default_rng(s).normal(
                    size=base.shape)) for s in range(args.perturb)]
            rels = []
            for poses in runs:
                p0 = torch.as_tensor(poses, dtype=prob.poses0.dtype,
                                     device=prob.poses0.device)
                cost = final_cost((p0, prob.switches0, prob.edges,
                                   prob.free), scfg, prob.partition, iters)
                rels.append((cost - ref_cost) / ref_cost)
            label = f"{name}_{dtype_name}"
            out[label] = rels
            print(f"[spread] {label} rel_to_f64_ref={rels} "
                  f"max_abs={max(abs(r) for r in rels):.3e} "
                  f"t={time.perf_counter() - t0:.1f}s", flush=True)
    f32 = [abs(r) for k, v in out.items() if k.endswith("_float32")
           for r in v]
    out["max_abs_rel_float32"] = max(f32)
    print(json.dumps(out))
    return 0


def sphere_spread(args) -> int:
    """The sphere2500 recipe's spread, each factorisation against its own
    float64 reference."""
    refs = json.loads(REF.read_text())
    out = {"device": args.device, "problem": "sphere2500",
           "iters": SPHERE_ITERS, "lm": "lm_fixed_iters",
           "perturb": args.perturb}
    if args.device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        case = sphere2500(args.device, dtype)
        base = case.graph.poses
        for name, kw in CONFIGS.items():
            ref_cost = refs[sphere_reference_key(name)]["final_cost"]
            cfg = case.cfg.replace(**kw)
            runs = [base] + [
                base * (1.0 + 1e-7 * np.random.default_rng(s).normal(
                    size=base.shape)) for s in range(args.perturb)]
            rels = []
            for poses in runs:
                p0 = torch.as_tensor(poses, dtype=dtype, device=args.device)
                cost = final_cost((p0, *case.args[1:]), cfg,
                                  case.partition, SPHERE_ITERS)
                rels.append((cost - ref_cost) / ref_cost)
            label = f"{name}_{str(dtype).replace('torch.', '')}"
            out[label] = rels
            out[f"{label}_reference"] = sphere_reference_key(name)
            print(f"[spread] {label} rel_to_f64_ref={rels} "
                  f"max_abs={max(abs(r) for r in rels):.3e} "
                  f"t={time.perf_counter() - t0:.1f}s", flush=True)
    for name in ("float32", "float64"):
        out[f"max_abs_rel_{name}"] = max(
            abs(r) for k, v in out.items() if k.endswith(f"_{name}")
            for r in v)
    print(json.dumps(out))
    return 0



if __name__ == "__main__":
    sys.exit(main())
