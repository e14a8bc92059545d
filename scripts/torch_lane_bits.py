#!/usr/bin/env python3
"""Whether the plain-torch steps of a batched PCG solve give each lane the
bits of its problem alone on the card, and what those exact lanes cost.

    python3 scripts/torch_lane_bits.py [--out FILE] [--skip-runs]

A batched PCG lane holds its CG count only if every step of its
iteration is its solve alone to the bit (CG carries a last-bit
difference into its count).  Three parts, one JSON line per case:

* ``bits``: for B problems of n unknowns in turn along a vector, and for
  B * m blocks of D x D with a vector each, in float64 and float32,
  whether a row reduction of the ``(B, n)`` view equals each row's full
  reduction, whether a full reduction of a row's slice equals that of
  the row alone, and whether each form of the block product (batched
  matmul, ``einsum``, elementwise product and sum) equals the same
  product of one problem's blocks alone.
* ``dots``: the port's lane dots (``linear._dot(seeds=B)``: each lane's
  own full reductions on aligned rows, 2B + 4 launches) against the form
  it replaced (each lane's two sums added before the stack, 3B + 3) and
  one row reduction of the ``(B, n)`` views for all lanes (5 launches,
  as one problem's dot), at INTEL+50's size a lane (3684 pose and 1536 switch
  unknowns) and the widths of the rescue's round (6), the seed batch (8)
  and the managers' fold (10); in turns (exact, added, rows, rows,
  added, exact): ms a dot under CUDA events, device launches a dot under
  ``torch.profiler``, and whether each lane's dot equals its problem's
  alone.
* ``runs`` (not with ``--skip-runs``): ``scripts/bench_pcg.py``'s float32
  seed batch (INTEL+50 x seeds 0-7, ``RUN_ITERS`` LM iterations) and the
  float64 PCG rescue round (six chains of INTEL+50 seed 42, capped at
  ``ROUND_ITERS`` LM iterations) under each dot, in turns: wall ms an
  iteration of the CG loop, each lane's CG count, and on the round
  whether each lane's iterations, accepted steps, convergence and CG
  count equal its chain alone's and how far its poses are from them.

Needs a CUDA device (exits 1 without one); imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

#: (B, n): the rescue's chains and the seed batch at INTEL+50 (3 N pose
#: unknowns, E switch unknowns), a fold of ten lanes, a long vector.
SUMS = ((6, 3684), (6, 1536), (8, 3684), (8, 1536), (10, 192), (3, 10500))
#: (B, m, D): blocks per problem at INTEL's node count and at SE(3).
BLOCKS = ((6, 1228, 3), (8, 1228, 3), (6, 1228, 6))
PRODUCTS = {
    "matmul": lambda m, v: (m @ v[..., None])[..., 0],
    "einsum": lambda m, v: torch.einsum("...ij,...j->...i", m, v),
    "elementwise": lambda m, v: (m * v[..., None, :]).sum(-1),
}
#: Lanes of the dots: the rescue's round, the seed batch, the fold.
DOT_LANES = (6, 8, 10)
#: Pose nodes and switch unknowns a lane at INTEL+50.
DOT_NODES, DOT_SWITCHES = 1228, 1536
DOT_REPS = 200
RUN_ITERS = 3
ROUND_ITERS = 5


def emit(out, **row) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def bits(out) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", generator=gen)
    for dtype in (torch.float64, torch.float32):
        for B, n in SUMS:
            x = torch.randn(B * n, dtype=dtype, **kw)
            rows = x.reshape(B, n).sum(-1)
            slices = torch.stack([x[k * n:(k + 1) * n].sum()
                                  for k in range(B)])
            alone = torch.stack([x[k * n:(k + 1) * n].clone().sum()
                                 for k in range(B)])
            emit(out, part="bits", sum=[B, n], dtype=str(dtype),
                 row_reduction_equals_each_row=bool(torch.equal(rows,
                                                                alone)),
                 slice_equals_alone=bool(torch.equal(slices, alone)))
        for B, m, D in BLOCKS:
            A = torch.randn(B, m, D, D, dtype=dtype, **kw)
            v = torch.randn(B, m, D, dtype=dtype, **kw)
            emit(out, part="bits", blocks=[B, m, D], dtype=str(dtype),
                 **{f"{name}_equals_alone": all(
                     torch.equal(fn(A, v)[k], fn(A[k], v[k]))
                     for k in range(B)) for name, fn in PRODUCTS.items()})


def added_dot(x, y, seeds):
    """Each lane's two full reductions added lane by lane and stacked
    (3B + 3 launches), the form ``linear._dot`` replaced."""
    pp, ss = x.poses * y.poses, x.switches * y.switches
    n, e = pp.shape[0] // seeds, ss.shape[0] // seeds
    return torch.stack([torch.sum(pp[k * n:(k + 1) * n])
                        + torch.sum(ss[k * e:(k + 1) * e])
                        for k in range(seeds)])


def rows_dot(x, y, seeds=None):
    """One row reduction of the ``(B, n)`` views for all lanes."""
    from slam_tpu_torch.solver.linear import _dot

    if seeds is None:
        return _dot(x, y)
    return ((x.poses * y.poses).reshape(seeds, -1).sum(-1)
            + (x.switches * y.switches).reshape(seeds, -1).sum(-1))


@contextlib.contextmanager
def dot_form(form: str):
    """``linear._dot`` as the port has it ("exact") or as ``rows_dot``."""
    from slam_tpu_torch.solver import linear

    exact = linear._dot
    if form == "rows":
        linear._dot = rows_dot
    try:
        yield
    finally:
        linear._dot = exact


def device_launches(fn, reps: int = 10) -> float:
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch.tools.profile_lm import device_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if device_us(e) > 0) / reps


def dots(out) -> None:
    from slam_tpu_torch.solver.linear import Update, _dot
    from slam_tpu_torch.tools.kernel_times import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float64, torch.float32):
        for B in DOT_LANES:
            def vec():
                return Update(
                    torch.randn(B * DOT_NODES, 3, dtype=dtype,
                                device="cuda", generator=gen),
                    torch.randn(B * DOT_SWITCHES, dtype=dtype,
                                device="cuda", generator=gen))

            x, y = vec(), vec()
            forms = {"exact": lambda: _dot(x, y, B),
                     "added": lambda: added_dot(x, y, B),
                     "rows": lambda: rows_dot(x, y, B)}
            alone = torch.stack([_dot(
                Update(x.poses[k * DOT_NODES:(k + 1) * DOT_NODES].clone(),
                       x.switches[k * DOT_SWITCHES:(k + 1)
                                  * DOT_SWITCHES].clone()),
                Update(y.poses[k * DOT_NODES:(k + 1) * DOT_NODES].clone(),
                       y.switches[k * DOT_SWITCHES:(k + 1)
                                  * DOT_SWITCHES].clone()))
                for k in range(B)])
            ms = {f: [] for f in forms}
            for f in ("exact", "added", "rows", "rows", "added",
                      "exact"):
                ms[f].append(cuda_ms(forms[f], DOT_REPS))
            single = lambda: _dot(x, y)  # noqa: E731
            emit(out, part="dots", lanes=B, dtype=str(dtype),
                 **{f"{f}_ms": ms[f] for f in forms},
                 single_problem_ms=cuda_ms(single, DOT_REPS),
                 **{f"{f}_launches": device_launches(fn)
                    for f, fn in forms.items()},
                 single_problem_launches=device_launches(single),
                 **{f"{f}_equals_alone": bool(torch.equal(fn(), alone))
                    for f, fn in forms.items()})


@contextlib.contextmanager
def cg_loop(out: list):
    """Count the CG loop's iterations (its matvecs) of the run inside."""
    from slam_tpu_torch.solver import linear

    matvec = linear.matvec

    def counted(*args, **kw):
        out.append(1)
        return matvec(*args, **kw)

    linear.matvec = counted
    try:
        yield out
    finally:
        linear.matvec = matvec


def runs(out, smi: str) -> None:
    from slam_tpu_torch.solver.batch import lane, lm_fixed_iters_batch, \
        lm_solve_batch
    from slam_tpu_torch.solver.lm import lm_solve
    from slam_tpu_torch.tools.problems import intel50_chains, \
        intel50_seed_batch

    # The seed batch, float32, bench_pcg's settings.
    case = intel50_seed_batch("cuda", torch.float32, "pcg")
    b, plan, cfg = case.batch, case.plan, case.cfg
    lm_fixed_iters_batch(*b.args, cfg, 1, partition=plan)  # warm-up

    def seed_batch(form):
        loop = []
        with dot_form(form), cg_loop(loop):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = lm_fixed_iters_batch(*b.args, cfg, RUN_ITERS,
                                       partition=plan)
            cg = res.lin_iters.tolist()  # synchronises
            wall = time.perf_counter() - t0
        return {"wall_s": wall, "loop_cg_iterations": len(loop),
                "ms_per_loop_cg_iter": wall * 1e3 / len(loop),
                "cg_per_seed": cg, "costs": res.cost.tolist()}

    got = [(f, seed_batch(f)) for f in ("exact", "rows", "rows", "exact")]
    emit(out, part="runs", cell="pcg_seed_batch_f32", seeds=b.seeds,
         lm_iterations=RUN_ITERS, turns=[dict(form=f, **r) for f, r in got],
         card=smi)

    # The rescue's first round, float64, against each chain alone.
    masks = intel50_chains("cuda", "float64").masks
    case = intel50_chains("cuda", "float64", "pcg", masks=masks)
    prob, ch = case.prob, case.chains
    cfg = prob.scfg.replace(max_iterations=ROUND_ITERS)
    alone = []
    for m in case.masks:
        es = prob.edges._replace(active=torch.as_tensor(
            m, dtype=prob.poses0.dtype, device="cuda"))
        alone.append(lm_solve(prob.poses0, prob.switches0, es, prob.free,
                              cfg, partition=prob.partition))
    lm_solve_batch(*case.args, cfg.replace(max_iterations=1), ch.partition)

    def round_(form):
        loop = []
        with dot_form(form), cg_loop(loop):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = lm_solve_batch(*case.args, cfg, ch.partition)
            res.iterations.tolist()  # synchronises
            wall = time.perf_counter() - t0
        same, dp = [], []
        for c, r in enumerate(alone):
            got = lane(res, c)
            same.append([int(got.iterations), int(got.accepted),
                         bool(got.converged), int(got.lin_iters)]
                        == [int(r.iterations), int(r.accepted),
                            bool(r.converged), int(r.lin_iters)])
            dp.append(float((got.poses - r.poses).abs().max()))
        return {"wall_s": wall, "loop_cg_iterations": len(loop),
                "ms_per_loop_cg_iter": wall * 1e3 / len(loop),
                "cg_per_lane": res.lin_iters.tolist(),
                "counts_equal_alone": same, "pose_diff_m": dp}

    got = [(f, round_(f)) for f in ("exact", "rows", "rows", "exact")]
    emit(out, part="runs", cell="pcg_rescue_round_f64", chains=ch.chains,
         lm_iterations=ROUND_ITERS,
         chains_alone_cg=[int(r.lin_iters) for r in alone],
         turns=[dict(form=f, **r) for f, r in got], card=smi)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument("--skip-runs", action="store_true",
                    help="only the bits and the dots")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lane_bits: no CUDA device", file=sys.stderr)
        return 1
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    bits(args.out)
    dots(args.out)
    if not args.skip_runs:
        runs(args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
