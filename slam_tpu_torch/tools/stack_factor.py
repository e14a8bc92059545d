"""The dense batch's factor on the card, three ways, over a ``(B, n, n)``
stack: the hand-written kernel (``ops.stack_chol.stack_cholesky``), one
batched ``cholesky_ex`` call, and ``cholesky_ex`` a matrix into one stack
(``stack_cholesky_plain``, the cuSOLVER loop the kernel replaced).

    python3 -m slam_tpu_torch.tools.stack_factor [--sizes 5217 3684 3135]
        [--widths 8 6 2] [--dtype float32] [--reps 20] [--shapes 64:2 128:3]

The sizes are dense systems: 5217 the joint SC system of one INTEL+50
lane, 3684 and 3135 the pose-only ones of INTEL and CSAIL; ``--sizes 723
756 762 1662 3950`` are the Schur separators of the managers' evals at
INTEL, CSAIL and M3500, of the seed batch, and of M3500+50.  The widths
are the seed batch (8), the rescue's six chains, the managers' batches
(2 and 3 a MCTS step, up to 10 a layering step).  The matrices are
Jacobi-equilibrated SPD (:func:`spd_stack` scaled to a unit diagonal),
made on the card from a seed; a dense factor's time does not
depend on the values.  For each (size, width) one JSON line: the ms of
each way (CUDA events around ``reps`` calls, in the turns a, b, c, c, b,
a), the kernel's at each launch shape of ``--shapes`` (block width and
group, ``128:3``; default: the one the wrapper picks; the A/B for
choosing it), the least time of the work
(``n^3 / 3`` flops a matrix at the card's peak, or the matrix written
once), each way's max |L - L64| against the float64 factor, and whether
each lane of each way equals that matrix's factor alone to the bit; then
the ms of the solve that follows (``linear.cho_solve_stack``).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from slam_tpu_torch.ops import stack_chol
from slam_tpu_torch.solver.linear import cho_solve_stack
from slam_tpu_torch.tools.kernel_times import bound, card_peaks, \
    cholesky_work, cuda_ms, nvidia_smi


def spd_stack(lanes: int, n: int, dtype=torch.float64, seed: int = 0,
              device="cpu") -> torch.Tensor:
    """SPD matrices ``I + X X^T / (4 n)``, their rows and columns scaled
    by ``s`` uniform in [1, 10) (uneven diagonals), made in float64 on
    ``device`` from ``seed``, in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((lanes, n, n), generator=g, dtype=torch.float64,
                    device=device)
    A = torch.eye(n, dtype=torch.float64, device=device) + X @ X.mT / (4 * n)
    s = torch.rand((lanes, n), generator=g, dtype=torch.float64,
                   device=device) * 9 + 1
    return (A * s[:, :, None] * s[:, None, :]).to(dtype)


def jacobi(A: torch.Tensor) -> torch.Tensor:
    """The Jacobi scale ``diag(A)^(-1/2)`` of each matrix of the stack,
    the ``dscale`` of ``stack_cholesky``."""
    return 1.0 / torch.sqrt(torch.diagonal(A, dim1=-2, dim2=-1))


def at_schedule(shape: stack_chol.Schedule | None):
    """The kernel with its launch shape held at ``shape`` (None: the
    wrapper's own choice)."""
    if shape is None:
        return stack_chol.stack_cholesky

    return lambda A: stack_chol._stack_cholesky_cuda(A, None, shape)


def measure(n: int, width: int, dtype, reps: int, shapes: list) -> dict:
    A = spd_stack(width, n, dtype, device="cuda")
    d = jacobi(A)
    A = A * d[..., :, None] * d[..., None, :]
    b = torch.ones((width, n, 1), device="cuda", dtype=dtype)
    kernels = {"kernel_nb{}_g{}".format(
        *(s or stack_chol.schedule(n, dtype))): at_schedule(s)
        for s in shapes}
    ways = {**kernels,
            "batched": lambda: torch.linalg.cholesky_ex(A),
            "each": lambda: stack_chol.stack_cholesky_plain(A)}
    fns = {k: (lambda f=f: f(A)) if k in kernels else f
           for k, f in ways.items()}
    times = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        times[k].append(cuda_ms(fns[k], reps))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    ref = torch.linalg.cholesky(A.double())
    out = {k: f() for k, f in fns.items()}
    alone = {k: [ways[k](A[i:i + 1])[0][0] if k in kernels else
                 torch.linalg.cholesky_ex(A[i])[0] for i in range(width)]
             for k in fns}
    peaks = card_peaks()
    b_ms, b_by = bound(peaks, dtype, *cholesky_work(n, width,
                                                    A.element_size()))
    L = out["each"][0]
    return dict(
        n=n, width=width, dtype=str(dtype).replace("torch.", ""),
        ms=ms, bound_ms=b_ms, bound_by=b_by,
        each_over_kernel={k: ms["each"] / ms[k] for k in kernels},
        turns_ms=times,
        infos_zero={k: bool((o[1] == 0).all()) for k, o in out.items()},
        max_abs_err_vs_f64={k: (o[0].double() - ref).abs().max().item()
                            for k, o in out.items()},
        bitwise_alone={k: all(torch.equal(out[k][0][i], alone[k][i])
                              for i in range(width)) for k in fns},
        triangular_solves_ms=cuda_ms(lambda: cho_solve_stack(L, b), reps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[5217, 3684, 3135])
    ap.add_argument("--widths", type=int, nargs="+", default=[8, 6, 2])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="launch shapes nb:group to time the kernel at")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stack_factor: no CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    for n in args.sizes:
        for w in args.widths:
            shapes = [stack_chol.Schedule(*map(int, s.split(":")))
                      for s in args.shapes] or [None]
            print(json.dumps(measure(n, w, getattr(torch, args.dtype),
                                     args.reps, shapes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
