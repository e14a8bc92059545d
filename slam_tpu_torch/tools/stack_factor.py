"""The dense batch's factor on the card: one batched ``cholesky_ex`` over a
``(B, n, n)`` stack against ``linear.cholesky_each`` (one call a matrix
into the same stack).

    python3 -m slam_tpu_torch.tools.stack_factor [--sizes 3684 3135]
        [--widths 2 3 4 6 10] [--dtype float32] [--reps 20]

The sizes are the dense systems of INTEL (3 x 1228 unknowns) and CSAIL
(3 x 1045); the widths are the managers' batches (2 and 3 a MCTS step,
up to 10 a layering step) and the rescue's six chains.  The matrices are
Jacobi-equilibrated SPD (``I + X X^T / (4 n)`` scaled to a unit
diagonal), made on the card from a seed; a dense factor's time does not
depend on the values.  For each (size, width) one JSON line: the ms of
each way (CUDA events around ``reps`` calls, in the turns a, b, b, a),
the ms of the solve that follows it (``linear.cho_solve_stack``'s two
batched triangular solves, and ``cholesky_solve`` on the stack), and
whether each lane of either way equals that matrix's factor alone to the
bit.  ``--sizes 723 756 762 1662`` are the Schur separators (D x ns) of
the managers' evals at INTEL, CSAIL and M3500 and of the seed batch.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from slam_tpu_torch.solver.linear import cho_solve_stack, cholesky_each
from slam_tpu_torch.tools.kernel_times import cuda_ms, nvidia_smi


def spd_stack(width: int, n: int, dtype, seed: int = 0) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((width, n, n), generator=g, device="cuda", dtype=dtype)
    A = torch.eye(n, device="cuda", dtype=dtype) + X @ X.mT / (4 * n)
    d = torch.diagonal(A, dim1=-2, dim2=-1).rsqrt()
    return A * d[..., :, None] * d[..., None, :]


def measure(n: int, width: int, dtype, reps: int) -> dict:
    A = spd_stack(width, n, dtype)
    b = torch.ones((width, n, 1), device="cuda", dtype=dtype)
    ways = {"batched": lambda: torch.linalg.cholesky_ex(A),
            "each": lambda: cholesky_each(A)}
    times = {k: [] for k in ways}
    for k in list(ways) + list(ways)[::-1]:
        times[k].append(cuda_ms(ways[k], reps))
    L, _ = ways["each"]()
    tri = cuda_ms(lambda: cho_solve_stack(L, b), reps)
    potrs = cuda_ms(lambda: torch.cholesky_solve(b, L), reps)
    alone = [torch.linalg.cholesky_ex(A[k])[0] for k in range(width)]
    bitwise = {k: all(torch.equal(f()[0][i], alone[i]) for i in range(width))
               for k, f in ways.items()}
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    return dict(n=n, width=width, dtype=str(dtype).replace("torch.", ""),
                batched_ms=ms["batched"], each_ms=ms["each"],
                each_over_batched=ms["each"] / ms["batched"],
                turns_ms={k: v for k, v in times.items()},
                triangular_solves_ms=tri, cholesky_solve_ms=potrs,
                bitwise_alone=bitwise)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[3684, 3135])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[2, 3, 4, 6, 10])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stack_factor: no CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    for n in args.sizes:
        for w in args.widths:
            print(json.dumps(measure(n, w, getattr(torch, args.dtype),
                                     args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
