#!/usr/bin/env python3
"""Methods 3 and 4 and the dense rescue of one source tree on the card,
for comparing two trees of the port in turns.

    python3 scripts/torch_manager_ab.py TREE [--cells a,b] [--out FILE]

Imports ``slam_tpu_torch`` from ``TREE`` (an unpacked checkout) and runs,
through that tree's ``tools/manager_spread.run_cell``, each cell with the
CLI's defaults on the card: the five INTEL+50 and CSAIL+50 cells on the
fused engine (``--fused on``) and on the host engine (``--fused off``),
and M3500+50 method 4 on the fused engine; then ``INTEL 50 1 --seed 42
--linear-solver dense`` (the rescue's chains on the batched dense
solver).  One JSON line per run: the wall seconds, the short solves and
``lm_fixed_iters`` calls (a tree whose engine record has no ``calls``
makes one call a solve), the hand-written kernels' launches, each per
candidate, and whether the run's decisions equal the oracle's; for the
dense run its solve's wall and the ATE against the golden trajectory.
Run the same script file against each tree in its own process, in
turns (a, b, b, a).  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

CELLS = ("intel50_m4", "intel50_m3_ceres", "intel50_m3", "csail50_m3",
         "csail50_m4")
RUNS = ([(c, "on") for c in CELLS] + [(c, "off") for c in CELLS]
        + [("m3500_m4", "on"), ("dense_rescue", None)])


def manager(cell: str, fused: str, card: str) -> dict:
    import torch

    from slam_tpu_torch import ops
    from slam_tpu_torch.tools.manager_spread import run_cell

    torch.cuda.synchronize()
    ops.reset_launches()
    row = run_cell(cell, "cuda", fused=fused)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n = row["candidates"]
    calls = row.get("calls", row["short_solves"])
    out = dict(cell=cell, fused=row["fused"], eval=row["linear_solver"],
               candidates=n, wall_s=row["wall_s"],
               engine_wall_s=row["engine_wall_s"],
               short_solves=row["short_solves"], calls=calls,
               calls_per_candidate=calls / n,
               lm_iterations=row["lm_iterations"],
               launches_per_candidate={k: c / n for k, c in counts.items()},
               card=card)
    if "identical_prefix" in row:
        out.update(identical_prefix=row["identical_prefix"],
                   best_layer=row["best_layer"],
                   oracle_best_layer=row["oracle_best_layer"])
    else:
        out.update(layers=row["layers"], best_layer=row["best_layer"],
                   ate_best_m=row["ate_best_m"])
    return out


def dense_rescue(tree: str, card: str) -> dict:
    import io
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from slam_tpu_torch import cli
    from slam_tpu_torch.eval import metrics
    from slam_tpu_torch.io import g2o

    with tempfile.TemporaryDirectory() as save:
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = cli.main(["INTEL", "50", "1", "--seed", "42",
                           "--linear-solver", "dense", "--save-path", save])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"dense rescue: cli.main returned {rc}")
        poses = g2o.load_nodes(os.path.join(save, "opt_nodes.txt"))
    solve = re.search(r"\[solve\] .*wall_s=([0-9.e+-]+)", buf.getvalue())
    ref = np.load(os.path.join(tree, "results", "golden",
                               "INTEL_50out_seed42.npy"))
    return dict(cell="dense_rescue", wall_s=wall,
                solve_wall_s=float(solve.group(1)) if solve else None,
                ate_m=metrics.ate(poses, ref), card=card)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--cells", default=None,
                    help="comma-separated CELL:fused (on/off) or "
                         "dense_rescue; default every run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_manager_ab: no CUDA device", file=sys.stderr)
        return 1
    import slam_tpu_torch
    from slam_tpu_torch.tools.kernel_times import nvidia_smi

    if not os.path.abspath(slam_tpu_torch.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"slam_tpu_torch came from "
                           f"{slam_tpu_torch.__file__}, not {tree}")

    card = nvidia_smi()
    runs = RUNS
    if args.cells:
        runs = [tuple(c.split(":")) if ":" in c else (c, None)
                for c in args.cells.split(",")]
    for cell, fused in runs:
        row = (dense_rescue(tree, card) if cell == "dense_rescue"
               else manager(cell, fused, card))
        line = json.dumps(dict(tree=args.tree, **row))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
