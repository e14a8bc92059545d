"""``micro_chol_inv`` of one tree against another's, bit for bit, with times.

    python3 slam_tpu_torch/tools/chol_ab.py PARENT make OUT
    python3 slam_tpu_torch/tools/chol_ab.py CHANGE run OUT2 OUT
    python3 slam_tpu_torch/tools/chol_ab.py TREE times OUT.jsonl

Run as a script with a tree's root (a ``git archive`` of a commit, or the
repo itself) as the first argument: it imports ``slam_tpu_torch`` and
``chip_smoke`` from that tree.  ``make`` builds the inputs -- SPD batches
over a range of p, up to the kernel's largest; the folded SPD batches of
6 x 16 and 8 x 16 panels of 128; the first and trailing real Schur panels
of INTEL+50 and M10000+50 (``chip_smoke.real_panels``), and those of the
seed batch (8 seeds) and of the rescue's chain batch (6 chains), folded
over their lanes; float32 and float64 -- and saves them with the tree's
outputs under the path prefix OUT.  A four-dimensional input goes through
``micro_chol_inv_folded``.  ``run`` loads the inputs saved under OUT,
computes the tree's outputs and prints the keys whose L or inverse differ
from the outputs saved under OUT (its own under OUT2).  Both print the
CUDA-event ms of each call at p = 128.  Give each tree its own prefix
inside its checkout (the ``.pt`` files reach tens of MB).

``times`` appends one JSON line to OUT.jsonl: for each SPD batch of
panels of 128 (16 and 32 for ``micro_chol_inv``, 6 x 16 and 8 x 16
folded; float32 and float64) the CUDA-event ms, the device ms and device
kernels a call under torch.profiler and the host µs; then, float32 with
the blocked factorisation and ``micro_chol_inv``, the wall ms, device
ms, busy share and device launches per batched iteration of the seed
batch (INTEL+50 x seeds 0-7, ``lm_fixed_iters_batch``) and of the
rescue's first round (6 chains, ``lm_solve_batch``), and the solve's wall
of ``INTEL 50 1 --seed 42`` through the pipeline in that configuration
(the rescue on).  Run it from each tree in turns (parent, change, change,
parent), each in its own process.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

FOLDED_LEADS = (6, 8)   # the rescue's chains, the seed batch's seeds
PANEL = 128


def spd(m: int, p: int, dtype, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    G = rng.normal(size=(m, p, p))
    return torch.as_tensor(G @ G.transpose(0, 2, 1) + p * np.eye(p),
                           dtype=dtype)


def make_inputs(dev, chol) -> dict:
    import chip_smoke
    import torch
    from slam_tpu_torch.tools.problems import intel50, intel50_chains, \
        intel50_seed_batch, m10000

    inputs = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for m, p in ((16, 128), (32, 128), (3, 1), (3, 2), (5, 31), (4, 64),
                     (3, 100), (2, chol.max_panel(dtype))):
            inputs[f"spd{m}x{p}-{name}"] = spd(m, p, dtype, 1000 * m + p)
        for lead in FOLDED_LEADS:
            inputs[f"spd{lead}x16x{PANEL}-{name}"] = spd(
                16 * lead, PANEL, dtype, lead).view(lead, 16, PANEL, PANEL)
        prob = intel50(dev, name)
        big = m10000(dev, dtype)
        b = intel50_seed_batch(dev, dtype).batch
        chains = intel50_chains(dev, name)
        poses, _, edges, free = chains.flat_args
        for label, (args, part, lead) in {
                "INTEL": ((prob.poses0, prob.switches0, prob.edges,
                           prob.free), prob.partition, None),
                "M10000": (big.args, big.partition, None),
                "seed-batch": ((b.poses0.reshape(-1, 3), None, b.edges,
                                b.free), b.partition, b.seeds),
                "chain-batch": ((poses, None, edges, free),
                                chains.chains.partition,
                                chains.chains.chains)}.items():
            poses_, _, edges_, free_ = args
            panels = chip_smoke.real_panels(edges_, free_, poses_, part)
            for which in ("first", "trailing"):
                A = panels[which].cpu()
                if lead:
                    A = A.view(lead, -1, *A.shape[1:])
                inputs[f"{label}-{which}-{name}"] = A
    return inputs


def call(chol, A):
    """The tree's kernel on ``A``: folded where ``A`` has a leading axis."""
    if A.dim() == 4:
        return chol.micro_chol_inv_folded(A)
    return chol.micro_chol_inv(A)


def batch_rows(dev) -> tuple[dict, object]:
    """The blocked-kernel rows of the seed batch and the rescue's first
    round, per batched iteration, and the pipeline's solve wall; and a
    function that adds their device times (torch.profiler: call it after
    every other timing of the process)."""
    import chip_smoke
    import torch
    from slam_tpu_torch import ops
    from slam_tpu_torch.config import RunConfig, SolverConfig
    from slam_tpu_torch.methods.global_solve import run_from_config
    from slam_tpu_torch.solver.batch import lm_fixed_iters_batch, \
        lm_solve_batch
    from slam_tpu_torch.tools.problems import BATCH_ITERS, CONFIGS, \
        intel50_chains, intel50_seed_batch

    rows = {}
    case = intel50_seed_batch(dev, torch.float32)
    b, cfg = case.batch, case.cfg.replace(**CONFIGS["blocked_micro"])
    chains = intel50_chains(dev, "float32")
    ccfg = chains.prob.scfg.replace(**CONFIGS["blocked_micro"])
    runs = {  # name: (run of n batched iterations, iterations timed)
        "seed_batch": (lambda n: lm_fixed_iters_batch(
            *b.args, cfg, n, partition=b.partition), BATCH_ITERS),
        # The round to its end, each lane stopping on its own.
        "rescue_round": (lambda n: lm_solve_batch(
            *chains.args, ccfg.replace(max_iterations=n),
            chains.chains.partition), ccfg.max_iterations)}
    for name, (run, iters) in runs.items():
        run(2)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = int(res.iterations.max()) if name == "rescue_round" else iters
        rows[name] = dict(
            iterations=n, wall_ms_per_iter=wall * 1e3 / n,
            micro_chol_inv_per_iter=ops.launch_counts()["micro_chol_inv"] / n)

    with tempfile.TemporaryDirectory() as save:
        t0 = time.perf_counter()
        run_from_config(RunConfig(
            dataset="INTEL", num_outliers=50, method=1, seed=42,
            save_path=save, solver=SolverConfig(
                dtype="float32", **CONFIGS["blocked_micro"])), device=dev)
        wall = time.perf_counter() - t0
        solve = chip_smoke.log_record(os.path.join(save, "method1.log"),
                                      "solve")
    rows["blocked_path"] = dict(wall_s=wall,
                                solve_wall_s=float(solve["wall_s"]),
                                final_cost=float(solve["final_cost"]))

    def device_times():
        for name, (run, _) in runs.items():
            rows[name].update(chip_smoke.batch_device_ms(
                run, rows[name]["wall_ms_per_iter"]))

    return rows, device_times


def times(dev, chol, tree: str, out: str) -> None:
    import math
    import subprocess

    import torch
    from slam_tpu_torch.tools.kernel_times import cuda_ms, device_ms, \
        host_us

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    kernels, fns = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for shape in ((16,), (32,), *((lead, 16) for lead in FOLDED_LEADS)):
            A = spd(math.prod(shape), PANEL, dtype, math.prod(shape)).to(
                dev).view(*shape, PANEL, PANEL)
            key = "x".join(map(str, shape)) + "-" + name
            fns[key] = lambda A=A: call(chol, A)
            kernels[key] = dict(ms=cuda_ms(fns[key], 50),
                                host_us=host_us(fns[key], 50))
    rows, device_times = batch_rows(dev)
    # The profiler last: a session leaves later host-bound calls slower.
    device_times()
    for key, row in kernels.items():
        row["device_ms"], row["kernels_per_call"] = device_ms(fns[key], 50)
    line = dict(tree=tree, card=smi.strip(), kernels=kernels, **rows)
    print(json.dumps(line))
    with open(out, "a") as f:
        f.write(json.dumps(line) + "\n")


def main(argv: list[str]) -> int:
    tree, mode, out = argv[:3]
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from slam_tpu_torch import runtime
    from slam_tpu_torch.ops import chol
    from slam_tpu_torch.tools.kernel_times import cuda_ms

    if not torch.cuda.is_available():
        print("chol_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = runtime.setup_device("cuda")
    if mode == "times":
        times(dev, chol, tree, out)
        return 0
    if mode == "make":
        torch.save(make_inputs(dev, chol), out + ".in.pt")
    ref = out if mode == "make" else argv[3]
    inputs = torch.load(ref + ".in.pt")
    res, ms = {}, {}
    for key, A in inputs.items():
        A = A.to(dev)
        L, X = call(chol, A)
        res[key] = (L.cpu(), X.cpu())
        if A.shape[-1] == PANEL:
            ms[key] = round(cuda_ms(lambda: call(chol, A), 50), 5)
    torch.save(res, out + ".out.pt")
    print(json.dumps({"tree": tree, "ms": ms}))
    if mode == "run":
        want = torch.load(ref + ".out.pt")
        differ = [key for key, (L, X) in res.items()
                  if not (torch.equal(L, want[key][0])
                          and torch.equal(X, want[key][1]))]
        print(json.dumps({"compared": len(res), "differ": differ}))
        return 1 if differ else 0
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
