"""``micro_chol_inv`` of one tree against another's, bit for bit, with times.

    python3 slam_tpu_torch/tools/chol_ab.py PARENT make OUT
    python3 slam_tpu_torch/tools/chol_ab.py CHANGE run OUT2 OUT

Run as a script with a tree's root (a ``git archive`` of a commit, or the
repo itself) as the first argument: it imports ``slam_tpu_torch`` and
``chip_smoke`` from that tree.  ``make`` builds the inputs -- SPD batches
over a range of p, up to the kernel's largest, and the first and trailing
real Schur panels of INTEL+50 and M10000+50 (``chip_smoke.real_panels``),
float32 and float64 -- and saves them with the tree's outputs under the
path prefix OUT.  ``run`` loads the inputs saved under OUT, computes the
tree's outputs and prints the keys whose L or inverse differ from the
outputs saved under OUT (its own under OUT2).  Both print the CUDA-event
ms of each call at p = 128.  Give each tree its own prefix inside its
checkout (the ``.pt`` files reach tens of MB).  Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys


def make_inputs(dev, chol) -> dict:
    import chip_smoke
    import numpy as np
    import torch
    from slam_tpu_torch.tools.problems import intel50, m10000

    inputs = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        for m, p in ((16, 128), (32, 128), (3, 1), (3, 2), (5, 31), (4, 64),
                     (3, 100), (2, chol.max_panel(dtype))):
            rng = np.random.default_rng(1000 * m + p)
            G = rng.normal(size=(m, p, p))
            inputs[f"spd{m}x{p}-{name}"] = torch.as_tensor(
                G @ G.transpose(0, 2, 1) + p * np.eye(p), dtype=dtype)
        prob = intel50(dev, name)
        big = m10000(dev, dtype)
        for label, (args, part) in {
                "INTEL": ((prob.poses0, prob.switches0, prob.edges,
                           prob.free), prob.partition),
                "M10000": (big.args, big.partition)}.items():
            poses, _, edges, free = args
            panels = chip_smoke.real_panels(edges, free, poses, part)
            for which in ("first", "trailing"):
                inputs[f"{label}-{which}-{name}"] = panels[which].cpu()
    return inputs


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
    if mode == "make":
        torch.save(make_inputs(dev, chol), out + ".in.pt")
    ref = out if mode == "make" else argv[3]
    inputs = torch.load(ref + ".in.pt")
    res, times = {}, {}
    for key, A in inputs.items():
        A = A.to(dev)
        L, X = chol.micro_chol_inv(A)
        res[key] = (L.cpu(), X.cpu())
        if A.shape[-1] == 128:
            times[key] = round(cuda_ms(lambda: chol.micro_chol_inv(A), 50), 5)
    torch.save(res, out + ".out.pt")
    print(json.dumps({"tree": tree, "ms": times}))
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
