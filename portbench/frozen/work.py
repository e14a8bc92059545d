"""Bytes and operations of each hand-written kernel's call, and the
card's published peaks.

Frozen copy of ``gather_work``, ``scatter_work``, ``linearize_work``,
``chol_work``, ``bound`` and ``PEAKS`` of
``slam_tpu_torch/tools/kernel_times.py`` at commit 407e87e, without the
library calls, and taking shapes in place of the call's tensors (a traced
window keeps no tensor of a call alive): the counts read only shapes and
the plans' index arrays.
Each input byte is counted read once and each output byte written once,
whatever the kernel reads again.
"""

from __future__ import annotations

import numpy as np
import torch

#: Operations per edge of the linearisation kernel: about 200 flops and 9
#: transcendentals (``slam_tpu_torch/csrc/linearize_se2.cu``).
LINEARIZE_OPS_PER_EDGE = 209

#: Published peaks (NVIDIA data sheets; dense, no sparsity; float32 and
#: float64 outside the tensor cores): memory bytes/s and operations/s.
PEAKS = {
    "H100 PCIe": (2.0e12, {torch.float32: 51e12, torch.float64: 26e12}),
    "H100 NVL": (3.9e12, {torch.float32: 60e12, torch.float64: 30e12}),
    "H200": (4.8e12, {torch.float32: 67e12, torch.float64: 34e12}),
    "H100": (3.35e12, {torch.float32: 67e12, torch.float64: 34e12}),
}


def card_peaks(name: str) -> tuple[float, dict]:
    """``(bytes/s, {dtype: operations/s})`` of the card named ``name``."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_s(peaks, dtype, nbytes: float, ops: float) -> float:
    """The least seconds this work takes: the larger of the two bounds."""
    return max(nbytes / peaks[0], ops / peaks[1][dtype])


def gather_work(rows: int, row_bytes: int, idx_count: int,
                idx_bytes: int) -> tuple[float, float]:
    """``x[idx]`` of ``x`` with ``rows`` rows of ``row_bytes``: x and idx
    read once, the output written once."""
    return float(rows * row_bytes + idx_count * idx_bytes
                 + idx_count * row_bytes), 0.0


def scatter_work(shape: tuple, itemsize: int, plan) -> tuple[float, float]:
    """One plan's segment sum of values of ``shape``: the distinct source
    rows read once, the plan's rows and the bounds of its non-empty
    segments read once (4 bytes each), the whole output (the zeroed
    matrix of a block-grid plan) written once; one add per source row and
    column."""
    K = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    src = plan.src.cpu().numpy()
    nonempty = int(np.count_nonzero(np.diff(plan.offsets.cpu().numpy())))
    nbytes = (np.unique(src).size * K * itemsize + 4 * src.size
              + 8 * nonempty + plan.n * K * itemsize)
    return float(nbytes), float(src.size * K)


def linearize_work(pose_bytes: int, free_bytes: int, edges,
                   itemsize: int) -> tuple[float, float]:
    """The indexed linearisation: the poses, the free mask, the endpoints
    and the edge inputs read once, the 56 values per edge written once."""
    E = edges.num_edges
    nbytes = (pose_bytes + free_bytes
              + edges.ab.numel() * edges.ab.element_size()
              + E * (3 + 1 + 1 + 56) * itemsize)
    return float(nbytes), float(LINEARIZE_OPS_PER_EDGE * E)


def chol_work(shape: tuple, itemsize: int) -> tuple[float, float]:
    """``micro_chol_inv`` of matrices of ``shape`` (..., p, p): the lower
    triangle read, L and its inverse written; about 2/3 p^3 flops a
    matrix."""
    p = shape[-1]
    m = int(np.prod(shape[:-2]))
    return (float(m * (p * (p + 1) // 2 + 2 * p * p) * itemsize),
            float(m * 2 * p ** 3 / 3))


def cholesky_work(n: int, count: int, itemsize: int) -> tuple[float, float]:
    """``count`` Cholesky factors of order ``n``: n^3 / 3 flops each, the
    assembled matrix written once."""
    return float(count * n * n * itemsize), float(count * n ** 3 / 3)
