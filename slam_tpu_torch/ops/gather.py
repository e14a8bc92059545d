"""Row gather and deterministic segment-sum scatter.

Port of ``slam_tpu/ops/pallas_gather.py``.  On the TPU these kernels were
kept but not used (one-hot incidence matmuls compiled faster there); on
the GPU they are the one tier for every edge/node gather and scatter and
for the Schur and dense assembly.

The scatter is a CSR segment sum: :func:`segment_plan` sorts the static
topology once on the host, and the kernel sums each segment in that fixed
order, so results are bitwise stable from run to run (no float atomics).

Each wrapper takes the plain PyTorch version for a CPU tensor only; a CUDA
tensor launches the CUDA kernel (``csrc/gather.cu``) or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops import _build

Tensor = torch.Tensor


class SegmentPlan(NamedTuple):
    """A static scatter ``out[idx[m]] += v[src[m]]`` sorted for the kernel.

    ``perm`` lists the source rows segment by segment (stable, so rows of
    one segment keep their order) and ``offsets`` (n+1) bounds each
    segment in ``perm``.  ``src``/``idx`` keep the unsorted form for the
    plain version.  All index tensors are int32; ``src_rows`` is the least
    number of source rows the plan reads.
    """

    src: Tensor
    idx: Tensor
    perm: Tensor
    offsets: Tensor
    n: int
    src_rows: int


def segment_plan(idx, n: int, src=None, device=None) -> SegmentPlan:
    """Plan the scatter of source rows ``src`` (default ``arange``) into
    segments ``idx`` of ``n`` outputs."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    src = (np.arange(idx.shape[0], dtype=np.int64) if src is None
           else np.asarray(src, np.int64).reshape(-1))
    if src.shape != idx.shape:
        raise ValueError("src and idx differ in length")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"segment ids out of range [0, {n})")
    if max(n, idx.size, int(src.max(initial=0)) + 1) >= 2**31:
        raise ValueError("plan too large for int32 indices")
    order = np.argsort(idx, kind="stable")
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(idx, minlength=n), out=offsets[1:])

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return SegmentPlan(src=t(src), idx=t(idx), perm=t(src[order]),
                       offsets=t(offsets), n=int(n),
                       src_rows=int(src.max(initial=-1)) + 1)


def _flat(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0], -1)


def _check_float(x: Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32/float64 only, got {x.dtype}")


def gather_rows_plain(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for ``x (N, ...)`` -> ``(E, ...)``."""
    return x.index_select(0, idx.long())


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for ``x (N, ...)``, ``idx (E,)`` int32 -> ``(E, ...)``.

    Indices are checked when a plan or ``EdgeSet`` is built; the kernel
    trusts them.
    """
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    _check_float(x, "gather_rows")
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be contiguous 1-D int32 on "
                         "the same device as x")
    xf = _flat(x.contiguous())
    out = torch.empty((idx.shape[0], xf.shape[1]), dtype=x.dtype,
                      device=x.device)
    fn = getattr(_build.lib(), "slam_gather_rows" + _build.suffix(x.dtype))
    _build.check(fn(xf.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    out.shape[0], out.shape[1], _build.stream_ptr(x.device)),
                 "gather_rows")
    gather_rows.launches += 1
    return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))


gather_rows.launches = 0


def scatter_add_rows_plain(v: Tensor, plan: SegmentPlan) -> Tensor:
    """Segment sum of ``v (M, ...)`` by ``plan`` with ``index_add_``."""
    vf = _flat(v)
    out = torch.zeros((plan.n, vf.shape[1]), dtype=v.dtype, device=v.device)
    out.index_add_(0, plan.idx.long(), vf.index_select(0, plan.src.long()))
    return out.reshape((plan.n,) + tuple(v.shape[1:]))


def scatter_add_rows(v: Tensor, plan: SegmentPlan) -> Tensor:
    """``segment_sum(v[src], idx, n)`` for ``v (M, ...)`` -> ``(n, ...)``,
    each segment summed in plan order."""
    if v.device.type == "cpu":
        return scatter_add_rows_plain(v, plan)
    _check_float(v, "scatter_add_rows")
    if plan.perm.device != v.device:
        raise ValueError("scatter_add_rows: plan and values on different "
                         "devices")
    if v.shape[0] < plan.src_rows:
        raise ValueError(f"scatter_add_rows: plan reads {plan.src_rows} "
                         f"rows, got {v.shape[0]}")
    vf = _flat(v.contiguous())
    out = torch.empty((plan.n, vf.shape[1]), dtype=v.dtype, device=v.device)
    fn = getattr(_build.lib(),
                 "slam_scatter_add_rows" + _build.suffix(v.dtype))
    _build.check(fn(vf.data_ptr(), plan.perm.data_ptr(),
                    plan.offsets.data_ptr(), out.data_ptr(), plan.n,
                    vf.shape[1], _build.stream_ptr(v.device)),
                 "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out.reshape((plan.n,) + tuple(v.shape[1:]))


scatter_add_rows.launches = 0
