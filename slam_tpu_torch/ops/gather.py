"""Row gather and deterministic, grouped segment-sum scatter.

Port of ``slam_tpu/ops/pallas_gather.py``.  On the TPU these kernels were
kept but not used (one-hot incidence matmuls compiled faster there); on
the GPU they are the one tier for every edge/node gather and scatter and
for the Schur and dense assembly.

The scatter is a CSR segment sum: :func:`segment_plan` sorts the static
topology once on the host, and the kernel sums each segment in that fixed
order, so results are bitwise stable from run to run (no float atomics).
A plan may place its segments as the blocks of a row-major block grid, so
the assembly gets its matrices with no permuting copy, and
:func:`scatter_add_groups` sums several (values, plan) groups in one
launch.  A gather of several index sets from one source is one gather of
their concatenation (``EdgeSet.ab``, ``SchurPartition.node_gather``).

Each wrapper takes the plain PyTorch version for a CPU tensor only; a CUDA
tensor launches the CUDA kernel (``csrc/gather.cu``) or raises.
"""

from __future__ import annotations

import array
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from slam_tpu_torch.ops import _build

Tensor = torch.Tensor

#: Groups one scatter launch takes (``kMaxGroups`` in ``csrc/gather.cu``).
MAX_GROUPS = 8


class SegmentPlan(NamedTuple):
    """A static scatter ``out[idx[m]] += v[src[m]]`` sorted for the kernel.

    ``perm`` lists the source rows segment by segment (stable, so rows of
    one segment keep their order) and ``offsets`` (n+1) bounds each
    segment in ``perm``.  ``seg`` lists the segments the kernel writes and
    ``starts`` bounds them in ``perm`` (its work list): the non-empty ones,
    whose output the launch zero-fills first; or, where at least half the
    segments are non-empty, every segment, each empty one writing its own
    zeros, so the launch needs no memset.  ``src``/``idx`` keep the
    unsorted form for the plain version.  All index tensors are int32;
    ``src_rows`` is the least number of source rows the plan reads.

    ``grid`` is None for a flat ``(n, ...)`` output, or ``(lead, rows,
    cols)`` with ``n = prod(lead) * rows * cols``: segment ``(.., r, c)``
    is then the ``D x D`` block at block row ``r``, column ``c`` of a
    row-major ``(*lead, rows * D, cols * D)`` matrix, for source rows of
    ``D * D`` values.
    """

    src: Tensor
    idx: Tensor
    perm: Tensor
    offsets: Tensor
    seg: Tensor
    starts: Tensor
    n: int
    src_rows: int
    grid: tuple | None


def segment_plan(idx, n: int, src=None, device=None,
                 grid: tuple | None = None) -> SegmentPlan:
    """Plan the scatter of source rows ``src`` (default ``arange``) into
    segments ``idx`` of ``n`` outputs, placed flat or by ``grid``."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    src = (np.arange(idx.shape[0], dtype=np.int64) if src is None
           else np.asarray(src, np.int64).reshape(-1))
    if src.shape != idx.shape:
        raise ValueError("src and idx differ in length")
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(f"segment ids out of range [0, {n})")
    if src.size and src.min() < 0:
        raise ValueError("negative source rows")
    if max(n, idx.size, int(src.max(initial=0)) + 1) >= 2**31:
        raise ValueError("plan too large for int32 indices")
    if grid is not None:
        lead, rows, cols = grid
        grid = (tuple(int(d) for d in lead), int(rows), int(cols))
        if math.prod(grid[0]) * grid[1] * grid[2] != n:
            raise ValueError(f"grid {grid} does not hold {n} segments")
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    seg = np.flatnonzero(counts)
    if 2 * seg.size >= n:
        seg = np.arange(n)

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=device)

    return SegmentPlan(src=t(src), idx=t(idx), perm=t(src[order]),
                       offsets=t(offsets), seg=t(seg),
                       starts=t(np.append(offsets[seg], idx.size)),
                       n=int(n), src_rows=int(src.max(initial=-1)) + 1,
                       grid=grid)


@functools.lru_cache(maxsize=256)
def _layout(n: int, grid: tuple | None, trailing: tuple) -> tuple:
    """``(out shape, its strides, K, cols, w, ld)`` of a plan of ``n``
    segments placed by ``grid``, for source rows of shape ``trailing``:
    column ``k`` of segment ``s`` lands at element
    ``((s // cols) * (K // w) + k // w) * ld + (s % cols) * w + k % w``
    of the output (the kernel's arithmetic)."""
    K = math.prod(trailing)
    if grid is None:
        shape, cols, w, ld = (n, *trailing), 1, K, K
    else:
        lead, rows, cols = grid
        D = math.isqrt(K)
        if D * D != K:
            raise ValueError(f"a block-grid plan takes rows of D*D values, "
                             f"got {tuple(trailing)}")
        shape, w, ld = (*lead, rows * D, cols * D), D, cols * D
    strides, step = [], 1
    for d in reversed(shape):
        strides.append(step)
        step *= d
    return shape, tuple(reversed(strides)), K, cols, w, ld


def placement(plan: SegmentPlan, K: int) -> Tensor:
    """``(m, K)`` int64 output element of every column of every segment of
    the work list, for rows of ``K`` values: the kernel's address
    arithmetic."""
    _, _, K, cols, w, ld = _layout(plan.n, plan.grid, (K,))
    s = plan.seg.long()
    k = torch.arange(K, device=s.device)
    return (((s // cols) * (K // w))[:, None] + k // w) * ld \
        + ((s % cols) * w)[:, None] + k % w


def gather_rows_plain(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for ``x (N, ...)`` -> ``(E, ...)``."""
    return x.index_select(0, idx.long())


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for ``x (N, ...)``, ``idx (E,)`` int32 -> ``(E, ...)``.

    Indices are checked when a plan or ``EdgeSet`` is built; the kernel
    trusts them.
    """
    if x.is_cpu:
        return gather_rows_plain(x, idx)
    fn = _build.entry("slam_gather_rows", x.dtype)
    dev = x.get_device()
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or idx.get_device() != dev or not idx.is_contiguous():
        raise ValueError("gather_rows: idx must be contiguous 1-D int32 on "
                         "the same device as x")
    if not x.is_contiguous():
        x = x.contiguous()
    rows, cols = idx.shape[0], math.prod(x.shape[1:])
    out = torch.empty((rows, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if rows * cols:
        _build.check(fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows,
                        cols, _build.stream_ptr(dev)), "gather_rows")
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


def _check_rows(v: Tensor, plan: SegmentPlan) -> None:
    if v.shape[0] < plan.src_rows:
        raise ValueError(f"scatter_add_rows: plan reads {plan.src_rows} "
                         f"rows, got {v.shape[0]}")


def scatter_add_rows_plain(v: Tensor, plan: SegmentPlan) -> Tensor:
    """Segment sum of ``v (M, ...)`` by ``plan`` with ``index_add_``,
    placed by the kernel's arithmetic (:func:`placement`)."""
    _check_rows(v, plan)
    vf = v.reshape(v.shape[0], -1)
    shape, _, K, *_ = _layout(plan.n, plan.grid, tuple(v.shape[1:]))
    flat = torch.zeros((plan.n, K), dtype=v.dtype, device=v.device)
    flat.index_add_(0, plan.idx.long(), vf.index_select(0, plan.src.long()))
    if plan.grid is None:
        return flat.reshape(shape)
    out = torch.zeros(flat.numel(), dtype=v.dtype, device=v.device)
    out[placement(plan, K).reshape(-1)] = flat[plan.seg.long()].reshape(-1)
    return out.reshape(shape)


def scatter_add_groups_plain(groups) -> list[Tensor]:
    """:func:`scatter_add_rows_plain` of each ``(values, plan)`` group."""
    return [scatter_add_rows_plain(v, plan) for v, plan in groups]


def scatter_add_groups(groups) -> list[Tensor]:
    """``scatter_add_rows(v, plan)`` of up to :data:`MAX_GROUPS`
    ``(v, plan)`` groups of one dtype, in one launch on CUDA tensors.

    Several outputs are views of one buffer, zeroed by the launch's memset
    where a work list leaves segments out.
    """
    groups = tuple(groups)
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"scatter_add_groups: at most {MAX_GROUPS} groups "
                         f"a launch, got {len(groups)}")
    if not groups:
        return []
    v0 = groups[0][0]
    if v0.is_cpu:
        return scatter_add_groups_plain(groups)
    dtype, dev = v0.dtype, v0.get_device()
    fn = _build.entry("slam_scatter_add_rows", dtype)
    desc, keep, outs = [], [], []
    total, zero, work = 0, False, False
    for v, plan in groups:
        if v.dtype != dtype or v.get_device() != dev \
                or plan.perm.get_device() != dev:
            raise ValueError("scatter_add_groups: values and plans must "
                             f"share one dtype and device ({dtype}, {dev})")
        _check_rows(v, plan)
        if not v.is_contiguous():
            v = v.contiguous()
            keep.append(v)  # alive until the launch is enqueued
        shape, strides, K, cols, w, ld = _layout(plan.n, plan.grid,
                                                 v.shape[1:])
        m = plan.seg.shape[0]
        zero |= m < plan.n
        work |= m * K > 0
        desc += [v.data_ptr(), plan.perm.data_ptr(), plan.starts.data_ptr(),
                 plan.seg.data_ptr(), total, m, K, cols, w, ld]
        outs.append((shape, strides, total))
        total += plan.n * K
    if len(outs) == 1:
        buf = torch.empty(outs[0][0], dtype=dtype, device=v0.device)
        res = [buf]
    else:
        buf = torch.empty(total, dtype=dtype, device=v0.device)
        res = [buf.as_strided(shape, strides, at)
               for shape, strides, at in outs]
    base, size = buf.data_ptr(), buf.element_size()
    for g in range(len(outs)):
        desc[10 * g + 4] = base + size * desc[10 * g + 4]
    if work or zero:
        words = array.array("q", desc)
        _build.check(fn(words.buffer_info()[0], len(outs), base,
                        size * total if zero else 0,
                        _build.stream_ptr(dev)), "scatter_add_rows")
    if work:
        scatter_add_rows.launches += 1
    return res


def scatter_add_rows(v: Tensor, plan: SegmentPlan) -> Tensor:
    """``segment_sum(v[src], idx, n)`` for ``v (M, ...)``, each segment
    summed in plan order; ``(n, ...)``, or the block grid's matrix."""
    return scatter_add_groups(((v, plan),))[0]


scatter_add_rows.launches = 0
