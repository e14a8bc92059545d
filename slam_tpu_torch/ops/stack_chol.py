"""Cholesky factors of a stack of SPD matrices, every lane in lockstep.

:func:`stack_cholesky` factors each matrix of ``A (B, n, n)`` (its lower
triangle read), optionally Jacobi-scaled first, ``(A_ij d_i) d_j`` with
``d = dscale``, and returns the factors as one column-major stack (the
layout ``cholesky_ex`` gives: ``torch.empty_like(A).mT``, zeros above the
diagonal) and ``(B,)`` int32 infos, LAPACK's: 0 where the lane factored,
else the 1-based order of its first non-positive pivot.

On a CUDA tensor it launches ``csrc/stack_chol.cu``: a right-looking
blocked Cholesky of every lane at once, with a lookahead (the next group
of block steps' column updates, factors and panels on a second stream,
beside the far trailing update), about ``2 ceil(n / nb)`` device kernels
a call (:meth:`Schedule.launches`; ``ops.launch_counts()`` adds the
kernels that the C call reports it launched), whose arithmetic in a lane
depends on that lane alone, so a lane's factor is its matrix's factor
alone to the bit.
The block width and the group of steps that one far update serves come
from the order and the dtype (:func:`schedule`).  On a CPU tensor it
takes the plain version, :func:`stack_cholesky_plain`: ``cholesky_ex`` of
each matrix, one call a matrix (LAPACK there; on a CUDA tensor the same
loop is cuSOLVER's, the yardstick the tools time the kernel against).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from slam_tpu_torch.ops import _build, count_launch
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

#: Smallest order that takes the wide schedule.
WIDE_FROM = 2048


class Schedule(NamedTuple):
    """Launch shape of :func:`stack_cholesky` (``csrc/stack_chol.cu``)."""

    nb: int     # block width
    group: int  # block steps whose panels one wide update applies

    def launches(self, n: int) -> int:
        """Device kernels of one call at order ``n``: the staging pass,
        the factor of the first diagonal block, a panel for each block
        but the last, an update for each further block column (a group's
        columns by the previous group's panels in one of them), and a
        far update for each group but the last two."""
        if not n:
            return 0
        blocks = -(-n // self.nb)
        return 2 * blocks + max(0, -(-blocks // self.group) - 2)


def schedule(n: int, dtype) -> Schedule:
    """Block width and group at order ``n``, from the H100's timings
    (PERF.md): from :data:`WIDE_FROM` on, 128-wide blocks in groups of 3
    in float32 (8 lanes of 3950 and 5217), 64-wide ones in groups of 6
    in float64 (8 lanes of 3684 and 5217; a register tile of 128 doubles
    would not leave the update two CTAs an SM); below it 64-wide blocks
    in groups of 2 (8 lanes of 723 to 1662).  Never from the number of
    lanes: the shape sets each lane's arithmetic, which has to be its
    matrix's alone."""
    if n >= WIDE_FROM:
        return Schedule(128, 3) if dtype == torch.float32 \
            else Schedule(64, 6)
    return Schedule(64, 2)


def _check(A: Tensor, dscale: Tensor | None) -> None:
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"stack_cholesky: need (B, n, n), got "
                         f"{tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stack_cholesky: float32/float64 only, got "
                        f"{A.dtype}")
    if dscale is not None and (dscale.shape != A.shape[:2]
                               or dscale.dtype != A.dtype
                               or dscale.device != A.device):
        raise ValueError(f"stack_cholesky: dscale {tuple(dscale.shape)} "
                         f"{dscale.dtype} {dscale.device} does not match "
                         f"{tuple(A.shape)} {A.dtype} {A.device}")


def stack_cholesky_plain(A: Tensor, dscale: Tensor | None = None
                         ) -> tuple[Tensor, Tensor]:
    """``cholesky_ex`` of each (scaled) matrix of the stack, one call a
    matrix, into one column-major stack of factors and ``(B,)`` infos."""
    Hs = A if dscale is None else A * dscale[..., :, None] \
        * dscale[..., None, :]
    L = torch.empty_like(Hs).mT
    info = torch.empty(Hs.shape[0], dtype=torch.int32, device=Hs.device)
    for k in range(Hs.shape[0]):
        torch.linalg.cholesky_ex(Hs[k], out=(L[k], info[k]))
    return L, info


def stack_cholesky(A: Tensor, dscale: Tensor | None = None
                   ) -> tuple[Tensor, Tensor]:
    """Lower Cholesky factors and infos of the stack ``A (B, n, n)``,
    each matrix scaled to ``(A_ij d_i) d_j`` first where ``dscale (B, n)``
    is given; the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    _check(A, dscale)
    with span("kernel.stack_cholesky"):
        if A.device.type == "cpu":
            return stack_cholesky_plain(A, dscale)
        return _stack_cholesky_cuda(A, dscale,
                                    schedule(A.shape[-1], A.dtype))


def _stack_cholesky_cuda(A: Tensor, dscale: Tensor | None, s: Schedule
                         ) -> tuple[Tensor, Tensor]:
    B, n, _ = A.shape
    if A.stride(-1) != 1:
        A = A.contiguous()
    if dscale is not None:
        dscale = dscale.contiguous()
    L = torch.empty((B, n, n), dtype=A.dtype, device=A.device).mT
    info = torch.empty(B, dtype=torch.int32, device=A.device)
    if B == 0 or n == 0:
        info.zero_()
        return L, info
    dev = A.get_device()
    fn = _build.entry("slam_stack_cholesky", A.dtype)
    kernels = ctypes.c_int(0)
    rc = fn(A.data_ptr(), A.stride(1), A.stride(0),
            None if dscale is None else dscale.data_ptr(), L.data_ptr(),
            info.data_ptr(), B, n, s.nb, s.group, ctypes.addressof(kernels),
            _build.stream_ptr(dev))
    count_launch("stack_cholesky", kernels.value)
    _build.check(rc, "stack_cholesky")
    return L, info
