"""Batched micro-panel Cholesky plus the explicit inverse of the factor.

Port of ``slam_tpu/ops/pallas_chol.py::micro_chol_inv``: for ``A`` of shape
``(M, p, p)`` (SPD panels) it returns the lower Cholesky factor ``L`` and
``L^-1``.  The CUDA kernel is ``csrc/chol.cu``: the factor in per-thread
register tiles with one barrier per column, then a right-looking inverse,
a warp per column pair, with no CTA-wide barrier.  :func:`schedule` picks
the launch shape from the batch, ``p``, the dtype and the card's SM
count: while four CTAs a matrix fit the SMs, one launch in which each CTA
factors and inverts its share of the pairs; past that (the folded
batches), the factor in one launch and the inverse in a second one, whose
1024-thread CTAs leave each warp at most two pairs.
:func:`micro_chol_inv_plain` is the same column loop in PyTorch.  Both
follow the TPU kernel's arithmetic: the pivot is ``rsqrt(d_jj)`` times the
column, so a non-SPD panel gives NaN; the inverse is forward substitution,
each entry's sum in four partial sums; the strict upper triangles come out
as exact zeros.

:func:`micro_chol_inv_folded` is the port of the TPU package's
``custom_vmap``-folded wrapper (``micro_chol_inv_folded``), which folds an
outer ``vmap`` axis into the kernel's batch so that one pass serves every
seed: it takes ``A (..., M, p, p)`` and launches the one kernel on the
``(prod(lead) * M, p, p)`` reshape.  The seed batch's blocked factorisation
(``solver/batch.py``) hands it the B*P interiors' panels of each panel
step; at B*P = 96 or 128 the kernel runs the split schedule.

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises, also for a ``p`` beyond what the kernel's
shared memory holds (:func:`max_panel`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from slam_tpu_torch.ops import _build, count_launch
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# Dynamic shared memory a block may opt into on sm_90 (232,448 bytes).
_SMEM_OPTIN = 232448


def max_panel(dtype) -> int:
    """Largest ``p`` the kernel takes: one ``p x (p+1)`` tile plus a
    ``p``-vector of ``dtype`` in shared memory, ``p (p+2)`` elements."""
    size = torch.finfo(dtype).bits // 8
    return math.isqrt(_SMEM_OPTIN // size + 1) - 1


class Schedule(NamedTuple):
    """Launch shape of :func:`micro_chol_inv` (``csrc/chol.cu``)."""

    split: bool           # the inverse in a second launch
    ctas: int             # CTAs a matrix of the (first) launch
    threads: int          # threads a CTA of the (first) launch
    inverse_ctas: int     # CTAs a matrix that invert
    inverse_threads: int  # threads a CTA that invert
    pairs_per_warp: int   # most column pairs one warp walks

    @property
    def kernels(self) -> int:
        """Device kernels a call launches."""
        return 2 if self.split else 1


#: The split inverse's CTA: 32 warps, at most 64 registers a thread.
INVERSE_THREADS = 1024
#: Largest ``p`` the split schedule takes (a lane holds 4 rows of a column).
SPLIT_MAX_PANEL = 128


def schedule(m: int, p: int, dtype, sms: int) -> Schedule:
    """Launch shape for ``m`` panels of ``p x p`` in ``dtype`` on a card
    with ``sms`` SMs.

    While ``4 m <= sms`` (B4's batches of 16 and 32 panels on the H100's
    132 SMs), or for ``p`` above :data:`SPLIT_MAX_PANEL`: one launch of 4,
    2 or 1 CTAs a matrix, the most whose grid fits one wave; each CTA
    factors the whole matrix and inverts its share of the column pairs
    with 512 threads where a thread's 128 registers hold the factor's
    tile (``p <= 128`` in float32, 64 in float64), else 256.  Past that
    (the folded batches): the factor on one 256-thread CTA a matrix, then
    the inverse on 1024-thread CTAs, as many a matrix as one wave holds
    (one a SM) and the pairs can use."""
    pairs = (p + 1) // 2
    if 4 * m <= sms or p > SPLIT_MAX_PANEL:
        ctas = 4 if 4 * m <= sms else (2 if 2 * m <= sms else 1)
        tile = 128 if dtype == torch.float32 else 64
        threads = 512 if p <= tile else 256
        per_warp = -(-pairs // (ctas * threads // 32))
        return Schedule(False, ctas, threads, ctas, threads, per_warp)
    warps = INVERSE_THREADS // 32
    inverse_ctas = max(1, min(sms // m, -(-pairs // warps)))
    return Schedule(True, 1, 256, inverse_ctas, INVERSE_THREADS,
                    -(-pairs // (inverse_ctas * warps)))


_sm_count: dict = {}  # device index -> SM count


def sm_count(index: int) -> int:
    """SMs of CUDA device ``index``, read once."""
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_count[index]


def micro_chol_inv_plain(A: Tensor) -> tuple[Tensor, Tensor]:
    """PyTorch version of the kernel: ``(L, L^-1)`` of ``A (M, p, p)``."""
    p = A.shape[-1]
    T = A.clone()
    L = torch.zeros_like(A)
    for j in range(p):
        col = T[:, j:, j] * torch.rsqrt(T[:, j, j])[:, None]
        L[:, j:, j] = col
        T[:, j + 1:, j + 1:] -= col[:, 1:, None] * col[:, None, 1:]
    X = torch.zeros_like(A)
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    for i in range(p):
        acc = (L[:, i, :i, None] * X[:, :i, :]).sum(dim=1)
        X[:, i, :] = (eye[i] - acc) / L[:, i, i:i + 1]
    return L, X


def micro_chol_inv(A: Tensor) -> tuple[Tensor, Tensor]:
    """Cholesky factor and its inverse of ``A (M, p, p)``; on a CUDA tensor
    the kernel in the shape :func:`schedule` gives (one launch counted a
    call, one or two device kernels).  Only the lower triangle of ``A`` is
    read."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"micro_chol_inv: need (M, p, p), got "
                         f"{tuple(A.shape)}")
    with span("kernel.micro_chol_inv"):
        if A.device.type == "cpu":
            return micro_chol_inv_plain(A)
        return _micro_chol_inv_cuda(A)


def _micro_chol_inv_cuda(A: Tensor) -> tuple[Tensor, Tensor]:
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"micro_chol_inv: float32/float64 only, got "
                        f"{A.dtype}")
    M, p, _ = A.shape
    if p > max_panel(A.dtype):
        raise ValueError(f"micro_chol_inv: p={p} exceeds the kernel's "
                         f"{max_panel(A.dtype)} for {A.dtype}")
    A = A.contiguous()
    L = torch.empty_like(A)
    inv = torch.empty_like(A)
    if M == 0 or p == 0:
        return L, inv
    dev = A.get_device()
    s = schedule(M, p, A.dtype, sm_count(dev))
    fn = _build.entry("slam_micro_chol_inv", A.dtype)
    _build.check(fn(A.data_ptr(), L.data_ptr(), inv.data_ptr(), M, p,
                    s.ctas, s.threads, int(s.split), s.inverse_ctas,
                    s.inverse_threads, _build.stream_ptr(dev)),
                 "micro_chol_inv")
    count_launch("micro_chol_inv")
    return L, inv


def micro_chol_inv_folded(A: Tensor) -> tuple[Tensor, Tensor]:
    """:func:`micro_chol_inv` of ``A (..., M, p, p)`` with every leading
    axis folded into the batch: one launch (counted on
    ``micro_chol_inv``) for all ``prod(lead) * M`` panels on a CUDA
    tensor, the same result as a call per leading index."""
    if A.dim() < 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"micro_chol_inv_folded: need (..., M, p, p), got "
                         f"{tuple(A.shape)}")
    p = A.shape[-1]
    L, inv = micro_chol_inv(A.reshape(-1, p, p))
    return L.reshape(A.shape), inv.reshape(A.shape)
