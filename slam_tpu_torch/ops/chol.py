"""Batched micro-panel Cholesky plus the explicit inverse of the factor.

Port of ``slam_tpu/ops/pallas_chol.py::micro_chol_inv``: for ``A`` of shape
``(M, p, p)`` (SPD panels) it returns the lower Cholesky factor ``L`` and
``L^-1`` in one launch.  The CUDA kernel is ``csrc/chol.cu``: up to four
CTAs per matrix, each with the factor in per-thread register tiles and one
barrier per column, then a right-looking inverse, a warp per column, with
no CTA-wide barrier; the kernel picks its launch shape from ``p``, the
dtype and the batch.  :func:`micro_chol_inv_plain` is the same
column loop in PyTorch.  Both follow the TPU kernel's arithmetic: the pivot
is ``rsqrt(d_jj)`` times the column, so a non-SPD panel gives NaN; the
inverse is forward substitution, each entry's sum in four partial sums;
the strict upper triangles come out as exact zeros.

:func:`micro_chol_inv_folded` is the port of the TPU package's
``custom_vmap``-folded wrapper (``micro_chol_inv_folded``), which folds an
outer ``vmap`` axis into the kernel's batch so that one pass serves every
seed: it takes ``A (..., M, p, p)`` and launches the one kernel on the
``(prod(lead) * M, p, p)`` reshape.  The seed batch's blocked factorisation
(``solver/batch.py``) hands it the B*P interiors' panels of each panel
step; at B*P = 128 the kernel takes one CTA a matrix.

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
launches the kernel or raises, also for a ``p`` beyond what the kernel's
shared memory holds (:func:`max_panel`).
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.ops import _build

Tensor = torch.Tensor

# Dynamic shared memory a block may opt into on sm_90 (232,448 bytes).
_SMEM_OPTIN = 232448


def max_panel(dtype) -> int:
    """Largest ``p`` the kernel takes: one ``p x (p+1)`` tile plus a
    ``p``-vector of ``dtype`` in shared memory, ``p (p+2)`` elements."""
    size = torch.finfo(dtype).bits // 8
    return math.isqrt(_SMEM_OPTIN // size + 1) - 1


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
    """Cholesky factor and its inverse of ``A (M, p, p)``, in one launch on
    a CUDA tensor.  Only the lower triangle of ``A`` is read."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"micro_chol_inv: need (M, p, p), got "
                         f"{tuple(A.shape)}")
    if A.device.type == "cpu":
        return micro_chol_inv_plain(A)
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
    fn = _build.entry("slam_micro_chol_inv", A.dtype)
    _build.check(fn(A.data_ptr(), L.data_ptr(), inv.data_ptr(), M, p,
                    _build.stream_ptr(A.get_device())), "micro_chol_inv")
    micro_chol_inv.launches += 1
    return L, inv


micro_chol_inv.launches = 0


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
