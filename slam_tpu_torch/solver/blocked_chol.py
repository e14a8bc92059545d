"""Panel-blocked batched Cholesky and triangular solves.

Port of ``slam_tpu/solver/blocked_chol.py``, whole.  A right-looking
blocked Cholesky of batched SPD matrices ``(..., n, n)``: per panel of
width ``p``, the diagonal block's factor and explicit inverse, one matmul
for the column below it and one for the trailing update.  The forward and
backward substitutions then use the stored panel inverses, one matmul per
panel step.  ``schur_solve(blocked=True)`` runs the interiors and the
separator through it (``SolverConfig.schur_blocked``).

The diagonal panel's factor and inverse are the native
``torch.linalg.cholesky_ex`` and ``solve_triangular``, or, with
``pallas_micro`` (``SolverConfig.schur_pallas_micro``), the
``micro_chol_inv`` kernel: one launch for every matrix of the batch, in
float32 without inner blocking.  The JAX package also asks for a batch of
at least 8, since a smaller one leaves most of the TPU kernel's lanes
idle; the CUDA kernel gives each matrix its own CTAs, so the port takes
any batch (the sphere2500 interiors are 4).  A panel that is not SPD
factors to NaN on either route, as ``jnp.linalg.cholesky`` does, so the
LM loop rejects the step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_tpu_torch.ops.chol import micro_chol_inv

Tensor = torch.Tensor


class BlockedCholesky(NamedTuple):
    """Factorisation: the full lower factor and the per-panel inverses."""

    L: Tensor               # (..., n_pad, n_pad) lower
    inv_diag: list[Tensor]  # (..., p, p) inverse of each diagonal panel
    panel: int
    n: int                  # original (unpadded) size


def _chol_panel(a: Tensor) -> Tensor:
    """Cholesky of the (..., p, p) diagonal panel; NaN where it fails."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def eye_like(a: Tensor) -> Tensor:
    """The identity broadcast to the shape of ``a`` (..., n, n)."""
    return torch.eye(a.shape[-1], dtype=a.dtype,
                     device=a.device).expand(a.shape)


def _inv_lower_panel(l: Tensor) -> Tensor:
    """Explicit inverse of the (..., p, p) lower-triangular panel."""
    return torch.linalg.solve_triangular(l, eye_like(l), upper=False)


def _panel_factor(a: Tensor, inner: int,
                  pallas_micro: bool = False) -> tuple[Tensor, Tensor]:
    """Cholesky and explicit inverse of one (..., p, p) diagonal panel.

    ``pallas_micro`` takes the ``micro_chol_inv`` kernel for float32
    panels without inner blocking (the separator's factor never asks for
    it).  ``inner > 0`` factors the panel itself by ``inner``-wide blocks
    and builds its inverse by panel forward substitution against the
    identity.
    """
    p = a.shape[-1]
    if pallas_micro and a.dtype == torch.float32 and not inner:
        L, inv = micro_chol_inv(a.reshape(-1, p, p))
        return L.reshape(a.shape), inv.reshape(a.shape)
    if not inner or p <= inner or p % inner:
        L = _chol_panel(a)
        return L, _inv_lower_panel(L)
    fac = blocked_cholesky(a, panel=inner)  # p % inner == 0: no padding
    return fac.L, solve_lower(fac, eye_like(a))


def blocked_cholesky(A: Tensor, panel: int = 16, inner: int = 0,
                     pallas_micro: bool = False) -> BlockedCholesky:
    """Right-looking blocked Cholesky of batched SPD matrices (..., n, n).

    Pads to a multiple of ``panel`` with an identity block (benign for SPD;
    padded rows and columns stay zero in solves)."""
    n = A.shape[-1]
    p = panel
    lead = A.shape[:-2]
    n_pad = -(-n // p) * p
    if n_pad != n:
        padded = torch.zeros(lead + (n_pad, n_pad), dtype=A.dtype,
                             device=A.device)
        padded[..., :n, :n] = A
        padded[..., n:, n:] = torch.eye(n_pad - n, dtype=A.dtype,
                                        device=A.device)
        A = padded

    T = A
    col_blocks = []
    inv_diag = []
    for i in range(n_pad // p):
        L11, inv11 = _panel_factor(T[..., :p, :p], inner, pallas_micro)
        inv_diag.append(inv11)
        L21 = T[..., p:, :p] @ inv11.transpose(-1, -2)
        col_blocks.append(torch.cat(
            [torch.zeros(lead + (i * p, p), dtype=A.dtype, device=A.device),
             L11, L21], dim=-2))
        T = T[..., p:, p:] - L21 @ L21.transpose(-1, -2)
    return BlockedCholesky(torch.cat(col_blocks, dim=-1), inv_diag, p, n)


def _pad_rhs(fac: BlockedCholesky, B: Tensor) -> tuple[Tensor, bool]:
    n_pad = fac.L.shape[-1]
    vec = B.dim() == fac.L.dim() - 1
    if vec:
        B = B[..., None]
    if n_pad != fac.n:
        B = torch.cat([B, torch.zeros(B.shape[:-2] + (n_pad - fac.n,
                                                      B.shape[-1]),
                                      dtype=B.dtype, device=B.device)],
                      dim=-2)
    return B, vec


def solve_lower(fac: BlockedCholesky, B: Tensor) -> Tensor:
    """Solve ``L Y = B`` by panel forward substitution (padded shapes)."""
    p = fac.panel
    ys = []
    for i in range(fac.L.shape[-1] // p):
        s = i * p
        rhs = B[..., s:s + p, :]
        if i:
            rhs = rhs - fac.L[..., s:s + p, :s] @ torch.cat(ys, dim=-2)
        ys.append(fac.inv_diag[i] @ rhs)
    return torch.cat(ys, dim=-2)


def solve_lower_t(fac: BlockedCholesky, Y: Tensor) -> Tensor:
    """Solve ``L^T X = Y`` by panel backward substitution."""
    p = fac.panel
    xs: list[Tensor] = []
    for i in range(fac.L.shape[-1] // p - 1, -1, -1):
        s = i * p
        rhs = Y[..., s:s + p, :]
        if xs:
            # Rows below panel i of column block i: L[s+p:, s:s+p]^T X.
            rhs = rhs - (fac.L[..., s + p:, s:s + p].transpose(-1, -2)
                         @ torch.cat(xs, dim=-2))
        xs.insert(0, fac.inv_diag[i].transpose(-1, -2) @ rhs)
    return torch.cat(xs, dim=-2)


def cho_solve_blocked(fac: BlockedCholesky, B: Tensor) -> Tensor:
    """Solve ``L L^T X = B`` (accepts (..., n) or (..., n, k))."""
    Bp, vec = _pad_rhs(fac, B)
    X = solve_lower_t(fac, solve_lower(fac, Bp))[..., :fac.n, :]
    return X[..., 0] if vec else X
