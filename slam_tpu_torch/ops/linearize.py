"""Fused SE(2) edge linearisation.

Port of ``slam_tpu/ops/pallas_linearize.py::fused_linearize_se2``: the
whole per-edge chain (residual, gauge-masked Jacobians, DCS with its chain
rule, Huber weight, weighted H blocks and gradients) in one pass.  The
CUDA kernel is ``csrc/linearize_se2.cu``; :func:`fused_linearize_se2_plain`
is the same arithmetic in PyTorch.  The wrapper takes the plain version
for CPU tensors only; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from slam_tpu_torch.ops import _build

Tensor = torch.Tensor

_BLOCKS = ("Ja", "Jb", "Haa", "Hbb", "Hoff")
_VECS = ("e", "ga", "gb")
_SCALARS = ("w", "rho")


def fused_linearize_se2_plain(
    pa, pb, meas, free_a, free_b, loop_f, active,
    phi: float, delta: float, robust: str = "none",
) -> dict[str, Tensor]:
    """PyTorch version of the kernel; same inputs and outputs."""
    _check_robust(robust)
    pa_x, pa_y, pa_t = pa.unbind(-1)
    pb_x, pb_y, pb_t = pb.unbind(-1)
    m_x, m_y, m_t = meas.unbind(-1)
    fa, fb = free_a, free_b
    ca, sa = torch.cos(pa_t), torch.sin(pa_t)
    cm, sm = torch.cos(m_t), torch.sin(m_t)
    dx = pb_x - pa_x
    dy = pb_y - pa_y
    vx = ca * dx + sa * dy - m_x
    vy = -sa * dx + ca * dy - m_y
    e0 = cm * vx + sm * vy
    e1 = -sm * vx + cm * vy
    dt = pb_t - pa_t - m_t
    e2 = torch.asin(torch.clamp(torch.sin(dt), -1.0, 1.0))
    cma = torch.cos(m_t + pa_t)
    sma = torch.sin(m_t + pa_t)
    gx = -sa * dx + ca * dy
    gy = -ca * dx - sa * dy
    ht_x = cm * gx + sm * gy
    ht_y = -sm * gx + cm * gy
    sgn = torch.sign(torch.cos(dt))
    zero = torch.zeros_like(e0)
    ja = [-cma * fa, -sma * fa, ht_x * fa,
          sma * fa, -cma * fa, ht_y * fa,
          zero, zero, -sgn * fa]
    jb = [cma * fb, sma * fb, zero,
          -sma * fb, cma * fb, zero,
          zero, zero, sgn * fb]
    e = [e0, e1, e2]
    if robust == "dcs":
        r2 = e0 * e0 + e1 * e1
        psi_raw = torch.sqrt(2.0 * phi / (phi + r2))
        act = psi_raw < 1.0
        psi = torch.where(act, psi_raw, torch.ones_like(psi_raw))
        dpsi = torch.where(act, -psi / (2.0 * (phi + r2)), zero)
        psi = loop_f * psi + (1.0 - loop_f)
        dpsi = loop_f * dpsi

        def scale(j):
            dr = [2.0 * (e0 * j[c] + e1 * j[3 + c]) for c in range(3)]
            return [psi * j[3 * r + c] + e[r] * dpsi * dr[c]
                    for r in range(3) for c in range(3)]

        ja, jb = scale(ja), scale(jb)
        e = [psi * e0, psi * e1, psi * e2]
    s2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    d2 = delta * delta
    safe = torch.sqrt(torch.clamp(s2, min=d2))
    quad = s2 <= d2
    w = torch.where(quad, torch.ones_like(s2), delta / safe) * active
    rho = torch.where(quad, s2, 2.0 * delta * safe - d2) * active

    def prod(x, y):
        return torch.stack(
            [w * (x[r] * y[c] + x[3 + r] * y[3 + c] + x[6 + r] * y[6 + c])
             for r in range(3) for c in range(3)], dim=-1).reshape(-1, 3, 3)

    def grad(x):
        return torch.stack(
            [w * (x[r] * e[0] + x[3 + r] * e[1] + x[6 + r] * e[2])
             for r in range(3)], dim=-1)

    return {
        "e": torch.stack(e, dim=-1),
        "Ja": torch.stack(ja, dim=-1).reshape(-1, 3, 3),
        "Jb": torch.stack(jb, dim=-1).reshape(-1, 3, 3),
        "Haa": prod(ja, ja),
        "Hbb": prod(jb, jb),
        "Hoff": prod(ja, jb),
        "ga": grad(ja),
        "gb": grad(jb),
        "w": w,
        "rho": rho,
    }


def _check_robust(robust: str) -> None:
    if robust not in ("none", "dcs"):
        raise ValueError(f"fused linearisation takes none/dcs, not {robust!r}")


def fused_linearize_se2(
    pa, pb, meas, free_a, free_b, loop_f, active,
    phi: float, delta: float, robust: str = "none",
) -> dict[str, Tensor]:
    """Per-edge linearisation; inputs ``(E,3)``/``(E,)``, outputs ``e``,
    ``ga``, ``gb`` (E,3), ``Ja``/``Jb``/``Haa``/``Hbb``/``Hoff`` (E,3,3),
    ``w``, ``rho`` (E,) -- the dict layout of the JAX kernel."""
    if pa.device.type == "cpu":
        return fused_linearize_se2_plain(pa, pb, meas, free_a, free_b,
                                         loop_f, active, phi, delta, robust)
    _check_robust(robust)
    E = pa.shape[0]
    dtype, dev = pa.dtype, pa.device
    ins = (pa, pb, meas, free_a, free_b, loop_f, active)
    for k, t in enumerate(ins):
        want = (E, 3) if k < 3 else (E,)
        if tuple(t.shape) != want or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_linearize_se2: input {k} must be contiguous "
                f"{want} {dtype} on {dev}, got {tuple(t.shape)} {t.dtype} "
                f"on {t.device}")
    out = {k: torch.empty((E, 3), dtype=dtype, device=dev) for k in _VECS}
    out.update({k: torch.empty((E, 3, 3), dtype=dtype, device=dev)
                for k in _BLOCKS})
    out.update({k: torch.empty((E,), dtype=dtype, device=dev)
                for k in _SCALARS})
    fn = _build.entry("slam_linearize_se2", dtype)
    order = ("e", "Ja", "Jb", "Haa", "Hbb", "Hoff", "ga", "gb", "w", "rho")
    _build.check(fn(*(t.data_ptr() for t in ins), float(phi), float(delta),
                    int(robust == "dcs"),
                    *(out[k].data_ptr() for k in order), E,
                    _build.stream_ptr(dev.index)),
                 "fused_linearize_se2")
    fused_linearize_se2.launches += 1
    return out


fused_linearize_se2.launches = 0
