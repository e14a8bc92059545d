"""Fused SE(2) edge linearisation.

Port of ``slam_tpu/ops/pallas_linearize.py::fused_linearize_se2``: the
whole per-edge chain (residual, gauge-masked Jacobians, DCS with its chain
rule, Huber weight, weighted H blocks and gradients) in one pass.  The
CUDA kernel is ``csrc/linearize_se2.cu``; :func:`fused_linearize_se2_plain`
is the same arithmetic in PyTorch.

Two entries launch the one kernel (and count as
``fused_linearize_se2`` in ``ops.launch_counts()``):

- :func:`fused_linearize_se2` takes the gathered endpoints, the JAX
  kernel's signature (the tests and the comparison with ``slam_tpu``);
- :func:`fused_linearize_se2_indexed` takes the poses, the free mask and an
  ``EdgeSet``, and the kernel reads the endpoints itself: the solver's
  linearisation makes no gather launch.  The ``EdgeSet`` holds the float
  loop mask the kernel reads (``loop_f``, made with it), so a call converts
  nothing; it checks every tensor the kernel reads.

Both return views of one field-major buffer, each field contiguous.  The
wrappers take the plain versions for CPU tensors only; CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from slam_tpu_torch.ops import _build, count_launch
from slam_tpu_torch.ops.gather import gather_rows_plain
from slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

# The output fields in the kernel's buffer order, with their trailing shape.
_FIELDS = (("e", (3,)), ("Ja", (3, 3)), ("Jb", (3, 3)), ("Haa", (3, 3)),
           ("Hbb", (3, 3)), ("Hoff", (3, 3)), ("ga", (3,)), ("gb", (3,)),
           ("w", ()), ("rho", ()))
_WIDTHS = tuple(math.prod(shape) for _, shape in _FIELDS)
_VALUES = sum(_WIDTHS)  # 56 per edge
_OFFSETS = tuple(sum(_WIDTHS[:k]) for k in range(len(_FIELDS)))
# Row-major strides of each field's (E, *shape) view.
_STRIDES = tuple(tuple(math.prod(shape[k:]) for k in range(len(shape) + 1))
                 for _, shape in _FIELDS)


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


def _outputs(E: int, dtype, device) -> dict[str, Tensor]:
    """The ten outputs as views of one field-major buffer (one
    ``as_strided`` each: half the host time of a split and ten views)."""
    buf = torch.empty(_VALUES * E, dtype=dtype, device=device)
    return {name: buf.as_strided((E, *shape), strides, off * E)
            for (name, shape), strides, off in zip(_FIELDS, _STRIDES,
                                                   _OFFSETS)}


def _launch(name: str, dtype, dev, args, robust, phi, delta, out, E):
    """One launch into the buffer of ``out`` (``e`` is its first field)."""
    fn = _build.entry(name, dtype)
    _build.check(fn(*args, float(phi), float(delta), int(robust == "dcs"),
                    out["e"].data_ptr(), E, _build.stream_ptr(dev.index)),
                 "fused_linearize_se2")
    count_launch("fused_linearize_se2")


def fused_linearize_se2(
    pa, pb, meas, free_a, free_b, loop_f, active,
    phi: float, delta: float, robust: str = "none",
) -> dict[str, Tensor]:
    """Per-edge linearisation; inputs ``(E,3)``/``(E,)``, outputs ``e``,
    ``ga``, ``gb`` (E,3), ``Ja``/``Jb``/``Haa``/``Hbb``/``Hoff`` (E,3,3),
    ``w``, ``rho`` (E,) -- the dict layout of the JAX kernel."""
    with span("kernel.fused_linearize_se2"):
        if pa.device.type == "cpu":
            return fused_linearize_se2_plain(pa, pb, meas, free_a, free_b,
                                             loop_f, active, phi, delta,
                                             robust)
        return _fused_linearize_se2_cuda(pa, pb, meas, free_a, free_b,
                                         loop_f, active, phi, delta, robust)


def _fused_linearize_se2_cuda(pa, pb, meas, free_a, free_b, loop_f, active,
                              phi, delta, robust):
    _check_robust(robust)
    E = pa.shape[0]
    dtype, dev = pa.dtype, pa.device
    ins = (pa, pb, meas, free_a, free_b, loop_f, active)
    for k, t in enumerate(ins):
        _check_input(f"input {k}", t, (E, 3) if k < 3 else (E,), dtype, dev)
    out = _outputs(E, dtype, dev)
    if E:
        _launch("slam_linearize_se2", dtype, dev,
                [t.data_ptr() for t in ins], robust, phi, delta, out, E)
    return out


def _check_input(what: str, t: Tensor, shape: tuple, dtype, dev) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_linearize_se2: {what} must be contiguous {shape} "
            f"{dtype} on {dev}, got {tuple(t.shape)} {t.dtype} on "
            f"{t.device}")


def fused_linearize_se2_indexed_plain(
    poses, free_node, ab, meas, loop_f, active,
    phi: float, delta: float, robust: str = "none",
) -> dict[str, Tensor]:
    """PyTorch version of the indexed entry: the endpoints gathered with
    ``index_select``, then :func:`fused_linearize_se2_plain`."""
    E = meas.shape[0]
    pa, pb = gather_rows_plain(poses, ab).split(E)
    fa, fb = gather_rows_plain(free_node, ab).split(E)
    return fused_linearize_se2_plain(pa, pb, meas, fa, fb, loop_f, active,
                                     phi, delta, robust)


def fused_linearize_se2_indexed(
    poses, free_node, edges, phi: float, delta: float, robust: str = "none",
) -> dict[str, Tensor]:
    """:func:`fused_linearize_se2` of the edges of ``edges`` (an
    ``EdgeSet``) at ``poses (N, 3)`` with the free mask ``free_node (N,)``;
    the kernel reads the endpoints itself."""
    _check_robust(robust)
    with span("kernel.fused_linearize_se2"):
        if poses.device.type == "cpu":
            return fused_linearize_se2_indexed_plain(
                poses, free_node, edges.ab, edges.meas, edges.loop_f,
                edges.active, phi, delta, robust)
        return _fused_linearize_se2_indexed_cuda(poses, free_node, edges,
                                                 phi, delta, robust)


def _fused_linearize_se2_indexed_cuda(poses, free_node, edges, phi, delta,
                                      robust):
    E, N = edges.num_edges, edges.num_nodes
    dtype, dev = poses.dtype, poses.device
    ins = {"poses": (poses.contiguous(), (N, 3), dtype),
           "free": (free_node.contiguous(), (N,), dtype),
           "ab": (edges.ab, (2 * E,), torch.int32),
           "meas": (edges.meas, (E, 3), dtype),
           "loop_f": (edges.loop_f, (E,), dtype),
           "active": (edges.active, (E,), dtype)}
    for what, (t, shape, t_dtype) in ins.items():
        _check_input(what, t, shape, t_dtype, dev)
    out = _outputs(E, dtype, dev)
    if E:
        _launch("slam_linearize_se2_indexed", dtype, dev,
                [t.data_ptr() for t, _, _ in ins.values()], robust, phi,
                delta, out, E)
    return out
