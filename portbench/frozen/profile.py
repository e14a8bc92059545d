"""Reading a torch.profiler window: kernel events, their launches, busy
time and idle gaps.

The arithmetic of ``slam_tpu_torch/tools/profile_lm.py`` at commit
407e87e (kernel events counted as launches, their device time summed,
device time over wall time as the busy share), with both times taken from
one traced window: ``profile_lm`` divided the device time of a profiled
window by the wall of another, unprofiled one.  Busy time here is the
union of the kernel intervals, so overlapping kernels count once.
"""

from __future__ import annotations

from typing import NamedTuple

#: Runtime calls that put work on the device; a kernel's launch is the
#: runtime event that shares its correlation id.
LAUNCH_PREFIXES = ("cuda", "cu")


class Kernel(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    launch_ns: int | None   # host time of the runtime call that launched it


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class HostOp(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Window(NamedTuple):
    """What a traced window holds, in nanoseconds of one clock."""

    start_ns: int
    end_ns: int
    kernels: list          # [Kernel], device events, sorted by start
    spans: list            # [Span], the benchmark's record_function ranges
    host_ops: list         # [HostOp], host operators (for idle gaps)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def read_events(events, start_ns: int, end_ns: int,
                span_names: tuple) -> Window:
    """A :class:`Window` from the profiler's Kineto events (``prof.
    profiler.kineto_results.events()``) between ``start_ns`` and
    ``end_ns``."""
    launches, device, spans, ops = {}, [], [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            # the device timeline's copies of the host's ranges are no
            # work of the device
            if e.is_user_annotation() or name in span_names:
                continue
            device.append((name, t0, t1, e.correlation_id(),
                           e.linked_correlation_id()))
        elif name in span_names:
            spans.append(Span(name, t0, t1))
        elif name.startswith(LAUNCH_PREFIXES):
            launches[e.correlation_id()] = t0
        elif not e.is_user_annotation():
            ops.append(HostOp(name, t0, t1))
    kernels = []
    for name, t0, t1, corr, linked in device:
        if t1 <= start_ns or t0 >= end_ns:
            continue
        launch = launches.get(linked) if linked else None
        if launch is None:
            launch = launches.get(corr)
        kernels.append(Kernel(name, t0, t1, launch))
    kernels.sort(key=lambda k: k.start_ns)
    ops.sort(key=lambda o: o.start_ns)
    return Window(start_ns, end_ns, kernels, spans, ops)


def busy_intervals(w: Window) -> list[tuple[int, int]]:
    """The union of the kernel intervals, clipped to the window."""
    out = []
    for k in w.kernels:
        a, b = max(k.start_ns, w.start_ns), min(k.end_ns, w.end_ns)
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def busy_seconds(w: Window) -> float:
    return sum(b - a for a, b in busy_intervals(w)) / 1e9


def idle_gaps(w: Window) -> list[tuple[int, int]]:
    """The stretches of the window in which no kernel ran."""
    gaps, t = [], w.start_ns
    for a, b in busy_intervals(w):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w.end_ns > t:
        gaps.append((t, w.end_ns))
    return gaps


def host_op_over(w: Window, a: int, b: int) -> str:
    """The host operator that covers most of ``[a, b)`` (the outermost
    of those that overlap it most), or "host" when none does."""
    best, best_ns = "host", 0
    for op in w.host_ops:
        if op.start_ns >= b:
            break
        ov = min(op.end_ns, b) - max(op.start_ns, a)
        if ov > best_ns:
            best, best_ns = op.name, ov
    return best


def device_seconds_by_name(w: Window) -> dict[str, float]:
    out: dict[str, float] = {}
    for k in w.kernels:
        out[k.name] = out.get(k.name, 0.0) + (k.end_ns - k.start_ns) / 1e9
    return out


def span_device_seconds(w: Window, name: str) -> float | None:
    """Device seconds of the kernels launched inside the spans ``name``;
    None when the window has no such span or no kernel's launch is
    known."""
    ranges = sorted((s.start_ns, s.end_ns) for s in w.spans if s.name == name)
    if not ranges or not any(k.launch_ns is not None for k in w.kernels):
        return None
    import bisect
    starts = [r[0] for r in ranges]
    total = 0
    for k in w.kernels:
        if k.launch_ns is None:
            continue
        i = bisect.bisect_right(starts, k.launch_ns) - 1
        if i >= 0 and k.launch_ns <= ranges[i][1]:
            total += k.end_ns - k.start_ns
    return total / 1e9
