"""The traced window of a ``--trace 1`` run and what is read from it.

A fixed number of requests (the traffic's ``trace_solves``) run back to
back under ``torch.profiler`` (CPU and CUDA activities) inside one range,
with the per-layer spans and the kernel-call ranges of
``portbench/program.py`` on; the window is that range.  A whole
``--seconds`` window would hold millions of device events.
"""

from __future__ import annotations

import time

import torch

from portbench import program
from portbench.frozen import profile, work

WINDOW_SPAN = "portbench_window"


def traced_window(prog: program.Program, solves: int, sync):
    """``(answers, seconds of each request, profile.Window, kernel
    calls)`` of ``solves`` requests under the profiler; ``sync()`` waits
    for the device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    answers, times, calls = [], [], []
    with program.spans(), program.kernel_calls(calls, describe):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                for _ in range(solves):
                    t0 = time.perf_counter()
                    answers.append(prog.entry())
                    sync()
                    times.append(time.perf_counter() - t0)
    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == WINDOW_SPAN
            and not str(e.device_type()).endswith("CUDA")]
    if not span:
        raise RuntimeError("the traced window's range is not in the trace")
    start = span[0].start_ns()
    end = start + span[0].duration_ns()
    names = tuple(program.SPANS.values()) + (program.KERNEL_SPAN,
                                             WINDOW_SPAN)
    return answers, times, profile.read_events(events, start, end,
                                               names), calls


def describe(name: str, args: tuple) -> tuple:
    """What a hand-written kernel's call works on, without its tensors:
    ``(name, dtype, spec)``, ``spec`` the frozen work formula's
    arguments."""
    if name == "gather_rows":
        x, idx = args[:2]
        return (name, x.dtype, (x.shape[0], x[:1].numel() * x.element_size(),
                                idx.numel(), idx.element_size()))
    if name == "scatter_add_groups":
        return (name, args[0][0][0].dtype,
                tuple((tuple(v.shape), v.element_size(), p)
                      for v, p in args[0]))
    if name == "fused_linearize_se2_indexed":
        poses, free, edges = args[:3]
        return (name, poses.dtype,
                (poses.numel() * poses.element_size(),
                 free.numel() * free.element_size(), edges,
                 poses.element_size()))
    A = args[0]
    return (name, A.dtype, (tuple(A.shape), A.element_size()))


def _work(name: str, spec) -> tuple[float, float]:
    if name == "gather_rows":
        return work.gather_work(*spec)
    if name == "scatter_add_groups":
        # one launch: its groups' bytes and operations together
        counts = [work.scatter_work(*g) for g in spec]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)
    if name == "fused_linearize_se2_indexed":
        return work.linearize_work(*spec)
    return work.chol_work(*spec)


def kernel_bound_seconds(calls, peaks) -> float:
    """The least seconds of the recorded hand-written kernel calls
    (:func:`describe`), each call's bytes and operations by the frozen
    work formulas."""
    cache: dict = {}
    total = 0.0
    for name, dtype, spec in calls:
        key = (name, dtype, tuple(id(x) if not isinstance(x, (int, tuple))
                                  else x for x in spec))
        if key not in cache:
            cache[key] = work.bound_s(peaks, dtype, *_work(name, spec))
        total += cache[key]
    return total
