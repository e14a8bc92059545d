"""Profiling and timing utilities.

Port of ``slam_tpu/utils/profiling.py``:

* :class:`Timer` -- wall-clock section timing that synchronises the CUDA
  device of a given tensor, so asynchronous launches do not lie;
* :func:`trace` -- a ``torch.profiler`` session (CPU and, where there is
  one, CUDA activity) that writes a TensorBoard-loadable trace into a
  directory;
* :func:`iteration_rate` -- steady-state calls per second of a solve
  closure, the device synchronised around each call.

A profiler session leaves the later host-bound calls of its process
slower (measured on the H100, ``PERF.md``), so make a profiled run the
last one of its process.
"""

from __future__ import annotations

import contextlib
import time

import torch


def synchronize(tree) -> None:
    """Wait for the CUDA devices of every tensor in ``tree`` (a tensor or
    a nest of tuples, lists, dicts and NamedTuples); CPU tensors need
    nothing."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.sections[name] = (
                self.sections.get(name, 0.0) + time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.sections.values()) or 1.0
        lines = ["[timing]"]
        for name, dt in sorted(
            self.sections.items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"  {name:<30s} {dt:8.3f}s  {100*dt/total:5.1f}%")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of everything inside the block, written
    into ``logdir`` as ``<worker>.<time>.pt.trace.json`` when the block
    ends.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def iteration_rate(fn, *args, reps: int = 3, iters_per_call: int = 1):
    """Best-of-``reps`` steady-state call rate of ``fn(*args)``, the CUDA
    device synchronised before and after each call.  Returns
    (iters_per_second, best_wall_s)."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    fn(*args)  # warm-up
    best = float("inf")
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return iters_per_call / best, best
