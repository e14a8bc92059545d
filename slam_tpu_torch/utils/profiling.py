"""Profiling: the program's stage spans and a trace for TensorBoard.

* :func:`span` -- a ``torch.profiler.record_function`` range named
  ``slam/<name>`` around one stage of the work (the LM loop's iteration
  and its steps, the dense and Schur solves' stages, each hand-written
  kernel's wrapper), on the profiler's clock, so that a trace places each
  device operation's launch, and each idle gap, inside the innermost span
  the host was in.  Spans nest; the outermost span of a request is
  ``slam/lm.solve``.  Live only inside :func:`tracing`: outside it a span
  costs one flag check and builds no profiler object.
* :func:`tracing` -- turns the spans on for its block.
* :data:`SPANS` -- every span's name as a trace shows it.
* :func:`trace` -- a ``torch.profiler`` session (CPU and, where there is
  one, CUDA activity) that writes a TensorBoard-loadable trace into a
  directory.

The spans stay in the profiler's memory and are written out only when
its session ends; the program writes no file of its own.  A profiler
session leaves the later host-bound calls of its process slower
(measured on the H100, ``PERF.md``), so make a profiled run the last one
of its process.
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "slam/"
#: Every span the program opens, as a trace names it.
SPANS = tuple(PREFIX + name for name in (
    "lm.solve", "lm.iteration", "lm.linearize", "lm.linear_solve",
    "lm.retract_cost",
    "dense.assemble", "dense.factor", "dense.substitute", "sc.eliminate",
    "schur.assemble", "schur.interiors", "schur.separator",
    "schur.back_substitute",
    "kernel.gather_rows", "kernel.scatter_add_rows",
    "kernel.fused_linearize_se2", "kernel.micro_chol_inv",
    "kernel.stack_cholesky"))

_on = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range ``slam/<name>`` while :func:`tracing` is on; otherwise a
    shared context that does nothing."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def tracing():
    """The program's spans on inside the block (and as they were after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` trace of everything inside the block, with the
    program's spans on, written into ``logdir`` as
    ``<worker>.<time>.pt.trace.json`` when the block ends.  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        with tracing():
            yield prof
