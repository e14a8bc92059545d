"""The program's own stage spans in a traced window, and what is read from
them: device time and launches by stage, host time by stage, and how much
of the device's idle time the host caused.

    python3 -m portbench.stages --workload <cell> --seed <n> \\
        [--traffic <mix>] [--pairs 2] [--out stages.jsonl]

Builds the cell (its traffic, or ``--traffic``'s mix on the cell's
configuration) as ``portbench/run.py`` does, throws away one traced
request (the process's first profiler session), then runs traced windows of
the traffic's ``trace_solves`` requests in turns, the program's spans off
and on (off, on, on, off, ...), each with the benchmark's own spans and
kernel ranges of ``portbench/program.py``, and prints one JSON line a
window: the cell's per-layer metrics as ``portbench/run.py`` reads them,
the readings below, and the requests' walls.  The benchmark's runs do not
run this: their window (``portbench/trace.py``) keeps only the
benchmark's span names and runs with the program's spans off.

The program's spans are ``slam_tpu_torch.utils.profiling.SPANS``, live
inside ``profiling.tracing()``; a program without them gives a window
without them, and every reading of them is then None.

Readings of a window, per batched LM iteration (lanes not counted):

- :func:`stage_ms_per_it`: device ms of the operations launched inside a
  program span (``dense.assemble``, ``dense.factor``, ...), nested spans
  included;
- :func:`host_wait_ms_per_it`: the device waiting on the host.  For each
  device operation launched inside ``slam/lm.iteration``, the stretch
  from the end of the device's previous busy interval to the earlier of
  the operation's start and the start of its launch call, where positive:
  idle that ended only when the host launched;
- :func:`split`: each program span's device ms, launches and host ms;
- :func:`idle_split`: the window's idle time by what each gap waited
  for: the profiler's own buffer requests (host operations
  ``Activity Buffer Request`` over half of a gap or more), the host, the
  launch call, or nothing (the device's own bubbles between queued
  operations).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import pathlib
import sys
import time
from types import SimpleNamespace

import torch

from portbench import program
from portbench.frozen import profile

#: The span around one LM iteration, and the profiler's own host work.
ITERATION = "slam/lm.iteration"
PROFILER_GAP = "Activity Buffer Request"


def _profiling():
    try:
        from slam_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def program_spans() -> tuple:
    """The program's span names, empty where it has none."""
    return tuple(getattr(_profiling(), "SPANS", ()))


def program_tracing():
    """The program's spans on for the block, where it has them."""
    tracing = getattr(_profiling(), "tracing", None)
    return tracing() if tracing is not None else contextlib.nullcontext()


def traced_window(prog: program.Program, solves: int, sync, spans: bool):
    """``(answers, seconds of each request, profile.Window, kernel calls)``
    of ``solves`` requests under the profiler, as
    ``portbench.trace.traced_window``, with the program's spans on
    (``spans``) and kept in the window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from portbench import trace

    answers, times, calls = [], [], []
    switch = program_tracing() if spans else contextlib.nullcontext()
    with program.spans(), program.kernel_calls(calls, trace.describe):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            with switch, torch.profiler.record_function(trace.WINDOW_SPAN):
                for _ in range(solves):
                    t0 = time.perf_counter()
                    answers.append(prog.entry())
                    sync()
                    times.append(time.perf_counter() - t0)
    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == trace.WINDOW_SPAN
            and not str(e.device_type()).endswith("CUDA")]
    if not span:
        raise RuntimeError("the traced window's range is not in the trace")
    start = span[0].start_ns()
    end = start + span[0].duration_ns()
    names = (tuple(program.SPANS.values())
             + (program.KERNEL_SPAN, trace.WINDOW_SPAN) + program_spans())
    return answers, times, profile.read_events(events, start, end,
                                               names), calls


def _iterations(run) -> int:
    return len(run.solve_s) * run.iters


def stage_ms_per_it(run, stage: str) -> float | None:
    """Device ms of the operations launched inside the program's spans
    ``slam/<stage>``, per batched LM iteration; None where the window has
    no such span."""
    if run.window is None:
        return None
    s = profile.span_device_seconds(run.window, "slam/" + stage)
    return None if s is None else s * 1e3 / _iterations(run)


def _ranges(w: profile.Window, name: str) -> tuple[list, list]:
    ranges = sorted((s.start_ns, s.end_ns) for s in w.spans
                    if s.name == name)
    return [r[0] for r in ranges], ranges


def _inside(starts: list, ranges: list, t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ranges[i][1]


def host_waits(w: profile.Window) -> list[tuple[int, int]] | None:
    """The stretches in which the device waited on the host for an
    operation launched inside :data:`ITERATION` spans (see the module's
    docstring), each inside one idle gap; None where the window has no
    such span or no launch is known."""
    starts, ranges = _ranges(w, ITERATION)
    if not ranges or not any(k.launch_ns is not None for k in w.kernels):
        return None
    out, busy_end = [], None
    for k in w.kernels:            # sorted by start
        if (busy_end is not None and k.launch_ns is not None
                and _inside(starts, ranges, k.launch_ns)):
            end = min(k.start_ns, k.launch_ns)
            if end > busy_end:
                out.append((busy_end, end))
        busy_end = k.end_ns if busy_end is None else max(busy_end, k.end_ns)
    return out


def host_wait_seconds(w: profile.Window) -> float | None:
    """The summed :func:`host_waits`."""
    waits = host_waits(w)
    return None if waits is None else sum(b - a for a, b in waits) / 1e9


def host_wait_ms_per_it(run) -> float | None:
    """:func:`host_wait_seconds` in ms per batched LM iteration."""
    if run.window is None:
        return None
    s = host_wait_seconds(run.window)
    return None if s is None else s * 1e3 / _iterations(run)


def split(run) -> dict:
    """Each program span's ``[device ms, launches, host ms]`` per batched
    LM iteration: the operations launched inside its ranges (nested spans
    included) and the summed wall of its ranges on the host."""
    w, its = run.window, _iterations(run)
    out = {}
    for name in sorted({s.name for s in w.spans
                        if s.name.startswith("slam/")}):
        starts, ranges = _ranges(w, name)
        dev, n = 0, 0
        for k in w.kernels:
            if k.launch_ns is not None and _inside(starts, ranges,
                                                   k.launch_ns):
                dev += k.end_ns - k.start_ns
                n += 1
        host = sum(b - a for a, b in ranges)
        out[name[len("slam/"):]] = [dev / 1e6 / its, n / its,
                                    host / 1e6 / its]
    return out


def _profiler_gap(requests: list, a: int, b: int) -> bool:
    """Whether the profiler's buffer requests cover half of ``[a, b)`` or
    more."""
    return 2 * sum(max(0, min(e, b) - max(s, a))
                   for s, e in requests) >= b - a


def idle_split(run) -> dict:
    """The window's idle ms per batched LM iteration, by what each gap
    waited for: ``profiler_ms``, gaps that the profiler's own buffer
    requests cover half of or more; ``outside_ms``, gaps at the window's
    ends or before an operation launched outside :data:`ITERATION` spans;
    before an operation launched inside one, ``host_wait_ms`` while its
    launch had not begun, then ``launch_ms`` from the launch call to its
    start, or ``queued_ms`` where it had been launched before the gap (the
    device's own bubbles).  The last three are None without the program's
    spans."""
    w, its = run.window, _iterations(run)
    starts, ranges = _ranges(w, ITERATION)
    requests = [(o.start_ns, o.end_ns) for o in w.host_ops
                if o.name == PROFILER_GAP]
    out = dict.fromkeys(("idle_ms", "profiler_ms", "outside_ms",
                         "host_wait_ms", "launch_ms", "queued_ms"), 0)
    t = None                       # the end of the device's busy time
    for k in w.kernels + [profile.Kernel("", w.end_ns, w.end_ns, None)]:
        a = w.start_ns if t is None else t
        b = min(k.start_ns, w.end_ns)
        if b > a:
            out["idle_ms"] += b - a
            if _profiler_gap(requests, a, b):
                out["profiler_ms"] += b - a
            elif (t is None or k.launch_ns is None
                  or not _inside(starts, ranges, k.launch_ns)):
                out["outside_ms"] += b - a
            elif k.launch_ns > a:
                out["host_wait_ms"] += min(k.launch_ns, b) - a
                out["launch_ms"] += b - min(k.launch_ns, b)
            else:
                out["queued_ms"] += b - a
        t = max(a, min(k.end_ns, w.end_ns))
    out = {key: v / 1e6 / its for key, v in out.items()}
    if not ranges:
        out.update(host_wait_ms=None, launch_ms=None, queued_ms=None)
    return out


def readings(run) -> dict:
    """Every reading of the program's spans in one window."""
    return {"host_wait_ms_per_it": host_wait_ms_per_it(run),
            "split": split(run), "idle": idle_split(run)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traffic", default=None,
                    help="another traffic mix on the cell's configuration")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of windows, the spans off and on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=None,
                    help="fewer lanes (a rehearsal on the CPU)")
    ap.add_argument("--iters", type=int, default=None,
                    help="fewer LM iterations (a rehearsal on the CPU)")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)

    from portbench import cell as cells
    from portbench import generate, run as bench_run, trace
    from portbench.frozen import work

    c = cells.load(args.workload)
    traffic = dict(cells.traffic(args.traffic) if args.traffic
                   else c.traffic)
    for key, v in (("lanes", args.lanes), ("lm_iters", args.iters)):
        if v is not None:
            traffic[key] = v
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from slam_tpu_torch import runtime
        from slam_tpu_torch.ops import _build

        runtime.setup_device(dev)
        _build.lib()
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    graphs = generate.graphs(c.config, traffic, args.seed)
    prog = program.build(graphs, c.config, traffic, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    prog.entry()
    sync()
    # The first profiler session of a process places the launch calls off
    # the host's clock (on the H100 kernels read launched after they
    # started, and the factors' launches fall into the next iteration's
    # spans): one session is thrown away.
    traced_window(prog, 1, sync, False)
    peaks = work.card_peaks(kind) if dev.type == "cuda" else None
    card = bench_run.card_name_and_power() if dev.type == "cuda" else "cpu"
    order = [False, True, True, False] * (args.pairs // 2) \
        + [False, True] * (args.pairs % 2)
    lines = []
    for k, spans in enumerate(order):
        answers, solve_s, win, calls = traced_window(
            prog, traffic["trace_solves"], sync, spans)
        run = SimpleNamespace(
            setup_s=None, solve_s=solve_s, wall_s=win.seconds,
            lanes=traffic["lanes"], iters=traffic["lm_iters"], window=win,
            factors=prog.factors,
            itemsize=prog.batch.poses0.element_size(),
            dtype=prog.batch.poses0.dtype, peaks=peaks,
            kernel_bound_s=(trace.kernel_bound_seconds(calls, peaks)
                            if peaks else None))
        metrics = {m["name"]: cells.reader(m["name"])(run)
                   for m in c.per_layer}
        line = {"window": k, "program_spans": spans,
                "workload": args.workload,
                "traffic": args.traffic,
                "seed": args.seed, "card": card,
                "request_s": solve_s,
                "it_wall_ms": [s * 1e3 / run.iters for s in solve_s],
                "busy_s": profile.busy_seconds(win),
                "window_s": win.seconds, "metrics": metrics,
                **readings(run)}
        del answers
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
