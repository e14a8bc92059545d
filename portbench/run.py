"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up (``setup_s``): import torch, load
the kernel library (the first run in a checkout compiles it into
``slam_tpu_torch/_build/``), read the dataset with the benchmark's own
reader, draw each lane's bogus loops from ``--seed``, hand the arrays to
the port and build the cell's plan through its public entry points, and
warm up the cell's shapes with one request.  The window: one caller, a
closed loop; a request is one whole solve from the set-up's initial state,
ended by ``torch.cuda.synchronize()``; requests run back to back until
``--seconds`` have passed, the one in flight finished and counted.  With
``--trace 1`` the window is the traffic's ``trace_solves`` requests under
``torch.profiler`` instead, and the run reports the per-layer metrics.
Then every answer is judged against the plain reference
(``portbench/check.py``), and the last line of standard output is the
result.  Without a CUDA device, or with fewer than the cell asks for, the
run prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

#: Modules that may not be loaded when the result is printed: JAX and the
#: JAX package, compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_name_and_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", overrides: dict | None = None,
        wrap_entry=None, log=print) -> dict:
    """One run of ``workload``; returns the result object.  ``device``
    "cpu" runs the plain kernel versions (for tests); ``overrides``
    replaces traffic entries (for tests); ``wrap_entry(entry)`` puts a
    function in the request's place (for the planted-fault tests)."""
    import torch

    from portbench import cell as cells
    from portbench import check, generate, program
    from portbench.frozen import work

    c = cells.load(workload)
    traffic = dict(c.traffic, **(overrides or {}))
    dev = torch.device(device)
    phases = {"import": time.perf_counter() - T0}
    if dev.type == "cuda":
        from slam_tpu_torch import runtime
        from slam_tpu_torch.ops import _build

        runtime.setup_device(dev)
        _build.lib()
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    phases["device"] = time.perf_counter() - T0
    graphs = generate.graphs(c.config, traffic, seed)
    phases["graphs"] = time.perf_counter() - T0
    prog = program.build(graphs, c.config, traffic, dev)
    phases["build"] = time.perf_counter() - T0
    entry = prog.entry if wrap_entry is None else wrap_entry(prog.entry,
                                                             prog)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    entry()                                   # warm up the cell's shapes
    sync()
    setup_s = time.perf_counter() - T0
    log(json.dumps({"plan": program.shapes(prog), "setup_s": setup_s,
                    "setup_ends": phases}), flush=True)

    win = None
    calls: list = []
    if trace:
        from portbench import trace as tr

        answers, solve_s, win, calls = tr.traced_window(
            prog._replace(entry=entry), traffic["trace_solves"], sync)
        wall = win.seconds
        log(json.dumps({"trace": {
            "device_ops": len(win.kernels), "spans": len(win.spans),
            "host_ops": len(win.host_ops),
            "launch_linked": sum(k.launch_ns is not None
                                 for k in win.kernels)}}), flush=True)
    else:
        answers, solve_s = [], []
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            answers.append(entry())
            sync()
            t1 = time.perf_counter()
            solve_s.append(t1 - t0)
            if t1 - start >= seconds:
                break
        wall = t1 - start
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    peaks = work.card_peaks(kind) if dev.type == "cuda" else None
    ctx = SimpleNamespace(
        setup_s=setup_s, solve_s=solve_s, wall_s=wall,
        lanes=traffic["lanes"], iters=traffic["lm_iters"], window=win,
        factors=prog.factors,
        itemsize=prog.batch.poses0.element_size(),
        dtype=prog.batch.poses0.dtype, peaks=peaks,
        kernel_bound_s=(tr.kernel_bound_seconds(calls, peaks)
                        if trace and peaks else None))
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = cells.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    breakdown = breakdown_of(win) if win is not None else None

    # the program's state goes before the reference runs
    del prog, entry, calls, ctx
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        log(json.dumps({"card": card_name_and_power(),
                        "memory_peak_bytes": peak}), flush=True)
    verdict = check.judge(answers, graphs, c.config, traffic, c.limits,
                          dev)
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": c.chips,
                  "memory_peak_bytes": peak}
    if win is not None:
        from portbench.frozen import profile

        device_out["busy_s"] = profile.busy_seconds(win)
        device_out["window_s"] = win.seconds
    out = {"correct": verdict.correct, "attempted": len(answers),
           "failed": verdict.failed, "metrics": metrics,
           "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = verdict.numbers
    return out


def breakdown_of(win) -> dict:
    """The ten device operations with the most time and the ten longest
    idle gaps, each named by the host operation over it."""
    from portbench.frozen import profile

    ops = sorted(profile.device_seconds_by_name(win).items(),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(profile.idle_gaps(win), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[profile.host_op_over(win, a, b)[:160],
                           (b - a) / 1e9] for a, b in gaps]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import cell as cells

    chips = cells.load(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}: the run may not load JAX or "
              "the JAX package; no result", file=sys.stderr)
        return 3
    for name, n in out["check"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
