"""Per-launch times of the kernels at every shape the LM iteration gives them.

    python -m slam_tpu_torch.tools.kernel_times [--reps 50]
        [--robust dcs|sc|sc_varpro] [--linear-solver schur|dense|pcg]
        [--problem intel|sphere2500]

For INTEL+50 and M10000+50 under ``--robust`` (plain DCS by default, or
method 2's joint switches or their variable projection) on the native
Schur solver, or INTEL+50 alone on the dense or the PCG solver, or with
``--problem sphere2500`` the sphere2500 SE(3) recipe (plain DCS, Schur
with 4 index blocks; ``tools/problems.py``), float32,
it records every kernel wrapper call of a one-iteration ``lm_fixed_iters``
run (the initial cost plus one iteration; and on the Schur solver the
first ``micro_chol_inv`` call of a blocked run), then replays each
distinct call on its own and prints one JSON line per call:

- ``ms``: CUDA events around ``reps`` back-to-back calls, as chip_smoke
  times a kernel; the device waits for the host whenever the host is
  slower, so this is the larger of the two;
- ``device_ms``: the summed time of the call's device events under
  ``torch.profiler`` (kernels and memsets), per call, with their count;
- ``host_us``: host microseconds per call over ``reps`` calls with no
  synchronisation (what the host spends enqueueing);
- ``library_ms``: the PyTorch call that computes the same function on the
  same inputs (``index_select``; ``index_add_`` of the plan's source rows
  into an accumulator of the flat segment grid; ``cholesky_ex`` and
  ``solve_triangular`` for ``micro_chol_inv``), where there is one;
- ``bound_ms``: the least time on this card (:func:`bound`).

A scatter that serves several plans in one launch gets a line for the
launch and one for each plan launched alone.  The device times are taken
last, after every other time of the process: a torch.profiler session
leaves the host-bound calls made after it in the same process slower.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

Tensor = torch.Tensor

# Operations per edge of the linearisation kernel: about 200 flops and 9
# transcendentals (slam_tpu_torch/csrc/linearize_se2.cu).
LINEARIZE_OPS_PER_EDGE = 209

# Published peaks (dense, no sparsity; float32/float64 outside the tensor
# cores): memory bytes/s and operations/s by type.
PEAKS = {
    "H100 PCIe": (2.0e12, {torch.float32: 51e12, torch.float64: 26e12}),
    "H100 NVL": (3.9e12, {torch.float32: 60e12, torch.float64: 30e12}),
    "H200": (4.8e12, {torch.float32: 67e12, torch.float64: 34e12}),
    "H100": (3.35e12, {torch.float32: 67e12, torch.float64: 34e12}),
}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def card_peaks() -> tuple[float, dict]:
    name = torch.cuda.get_device_name(0)
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def bound(peaks, dtype, nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for this work on this card."""
    t_bytes = nbytes / peaks[0] * 1e3
    t_ops = ops / peaks[1][dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Recording the wrapper calls of a run
# ---------------------------------------------------------------------------

def _wrappers() -> dict:
    """``name -> function`` of the counted kernel wrappers (and of the
    grouped scatter, where there is one)."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.ops import gather, linearize

    fns = {fn.__name__: fn for fn in ops._wrappers()}
    for mod, name in ((gather, "scatter_add_groups"),
                      (linearize, "fused_linearize_se2_indexed")):
        fn = getattr(mod, name, None)
        if fn is not None:
            fns[name] = fn
    return fns


def record(run) -> list[tuple[str, tuple, dict]]:
    """``(wrapper name, args, kwargs)`` of every outermost wrapper call
    that ``run()`` makes, in order.  Patches the wrappers in every loaded
    module of the package for the run's duration (the launch counts,
    ``ops.launch_counts()``, go on as without it)."""
    by_id = {id(fn): (name, fn) for name, fn in _wrappers().items()}
    calls, depth = [], [0]

    def recorder(name, fn):
        def call(*args, **kw):
            if depth[0] == 0:
                calls.append((name, args, kw))
            depth[0] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
        return call

    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("slam_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in by_id:
                patched.append((mod, attr, val))
                setattr(mod, attr, recorder(*by_id[id(val)]))
    try:
        run()
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)
    return calls


def object_names(**roots) -> dict[int, str]:
    """``id -> dotted name`` of every tensor and plan inside the given
    NamedTuples (an EdgeSet, a SchurPartition), for labelling calls."""
    names = {}

    def walk(obj, prefix):
        for field in getattr(obj, "_fields", ()):
            val = getattr(obj, field)
            name = f"{prefix}.{field}"
            if isinstance(val, Tensor) or hasattr(val, "_fields"):
                names.setdefault(id(val), name)
            if hasattr(val, "_fields"):
                walk(val, name)

    for prefix, obj in roots.items():
        walk(obj, prefix)
    return names


# ---------------------------------------------------------------------------
# Timing one call
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call, no synchronisation inside the window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def device_kernels(fn, reps: int = 50) -> dict:
    """``{kernel: (device ms per call, events per call)}`` of the call's
    device events under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from slam_tpu_torch.tools.profile_lm import device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (device_us(e) / 1e3 / reps, e.count / reps)
            for e in prof.key_averages() if device_us(e) > 0}


def device_ms(fn, reps: int = 50) -> tuple[float, float]:
    """(device ms per call, device events per call) under torch.profiler."""
    kernels = device_kernels(fn, reps).values()
    return (sum(ms for ms, _ in kernels), sum(n for _, n in kernels))


def times(fn, library, reps: int) -> dict:
    """The host-sensitive times of one call (``library_ms`` None without
    a library call); :func:`add_device_times` adds the device time."""
    return dict(ms=cuda_ms(fn, reps), host_us=host_us(fn, reps),
                library_ms=None if library is None else cuda_ms(library,
                                                                reps))


def add_device_times(rows: list, fns: list, reps: int) -> None:
    """``device_ms``, ``device_events`` and ``device_kernels`` (ms a call
    by kernel) of ``fns[i]`` into ``rows[i]``, under torch.profiler: call
    this after every other timing of the process."""
    for row, fn in zip(rows, fns):
        kernels = device_kernels(fn, reps)
        row["device_kernels"] = {k: ms for k, (ms, _) in kernels.items()}
        row["device_ms"] = sum(row["device_kernels"].values())
        row["device_events"] = sum(n for _, n in kernels.values())


# ---------------------------------------------------------------------------
# What a call computes: bytes, operations, the library call
# ---------------------------------------------------------------------------

def _size(t: Tensor) -> int:
    return t.numel() * t.element_size()


def gather_work(x: Tensor, idx: Tensor) -> tuple[float, float, object]:
    """(bytes, operations, library call) of ``x[idx]``: x and idx read
    once, the output written once."""
    idx64 = idx.long()
    out = idx.numel() * _size(x) // max(1, x.shape[0])
    return (float(_size(x) + _size(idx) + out), 0.0,
            lambda: x.index_select(0, idx64))


def scatter_work(v: Tensor, plan) -> tuple[float, float, object]:
    """(bytes, operations, library call) of one plan's segment sum: the
    distinct source rows read once, the plan's rows and the bounds of its
    non-empty segments read once (4 bytes each), the whole output (the
    zeroed matrix of a block-grid plan) written once; one add per source
    row and column."""
    vf = v.reshape(v.shape[0], -1)
    K = vf.shape[1]
    src = plan.src.cpu().numpy()
    nonempty = int(np.count_nonzero(np.diff(plan.offsets.cpu().numpy())))
    sz = v.element_size()
    nbytes = (np.unique(src).size * K * sz + 4 * src.size
              + 8 * nonempty + plan.n * K * sz)
    rows = vf.index_select(0, plan.src.long())
    idx64 = plan.idx.long()
    acc = torch.zeros((plan.n, K), dtype=v.dtype, device=v.device)
    return (float(nbytes), float(src.size * K),
            lambda: acc.index_add_(0, idx64, rows))


def linearize_work(poses: Tensor, free_node: Tensor, edges,
                   *_, **__) -> tuple[float, float, None]:
    """(bytes, operations, no library call) of the indexed linearisation:
    the poses, the free mask, the endpoints and the edge inputs read once,
    the 56 values per edge written once."""
    E = edges.num_edges
    size = poses.element_size()
    nbytes = (_size(poses) + _size(free_node) + _size(edges.ab)
              + E * (3 + 1 + 1 + 56) * size)
    return float(nbytes), float(LINEARIZE_OPS_PER_EDGE * E), None


def chol_work(A: Tensor, *_, **__) -> tuple[float, float, object]:
    """(bytes, operations, library call) of ``micro_chol_inv``: the lower
    triangle of A read, L and its inverse written; about 2/3 p^3 flops a
    matrix; ``cholesky_ex`` then ``solve_triangular`` against the
    identity."""
    m, p, _ = A.shape
    eye = torch.eye(p, dtype=A.dtype, device=A.device).expand(m, -1, -1)

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.linalg.solve_triangular(L, eye, upper=False)

    return (float(m * (p * (p + 1) // 2 + 2 * p * p) * A.element_size()),
            float(m * 2 * p ** 3 / 3), library)


def cholesky_work(n: int, count: int, itemsize: int) -> tuple[float, float]:
    """(bytes, operations) of ``count`` Cholesky factors of order ``n``:
    n^3 / 3 flops each, the matrix written once (the benchmark's
    ``frozen/work.py::cholesky_work``)."""
    return float(count * n * n * itemsize), float(count * n ** 3 / 3)


# ---------------------------------------------------------------------------
# One problem
# ---------------------------------------------------------------------------

def _label(name: str, args: tuple, names: dict) -> str:
    def nm(obj):
        return names.get(id(obj), "?")

    if name == "gather_rows":
        return f"gather_rows {nm(args[1])} x{list(args[0].shape)}"
    if name == "scatter_add_rows":
        return f"scatter_add_rows {nm(args[1])} v{list(args[0].shape)}"
    if name == "scatter_add_groups":
        return "scatter_add_groups " + " + ".join(
            f"{nm(p)} v{list(v.shape)}" for v, p in args[0])
    if name == "fused_linearize_se2_indexed":
        return f"{name} x{list(args[0].shape)} E={args[2].num_edges}"
    return f"{name} {list(args[0].shape)}"


def measure_calls(calls, names: dict, peaks, reps: int) -> tuple[list, list]:
    """``(rows, fns)``: one dict per distinct call (and per plan of a
    grouped call) with its host-sensitive times and bound, and the
    function that replays it, for :func:`add_device_times`."""
    wrappers = _wrappers()
    works = {"gather_rows": gather_work, "scatter_add_rows": scatter_work,
             "fused_linearize_se2_indexed": linearize_work,
             "micro_chol_inv": chol_work}
    by_label: dict[str, list] = {}
    for name, args, kw in calls:
        by_label.setdefault(_label(name, args, names), []).append(
            (name, args, kw))
    rows, fns = [], []
    for label, seen in by_label.items():
        name, args, kw = seen[0]
        work = None
        if name in works:
            work = works[name](*args, **kw)
        elif name == "scatter_add_groups":
            each = [scatter_work(v, p) for v, p in args[0]]
            work = (sum(w[0] for w in each), sum(w[1] for w in each), None)
        fn = functools.partial(wrappers[name], *args, **kw)
        row = dict(call=label, calls_per_run=len(seen),
                   **times(fn, None if work is None else work[2], reps))
        if work is not None:
            dtype = (args[0][0][0] if name == "scatter_add_groups"
                     else args[0]).dtype
            row["bound_ms"], row["bound_by"] = bound(peaks, dtype, work[0],
                                                     work[1])
        rows.append(row)
        fns.append(fn)
        if name == "scatter_add_groups":
            more = measure_calls(
                [("scatter_add_rows", (v, p), {}) for v, p in args[0]],
                names, peaks, reps)
            rows += more[0]
            fns += more[1]
    return rows, fns


def record_iteration(args, cfg, part, blocked_cfg=None):
    """``(calls, launch counts, names)`` of a one-iteration
    ``lm_fixed_iters`` run after a warm-up one, plus the first
    ``micro_chol_inv`` call of a blocked run under ``blocked_cfg``."""
    from slam_tpu_torch import ops
    from slam_tpu_torch.solver.lm import lm_fixed_iters

    lm_fixed_iters(*args, cfg, 1, partition=part)
    torch.cuda.synchronize()
    ops.reset_launches()
    calls = record(lambda: lm_fixed_iters(*args, cfg, 1, partition=part))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if blocked_cfg is not None:
        blocked = record(lambda: lm_fixed_iters(*args, blocked_cfg, 1,
                                                partition=part))
        calls += [c for c in blocked if c[0] == "micro_chol_inv"][:1]
    return calls, counts, object_names(edges=args[2], part=part)


def main(argv=None) -> int:
    from slam_tpu_torch.tools.problems import PROBLEMS, ROBUST, SOLVERS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--robust", default="dcs", choices=ROBUST)
    ap.add_argument("--linear-solver", default="schur", choices=SOLVERS)
    ap.add_argument("--problem", default="intel", choices=PROBLEMS)
    opts = ap.parse_args(argv)
    if opts.problem == "sphere2500" and (opts.robust != "dcs"
                                         or opts.linear_solver != "schur"):
        raise ValueError("sphere2500 is the plain-DCS Schur recipe")
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from slam_tpu_torch import runtime
    from slam_tpu_torch.tools.problems import CONFIGS, intel50_plain, \
        m10000, sphere2500

    device = runtime.setup_device("cuda")
    peaks = card_peaks()
    card = nvidia_smi()
    schur = opts.linear_solver == "schur"
    if opts.problem == "sphere2500":
        s = sphere2500(device, torch.float32)
        cases = {"sphere2500": (s.args, s.cfg, s.partition)}
    else:
        prob = intel50_plain(device, "float32", opts.robust,
                             opts.linear_solver)
        cases = {"INTEL": ((prob.poses0, prob.switches0, prob.edges,
                            prob.free), prob.scfg, prob.partition)}
    if schur and opts.problem == "intel":
        m = m10000(device, torch.float32, opts.robust)
        cases["M10000"] = (m.args, m.cfg, m.partition)
    measured = []
    for label, (lm_args, cfg, part) in cases.items():
        calls, counts, names = record_iteration(
            lm_args, cfg, part,
            cfg.replace(**CONFIGS["blocked_micro"]) if schur else None)
        measured.append((label, counts,
                         *measure_calls(calls, names, peaks, opts.reps)))
    for label, counts, rows, fns in measured:
        add_device_times(rows, fns, opts.reps)
        print(json.dumps({"shape": label, "robust": opts.robust,
                          "linear_solver": opts.linear_solver, "card": card,
                          "torch": torch.__version__,
                          "launches_per_run": counts}), flush=True)
        for row in rows:
            print(json.dumps({"shape": label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
