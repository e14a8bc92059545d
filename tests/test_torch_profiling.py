"""The program's stage spans (``utils/profiling.py``) and its launch
counter (``ops.launch_counts()``), on the CPU: which spans a seed-batch
request opens on each solver, how they nest, that they change no answer,
that they cost no profiler object while off, and that the counter holds
under stand-ins of the wrappers."""

import os
import re
import sys

import pytest
import torch

from slam_tpu_torch import convert, ops
from slam_tpu_torch.ops import _build, gather
from slam_tpu_torch.solver import batch as tb
from slam_tpu_torch.solver import linear, schur
from slam_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "slam_tpu_torch")
ITERS = 2

LM = {"lm.solve", "lm.iteration", "lm.linearize", "lm.linear_solve",
      "lm.retract_cost"}
DENSE = {"dense.assemble", "dense.factor", "dense.substitute"}
SCHUR = {"schur.assemble", "schur.interiors", "schur.separator",
         "schur.back_substitute"}
#: case -> (SolverConfig keywords, the spans its request opens)
CASES = {
    "dense-sc": (dict(robust="sc", linear_solver="dense"),
                 LM | DENSE | {"kernel.gather_rows",
                               "kernel.scatter_add_rows",
                               "kernel.stack_cholesky"}),
    "dense-pose": (dict(robust="dcs", linear_solver="dense"),
                   LM | DENSE | {"kernel.fused_linearize_se2",
                                 "kernel.gather_rows",
                                 "kernel.scatter_add_rows",
                                 "kernel.stack_cholesky"}),
    # the seed batch's separators are one stack
    "schur-native-sc": (dict(robust="sc", linear_solver="schur"),
                        LM | SCHUR | {"sc.eliminate", "kernel.gather_rows",
                                      "kernel.scatter_add_rows",
                                      "kernel.stack_cholesky"}),
    # the kernel takes float32 panels only
    "schur-blocked-kernel": (dict(robust="dcs", linear_solver="schur",
                                  schur_blocked=True, schur_panel=16,
                                  schur_pallas_micro=True, dtype="float32"),
                             LM | SCHUR | {"kernel.fused_linearize_se2",
                                           "kernel.gather_rows",
                                           "kernel.scatter_add_rows",
                                           "kernel.micro_chol_inv"}),
}
#: span -> the span that encloses it
PARENT = {"lm.iteration": "lm.solve", "lm.linearize": "lm.iteration",
          "lm.linear_solve": "lm.iteration",
          "lm.retract_cost": "lm.iteration", "sc.eliminate":
          "lm.linear_solve",
          **{n: "lm.linear_solve" for n in DENSE | SCHUR}}


@pytest.fixture(scope="module")
def lanes(circle):
    g, _ = circle
    return [convert.graph_from_jax(g.add_random_outliers(4, seed=s))
            for s in (3, 4)]


def _request(lanes, case):
    """One request of the case: ``ITERS`` LM iterations of both lanes."""
    kw, _ = CASES[case]
    cfg = tb.SolverConfig(**{"dtype": "float64", **kw})
    b = tb.seed_batch(lanes, 4, dtype=getattr(torch, cfg.dtype))
    plan = (b.partition if cfg.linear_solver == "schur" else
            tb.batch_plan(b.edges, cfg.linear_solver, b.seeds, cfg.robust))

    def run():
        res = tb.lm_fixed_iters_batch(*b.args, cfg, ITERS, plan)
        return res.poses, res.switches, res.cost

    return run


def _profiled(run, traced: bool):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if traced:
            with profiling.tracing():
                out = run()
        else:
            out = run()
    return out, [e for e in prof.events() if e.name.startswith("slam/")]


def _parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("slam/"):
        p = p.cpu_parent
    return None if p is None else p.name[len(profiling.PREFIX):]


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_of_a_request_and_their_nesting(lanes, case):
    """Off, a profiled request holds no ``slam/`` event; on, it holds
    every span its path reaches, each inside the span that encloses it,
    ``slam/lm.solve`` outermost, and the answer is the same to the bit."""
    run = _request(lanes, case)
    off, events = _profiled(run, traced=False)
    assert events == []
    on, events = _profiled(run, traced=True)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    names = {e.name for e in events}
    assert names <= set(profiling.SPANS)
    assert names == {profiling.PREFIX + n for n in CASES[case][1]}
    for ev in events:
        name = ev.name[len(profiling.PREFIX):]
        parent = _parent(ev)
        if name == "lm.solve":
            assert parent is None
        elif name in PARENT:
            assert parent == PARENT[name], (name, parent)
        else:  # a kernel's wrapper, inside some stage of the request
            assert parent is not None, name
    count = sum(e.name == "slam/lm.iteration" for e in events)
    assert count == ITERS


def test_off_spans_build_no_profiler_object(lanes, monkeypatch):
    """While tracing is off, ``span`` hands out one shared null context
    and never builds a ``record_function``."""
    built = []
    real = torch.profiler.record_function

    def counting(name):
        built.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    run = _request(lanes, "dense-sc")
    run()
    assert built == []
    assert profiling.span("lm.solve") is profiling.span("dense.factor")
    with profiling.tracing():
        run()
    assert "slam/lm.iteration" in built


def test_tracing_nests_and_restores():
    assert not profiling._on
    with profiling.tracing():
        with profiling.tracing():
            assert profiling._on
        assert profiling._on
    assert not profiling._on


def test_spans_lists_every_span_of_the_package():
    """Every name the package passes to ``span`` is in ``SPANS``, and every
    entry of ``SPANS`` is opened somewhere."""
    used = set()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    used |= set(re.findall(r'\bspan\("([^"]+)"\)',
                                           fh.read()))
    assert {profiling.PREFIX + n for n in used} == set(profiling.SPANS)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


def test_launch_counts_hold_under_the_benchmarks_stand_ins(monkeypatch):
    """``portbench.program.kernel_calls`` replaces the wrappers' names in
    every module of the package; the launches still count on the one
    counter, under the wrappers' own names.  The launch path runs on meta
    tensors with the C entry points stood in for."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import program, trace

    monkeypatch.setattr(_build, "entry", lambda base, dtype: lambda *a: 0)
    monkeypatch.setattr(_build, "stream_ptr", lambda index: 0)
    x = torch.empty((5, 3), dtype=torch.float32, device="meta")
    idx = torch.empty((4,), dtype=torch.int32, device="meta")
    v = torch.empty((4, 3), dtype=torch.float32, device="meta")
    plan = gather.segment_plan([0, 1, 1, 2], 3, device="meta")
    ops.reset_launches()
    calls = []
    with program.kernel_calls(calls, trace.describe):
        assert schur.gather_rows is not gather.gather_rows
        schur.gather_rows(x, idx)
        schur.gather_rows(x, idx)
        linear.scatter_add_rows(v, plan)
    assert [c[0] for c in calls] == ["gather_rows", "gather_rows",
                                     "scatter_add_groups"]
    assert schur.gather_rows is gather.gather_rows
    assert ops.launch_counts() == {"gather_rows": 2, "scatter_add_rows": 1,
                                   "fused_linearize_se2": 0,
                                   "micro_chol_inv": 0, "stack_cholesky": 0}
    ops.reset_launches()
    assert set(ops.launch_counts().values()) == {0}
