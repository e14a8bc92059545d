"""The readings of the program's own spans (``portbench/stages.py``) on
synthetic events, and the program's span names in a traced window of one
CPU request."""

import pytest
import torch

from portbench import cell as cells
from portbench import generate, program, stages
from portbench.frozen import profile

approx = pytest.approx


class _Ev:
    """A stand-in for the profiler's Kineto event."""

    def __init__(self, name, t0, t1, device=False, corr=0, annotation=False):
        self._v = (name, t0, t1, device, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[4] if self._v[3] else 0

    def is_user_annotation(self):
        return self._v[5]


def _launch(t, corr):
    return _Ev("cudaLaunchKernel", t, t + 2, corr=corr)


def _kernel(name, t0, t1, corr):
    return _Ev(name, t0, t1, device=True, corr=corr)


def _run(with_program_spans=True):
    """One iteration: the assembly's kernel, then a gap of 30 ns of which
    the factor's kernel waited 20 on its launch, the substitution's kernel
    queued behind it, and a gap of 160 ns the profiler's buffer request
    sits over, of which the last kernel waited 150 on its launch."""
    spans = [("slam/lm.solve", 0, 1000), ("slam/lm.iteration", 1, 999),
             ("slam/lm.linear_solve", 5, 305),
             ("slam/dense.assemble", 10, 100),
             ("slam/dense.factor", 100, 200),
             ("slam/dense.substitute", 200, 300),
             ("slam/lm.retract_cost", 590, 700)]
    evs = [_Ev(n, a, b, annotation=True) for n, a, b in spans
           if with_program_spans]
    evs += [
        _launch(20, 1), _launch(150, 2), _launch(250, 3), _launch(600, 4),
        _Ev(stages.PROFILER_GAP, 455, 590),
        _kernel("k_assemble", 30, 130, 1), _kernel("k_factor", 160, 400, 2),
        _kernel("k_substitute", 400, 450, 3), _kernel("k_cost", 610, 700, 4),
        _Ev("slam/dense.factor", 170, 180, device=True, annotation=True),
    ]
    names = stages.program_spans() if with_program_spans else ()
    w = profile.read_events(evs, 0, 1000, names)
    return type("Run", (), dict(window=w, solve_s=[1.0], iters=1))()


def test_stage_readers_sum_device_time_by_program_span():
    run = _run()
    assert [k.name for k in run.window.kernels] == [
        "k_assemble", "k_factor", "k_substitute", "k_cost"]
    assert stages.stage_ms_per_it(run, "dense.assemble") == approx(100e-6)
    assert stages.stage_ms_per_it(run, "dense.factor") == approx(240e-6)
    assert stages.stage_ms_per_it(run, "dense.substitute") == approx(50e-6)
    assert stages.stage_ms_per_it(run, "lm.linear_solve") == approx(390e-6)
    assert stages.stage_ms_per_it(run, "schur.separator") is None
    got = stages.split(run)
    assert got["dense.factor"] == approx([240e-6, 1.0, 100e-6])
    assert got["lm.iteration"][:2] == approx([480e-6, 4.0])


def test_host_wait_counts_late_launches_only():
    """The factor's kernel was launched 20 ns after the device went idle
    and the last kernel 150 ns after; the substitution's was queued."""
    run = _run()
    assert stages.host_waits(run.window) == [(130, 150), (450, 600)]
    assert stages.host_wait_ms_per_it(run) == approx(170e-6)
    idle = stages.idle_split(run)
    assert idle == approx({"idle_ms": 520e-6,         # 30+30+160+300
                           "profiler_ms": 160e-6,     # [450, 610)
                           "outside_ms": 330e-6,      # the two ends
                           "host_wait_ms": 20e-6,     # [130, 150)
                           "launch_ms": 10e-6,        # [150, 160)
                           "queued_ms": 0.0})


def test_without_program_spans_every_reader_is_none():
    run = _run(with_program_spans=False)
    assert run.window.spans == []
    for stage in ("dense.assemble", "dense.factor", "dense.substitute"):
        assert stages.stage_ms_per_it(run, stage) is None
    assert stages.host_wait_ms_per_it(run) is None
    assert stages.split(run) == {}
    idle = stages.idle_split(run)
    assert idle["host_wait_ms"] is idle["queued_ms"] is None
    assert idle["outside_ms"] == approx(520e-6 - idle["profiler_ms"])


def test_cpu_request_keeps_the_program_spans():
    """One CPU request of the dense traffic: with the program's spans on
    the window holds them (and the benchmark's own), off it holds only the
    benchmark's."""
    torch.set_num_threads(2)
    c = cells.load("intel50.sc.b8_dense")
    tr = dict(c.traffic, lanes=2, lm_iters=1)
    prog = program.build(generate.graphs(c.config, tr, 2**31 + 7), c.config,
                         tr, torch.device("cpu"))
    names = {}
    for on in (False, True):
        _, times, win, calls = stages.traced_window(prog, 1, lambda: None,
                                                    spans=on)
        names[on] = {s.name for s in win.spans}
        assert len(times) == 1 and calls
    want = {"slam/" + n for n in (
        "lm.solve", "lm.iteration", "lm.linearize", "lm.linear_solve",
        "lm.retract_cost", "dense.assemble", "dense.factor",
        "dense.substitute", "kernel.gather_rows", "kernel.scatter_add_rows")}
    bench = {"linearize", "linear_solve", program.KERNEL_SPAN,
             "portbench_window"}
    assert names[True] == want | bench
    assert names[False] == bench
