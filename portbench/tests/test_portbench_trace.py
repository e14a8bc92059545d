"""The traced window's arithmetic on synthetic events, and the kernel
calls' least time from one CPU request."""

import torch

from portbench import cell as cells
from portbench import generate, program, trace
from portbench.frozen import profile, work


class _Ev:
    """A stand-in for the profiler's Kineto event."""

    def __init__(self, name, t0, t1, device=False, corr=0, linked=0,
                 annotation=False):
        self._v = (name, t0, t1 - t0, device, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _window():
    evs = [
        _Ev("linearize", 0, 100, annotation=True),
        _Ev("cudaLaunchKernel", 10, 12, corr=1),
        _Ev("linear_solve", 100, 300, annotation=True),
        _Ev("cudaLaunchKernel", 150, 152, corr=2),
        _Ev("aten::einsum", 160, 290),
        _Ev("k_lin", 20, 60, device=True, corr=1, linked=1),
        _Ev("k_solve", 50, 80, device=True, corr=2, linked=2),
        _Ev("linear_solve", 60, 70, device=True, annotation=True),
    ]
    return profile.read_events(evs, 0, 400, ("linearize", "linear_solve"))


def test_busy_idle_and_spans():
    w = _window()
    assert [k.name for k in w.kernels] == ["k_lin", "k_solve"]
    assert profile.busy_seconds(w) == 60e-9          # [20, 80)
    assert profile.idle_gaps(w) == [(0, 20), (80, 400)]
    assert profile.span_device_seconds(w, "linearize") == 40e-9
    assert profile.span_device_seconds(w, "linear_solve") == 30e-9
    assert profile.span_device_seconds(w, "absent") is None
    assert profile.host_op_over(w, 80, 400) == "aten::einsum"


def test_kernel_calls_least_time():
    c = cells.load("intel50.sc.b8_dense")
    tr = dict(cells.traffic("dcs.b8"), lanes=2, lm_iters=2)
    prog = program.build(generate.graphs(c.config, tr, 5), c.config, tr,
                         torch.device("cpu"))
    calls = []
    with program.spans(), program.kernel_calls(calls, trace.describe):
        prog.entry()
    assert {n for n, _, _ in calls} == {"gather_rows", "scatter_add_groups",
                                        "fused_linearize_se2_indexed"}
    assert 0 < trace.kernel_bound_seconds(calls, work.PEAKS["H100"]) < 1e-3
