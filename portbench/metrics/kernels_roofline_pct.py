"""The hand-written kernels' share of their roofline: the least time of
every call of their wrappers in the traced window (bytes and operations
by the frozen work formulas, ``portbench/frozen/work.py``) over the
device time of the operations those calls launched, in percent."""

from portbench import program
from portbench.frozen import profile


def read(run):
    if run.window is None or not run.kernel_bound_s:
        return None
    s = profile.span_device_seconds(run.window, program.KERNEL_SPAN)
    return None if not s else 100.0 * run.kernel_bound_s / s
