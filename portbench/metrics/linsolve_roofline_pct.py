"""The linear solve's share of its roofline: the least time the card
needs for an iteration's Cholesky factors (n^3 / 3 flops each, the
assembled matrix written once; the plan's orders, whatever kernel
factors them) over the device time inside the ``_solve_linear`` spans,
per batched LM iteration, in percent."""

from portbench.frozen import profile, work


def read(run):
    if run.window is None or run.peaks is None:
        return None
    s = profile.span_device_seconds(run.window, "linear_solve")
    if not s:
        return None
    iters = len(run.solve_s) * run.iters
    least = sum(work.bound_s(run.peaks, run.dtype,
                             *work.cholesky_work(n, count, run.itemsize))
                for n, count in run.factors)
    return 100.0 * least * iters / s
