"""Device milliseconds of the operations launched inside the LM loop's
``_solve_linear`` calls (assembly, factors, substitutions), per batched
LM iteration."""

from portbench.frozen import profile


def read(run):
    if run.window is None:
        return None
    s = profile.span_device_seconds(run.window, "linear_solve")
    return None if not s else s * 1e3 / (len(run.solve_s) * run.iters)
