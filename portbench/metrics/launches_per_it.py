"""Device operations (kernels, memsets, copies) of the traced window per
batched LM iteration."""


def read(run):
    if run.window is None or not run.window.kernels:
        return None
    return len(run.window.kernels) / (len(run.solve_s) * run.iters)
