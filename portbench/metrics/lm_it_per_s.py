"""Problem-iterations a second: lanes x LM iterations over every request
that completed in the window, over the window's wall from its start to
the end of its last request."""


def read(run):
    if not run.solve_s or run.window is not None:
        return None
    return len(run.solve_s) * run.lanes * run.iters / run.wall_s
