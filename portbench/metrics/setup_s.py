"""Set-up seconds: from the start of the process to the end of the
warm-up request (import, kernel library, inputs, plan, warm-up)."""


def read(run):
    return run.setup_s
