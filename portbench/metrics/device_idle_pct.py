"""The share of the traced window in which no operation ran on the
device: 100 x (1 - the union of the device operations' intervals over the
window's wall), both from the one window, in percent."""

from portbench.frozen import profile


def read(run):
    if run.window is None or not run.window.kernels:
        return None
    return 100.0 * (1.0 - profile.busy_seconds(run.window)
                    / run.window.seconds)
