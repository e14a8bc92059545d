"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper counts its kernel launches in one counter, by the wrapper's
name (CPU calls, which take the plain version, count nothing): a stand-in
that replaces a wrapper's name in a module neither hides nor takes its
count.
"""

from __future__ import annotations

#: The counting wrappers' names.
WRAPPERS = ("gather_rows", "scatter_add_rows", "fused_linearize_se2",
            "micro_chol_inv")

_launches = dict.fromkeys(WRAPPERS, 0)


def count_launch(name: str) -> None:
    """One launch of the wrapper ``name``."""
    _launches[name] += 1


def _wrappers():
    from slam_tpu_torch.ops.chol import micro_chol_inv
    from slam_tpu_torch.ops.gather import gather_rows, scatter_add_rows
    from slam_tpu_torch.ops.linearize import fused_linearize_se2

    return (gather_rows, scatter_add_rows, fused_linearize_se2,
            micro_chol_inv)


def reset_launches() -> None:
    for name in WRAPPERS:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)
