"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper counts its kernel launches in one counter, by the wrapper's
name (CPU calls, which take the plain version, count nothing): a stand-in
that replaces a wrapper's name in a module neither hides nor takes its
count.
"""

from __future__ import annotations

#: The counting wrappers' names.
WRAPPERS = ("gather_rows", "scatter_add_rows", "fused_linearize_se2",
            "micro_chol_inv", "stack_cholesky")

_launches = dict.fromkeys(WRAPPERS, 0)


def count_launch(name: str, kernels: int = 1) -> None:
    """One launch of the wrapper ``name``, or ``kernels`` device kernels
    that one call of it launched."""
    _launches[name] += kernels


def _wrappers():
    from slam_tpu_torch.ops.chol import micro_chol_inv
    from slam_tpu_torch.ops.gather import gather_rows, scatter_add_rows
    from slam_tpu_torch.ops.linearize import fused_linearize_se2
    from slam_tpu_torch.ops.stack_chol import stack_cholesky

    return (gather_rows, scatter_add_rows, fused_linearize_se2,
            micro_chol_inv, stack_cholesky)


def reset_launches() -> None:
    for name in WRAPPERS:
        _launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_launches)
