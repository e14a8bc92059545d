"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (CPU
calls, which take the plain version, count nothing).
"""

from __future__ import annotations


def _wrappers():
    from slam_tpu_torch.ops.gather import gather_rows, scatter_add_rows
    from slam_tpu_torch.ops.linearize import fused_linearize_se2

    return (gather_rows, scatter_add_rows, fused_linearize_se2)


def reset_launches() -> None:
    for fn in _wrappers():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in _wrappers()}
