"""Device and dtype policy.

The device is ``cuda`` unless the caller passes ``cpu``; the dtype is
float32 on CUDA and float64 on CPU (the JAX package's CLI rule).  TF32 is
switched off wherever a device is set up: the float32 normal equations are
squared-conditioned, and the JAX package pins ``Precision.HIGHEST`` for the
same reason (``slam_tpu/solver/schur.py:39-43``; the cheaper precision gave
measurably worse iterations there).
"""

from __future__ import annotations

import torch


def require_cuda() -> None:
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "slam_tpu_torch needs a CUDA device (pass device='cpu' for the "
            "plain CPU versions)"
        )


def setup_device(device: str | torch.device | None = None) -> torch.device:
    """Resolve ``device`` (default ``cuda``) and pin full-f32 matmuls."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev

