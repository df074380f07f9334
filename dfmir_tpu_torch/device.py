"""The default-device rule: CUDA, unless the caller names another device;
and the port's float32 rule: no TF32 in its convolutions and matmuls."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA.

    ``None`` on a machine without CUDA raises: a caller who wants the CPU
    says so with ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def float32_math() -> None:
    """Convolutions and matmuls in float32, as the JAX reference computes
    them: TF32 off in cuDNN and cuBLAS (a fresh torch process convolves in
    TF32).  Every entry point of the port and every spawned rank calls it
    first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
