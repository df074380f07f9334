"""The default-device rule: CUDA, unless the caller names another device."""

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
