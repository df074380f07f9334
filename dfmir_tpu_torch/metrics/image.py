"""Image-similarity metrics, host-side numpy (the JAX package's
``metrics/image.py::ncc_metric`` and ``psnr``; ``deepsim`` is ROADMAP
A13)."""

from __future__ import annotations

import numpy as np


def ncc_metric(a, b, eps: float = 1e-8) -> float:
    """Global (whole-image) normalized cross-correlation in [-1, 1]."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum()) + eps
    return float((a * b).sum() / denom)


def psnr(a, b, data_range: float = 2.0) -> float:
    """Peak signal-to-noise ratio (default range 2.0: images in [-1, 1])."""
    mse = float(np.mean(np.square(np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64))))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))
