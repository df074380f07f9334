"""Image-similarity metrics (the JAX package's ``metrics/image.py``):
``ncc_metric`` and ``psnr`` on the host in numpy, and ``deepsim``, the
mean cosine similarity of deep features.

The reference's DeepSim takes an ImageNet-pretrained VGG19, whose weights
are not in the repository (nor in the JAX package's), so the extractor is
any callable returning a list of NC(D)HW feature maps, e.g. the
translation generator's encoder taps,
``lambda x: netG(x, layers=(4, 8, 12), encode_only=True)``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


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


def deepsim(a, b, extractor: Callable[..., Sequence],
            eps: float = 1e-8) -> float:
    """The mean over ``extractor``'s maps of the mean cosine similarity,
    over the channels (dim 1), of the features of ``a`` and ``b``."""
    sims = []
    for fa, fb in zip(extractor(a), extractor(b)):
        fa, fb = torch.as_tensor(fa), torch.as_tensor(fb)
        num = (fa * fb).sum(dim=1)
        den = (torch.linalg.vector_norm(fa, dim=1)
               * torch.linalg.vector_norm(fb, dim=1) + eps)
        sims.append(float((num / den).mean()))
    return float(np.mean(sims))
