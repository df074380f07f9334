"""Image-similarity losses of the 2-D train step.

- ``masked_l1``: the reference calculate_L1_loss, ``sum(|a - b| * mask) /
  sum(mask)``, 0 for an empty mask, the plain mean without a mask.
- ``masked_l2``: the same reduction of the squared difference.
- ``mse_loss``.

Windowed NCC (``ncc_loss`` / ``ncc_map``, with the summed-area-table path)
comes with the 3-D slice.
"""

from __future__ import annotations

import torch


def _masked_mean(res, mask):
    if mask is None:
        return res.mean()
    mask = mask.to(res.dtype)
    denom = mask.sum()
    val = (res * mask).sum() / denom.clamp_min(1.0)
    return torch.where(denom == 0, torch.zeros_like(val), val)


def masked_l1(src, tgt, mask=None):
    return _masked_mean((src - tgt).abs(), mask)


def masked_l2(src, tgt, mask=None):
    return _masked_mean((src - tgt).square(), mask)


def mse_loss(prediction, target):
    return (prediction - target).square().mean()
