"""Antialiased binomial-filter down/upsampling (the reference Downsample /
Upsample blur layers).

- ``blur_downsample``: pad (reflect by default), then a depthwise conv with
  the normalised binomial filter at stride 2.
- ``blur_upsample``: replicate-pad by 1, a stride-2 depthwise transposed
  conv with the binomial filter times stride**nd and padding
  ``1 + (filt_size-1)//2``, then the reference's asymmetric crop: ``[1:]``
  on every spatial axis, and ``[:-1]`` too when the filter size is even.

Layout NCHW (1/2/3 spatial dims).  ``filt``, where given, is the
(C, 1, *k) filter a module keeps as a buffer; otherwise it is built here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PAD_MODES = {"reflect": "reflect", "refl": "reflect",
             "replicate": "replicate", "repl": "replicate", "zero": "constant"}

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def binomial_filter(filt_size: int) -> torch.Tensor:
    """1-D binomial coefficients (unnormalised), e.g. 3 -> [1, 2, 1]."""
    if not 1 <= filt_size <= 7:
        raise ValueError(f"filt_size must be in [1, 7], got {filt_size}")
    return torch.tensor([float(math.comb(filt_size - 1, k))
                         for k in range(filt_size)], dtype=torch.float64)


def blur_filter(filt_size: int, nd: int, channels: int,
                scale: float = 1.0) -> torch.Tensor:
    """Normalised nd-D binomial filter times ``scale``, as a depthwise conv
    weight (channels, 1, *k), float32."""
    a = binomial_filter(filt_size)
    f = a
    for _ in range(nd - 1):
        f = f[..., None] * a
    f = (f / f.sum()).float() * scale
    return f[None, None].repeat((channels, 1) + (1,) * nd)


def _pad(x, widths, pad_type):
    # F.pad lists (lo, hi) from the last axis backwards
    flat = [w for lo_hi in reversed(widths) for w in lo_hi]
    return F.pad(x, flat, mode=PAD_MODES[pad_type])


def blur_downsample(x, filt_size: int = 3, stride: int = 2,
                    pad_type: str = "reflect", pad_off: int = 0, filt=None):
    """Antialiased downsample of (B, C, *spatial)."""
    nd = x.ndim - 2
    lo = (filt_size - 1) // 2 + pad_off
    hi = int(math.ceil((filt_size - 1) / 2)) + pad_off
    if filt_size == 1:
        if pad_off != 0:
            x = _pad(x, [(lo, hi)] * nd, pad_type)
        return x[(slice(None), slice(None)) + (slice(None, None, stride),) * nd]
    x = _pad(x, [(lo, hi)] * nd, pad_type)
    if filt is None:
        filt = blur_filter(filt_size, nd, x.shape[1]).to(x.device)
    return _CONV[nd](x, filt.to(x.dtype), stride=stride, groups=x.shape[1])


def blur_upsample(x, filt_size: int = 4, stride: int = 2,
                  pad_type: str = "repl", filt=None):
    """Antialiased 2x upsample of (B, C, *spatial) (reference Upsample)."""
    nd = x.ndim - 2
    pad_size = (filt_size - 1) // 2
    x = _pad(x, [(1, 1)] * nd, pad_type)
    if filt is None:
        filt = blur_filter(filt_size, nd, x.shape[1],
                           scale=float(stride ** nd)).to(x.device)
    out = _CONV_T[nd](x, filt.to(x.dtype), stride=stride,
                      padding=1 + pad_size, groups=x.shape[1])
    crop = slice(1, None if filt_size % 2 == 1 else -1)
    return out[(slice(None), slice(None)) + (crop,) * nd]
