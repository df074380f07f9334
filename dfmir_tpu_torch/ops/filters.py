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

On slabs (``mesh`` splitting the first spatial axis over ranks,
``parallel/mesh.py``) each rank computes its own rows of the whole
result from its slab and a halo (``pad_slab``: the neighbours' rows
inside, the pad mode at the global ends):

- ``blur_downsample``: output row o reads padded rows [s o, s o + k), so
  a slab (starting on a multiple of s) takes ``lo`` rows below and
  ``k - s - lo`` above: 1 and 0 for the 3-tap filter at stride 2 (the
  whole image's high pad is never read);
- ``blur_upsample``: output rows 2i and 2i + 1 read input rows i - 1 .. i
  + 1, so a slab takes 1 row each side (replicated at the global ends, as
  the whole image's pad), and the transposed conv and the crop are the
  whole image's: the op is equivariant to a shift of the input by one row
  and the output by two.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dfmir_tpu_torch.parallel.mesh import halo_exchange, is_spatial

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


def pad_slab(x, lo: int, hi: int, pad_type: str, mesh):
    """This rank's slab ``x`` (B, C, D, ...) of an image split along axis
    2 with ``lo`` rows before it and ``hi`` after: the neighbours' rows
    inside the image, and past a global end the rows that padding the whole
    image with ``pad_type`` puts there (reflect reads the slab's own rows
    1..p, replicate its edge row, zero zeros)."""
    ext = halo_exchange(x, lo, hi, mesh)
    mode = PAD_MODES[pad_type]
    first, last = mesh.spatial_rank == 0, mesh.spatial_rank == mesh.n_spatial - 1
    if mode == "constant" or not ((first and lo) or (last and hi)):
        return ext
    keep = [0] * (2 * (x.ndim - 3))      # the other spatial axes unpadded
    parts = [F.pad(x, keep + [lo, 0], mode=mode)[:, :, :lo] if first
             else ext[:, :, :lo], x,
             F.pad(x, keep + [0, hi], mode=mode)[:, :, x.shape[2]:] if last
             else ext[:, :, ext.shape[2] - hi:]]
    return torch.cat(parts, dim=2)


def blur_downsample(x, filt_size: int = 3, stride: int = 2,
                    pad_type: str = "reflect", pad_off: int = 0, filt=None,
                    mesh=None):
    """Antialiased downsample of (B, C, *spatial); on slabs with
    ``mesh``."""
    nd = x.ndim - 2
    lo = (filt_size - 1) // 2 + pad_off
    hi = int(math.ceil((filt_size - 1) / 2)) + pad_off
    if is_spatial(mesh):
        if filt_size == 1 or filt_size - stride - lo < 0:
            raise NotImplementedError(
                f"blur_downsample on slabs takes a filter of at least "
                f"stride + its low pad taps, got filt_size {filt_size}")
        x = pad_slab(x, lo, filt_size - stride - lo, pad_type, mesh)
        x = _pad(x, [(0, 0)] + [(lo, hi)] * (nd - 1), pad_type)
        if filt is None:
            filt = blur_filter(filt_size, nd, x.shape[1]).to(x.device)
        return _CONV[nd](x, filt.to(x.dtype), stride=stride,
                         groups=x.shape[1])
    if filt_size == 1:
        if pad_off != 0:
            x = _pad(x, [(lo, hi)] * nd, pad_type)
        return x[(slice(None), slice(None)) + (slice(None, None, stride),) * nd]
    x = _pad(x, [(lo, hi)] * nd, pad_type)
    if filt is None:
        filt = blur_filter(filt_size, nd, x.shape[1]).to(x.device)
    return _CONV[nd](x, filt.to(x.dtype), stride=stride, groups=x.shape[1])


def blur_upsample(x, filt_size: int = 4, stride: int = 2,
                  pad_type: str = "repl", filt=None, mesh=None):
    """Antialiased 2x upsample of (B, C, *spatial) (reference Upsample);
    on slabs with ``mesh``."""
    nd = x.ndim - 2
    pad_size = (filt_size - 1) // 2
    if is_spatial(mesh):
        x = _pad(pad_slab(x, 1, 1, pad_type, mesh),
                 [(0, 0)] + [(1, 1)] * (nd - 1), pad_type)
    else:
        x = _pad(x, [(1, 1)] * nd, pad_type)
    if filt is None:
        filt = blur_filter(filt_size, nd, x.shape[1],
                           scale=float(stride ** nd)).to(x.device)
    out = _CONV_T[nd](x, filt.to(x.dtype), stride=stride,
                      padding=1 + pad_size, groups=x.shape[1])
    crop = slice(1, None if filt_size % 2 == 1 else -1)
    return out[(slice(None), slice(None)) + (crop,) * nd]
