"""Shared building blocks, with the reference's semantics.

- ``instance_norm``: InstanceNorm(affine=False, track_running_stats=False),
  eps 1e-5, statistics in float32 at least, biased variance.
- ``pad_nd``: reflect / replicate / zero padding of every spatial axis.
- ``upsample_nearest``: nn.Upsample(scale_factor=2, mode='nearest').
- ``conv_nd`` / ``conv_transpose_nd``: nn.Conv{2,3}d and
  nn.ConvTranspose{2,3}d, initialised from an explicit generator.
- ``BlurDown`` / ``BlurUp``: the antialiased resampling layers, keeping the
  reference's ``filt`` buffer so a reference state_dict loads as it is.
- ``call_in``: a module's call with its float32 parameters cast to a
  compute dtype (the JAX engine's ``_cast_params``).

Layout NCHW / NCDHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import init_conv_
from dfmir_tpu_torch.ops.filters import (PAD_MODES, blur_downsample,
                                         blur_filter, blur_upsample)

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel spatial normalisation, no affine parameters;
    statistics in float32 at least (float64 stays float64), the result cast
    back to the input dtype."""
    stats = torch.promote_types(x.dtype, torch.float32)
    if x[0, 0].numel() == 1:
        # one element a channel: x - mean is 0 (torch's op refuses it)
        xs = x.to(stats)
        return ((xs - xs) * eps ** -0.5).to(x.dtype)
    return F.instance_norm(x.to(stats), eps=eps).to(x.dtype)


def call_in(dtype: torch.dtype, net: nn.Module, *args,
            round_only: bool = False, **kwargs):
    """``net(*args, **kwargs)`` with its float32 parameters cast to
    ``dtype`` for this call alone: the master parameters stay float32, and
    their gradients come back through the cast.  Buffers are not cast
    (the blur filters follow their input's dtype).  ``round_only``: the
    parameters are rounded to ``dtype`` and computed in float32, what
    flax's dtype promotion does with float32 inputs and low-precision
    kernels."""
    if dtype == torch.float32:
        return net(*args, **kwargs)
    params = {name: p.to(dtype).float() if round_only else p.to(dtype)
              for name, p in net.named_parameters()
              if p.dtype == torch.float32}
    return torch.func.functional_call(net, params, args, kwargs)


def pad_nd(x, pad: int, mode: str = "reflect"):
    """Pad every spatial axis of (B, C, *spatial) by ``pad`` on both sides."""
    return F.pad(x, [pad] * (2 * (x.ndim - 2)), mode=PAD_MODES[mode])


def upsample_nearest(x, scale: int = 2):
    """Nearest-neighbour upsample of every spatial axis."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


def norm_layer(norm: str) -> nn.Module:
    if norm == "instance":
        return InstanceNorm()
    if norm == "none":
        return nn.Identity()
    if norm == "batch":
        raise NotImplementedError(
            "batch norm requires mutable state; use --normG instance|none")
    raise NotImplementedError(f"normalization layer [{norm}] is not found")


class Pad(nn.Module):
    def __init__(self, pad: int, mode: str = "reflect"):
        super().__init__()
        self.pad, self.mode = pad, mode

    def forward(self, x):
        return pad_nd(x, self.pad, self.mode)


def conv_nd(in_ch, out_ch, kernel, stride=1, padding=0, bias=True, *,
            init_type="xavier", init_gain=0.02, ndims=2,
            generator: torch.Generator):
    conv = skip_init(_CONV[ndims], in_ch, out_ch, kernel, stride=stride,
                     padding=padding, bias=bias)
    init_conv_(conv, init_type, init_gain, generator)
    return conv


def conv_transpose_nd(in_ch, out_ch, kernel=3, stride=2, padding=1,
                      output_padding=1, bias=True, *, init_type="xavier",
                      init_gain=0.02, ndims=2, generator: torch.Generator):
    conv = skip_init(_CONV_T[ndims], in_ch, out_ch, kernel, stride=stride,
                     padding=padding, output_padding=output_padding,
                     bias=bias)
    init_conv_(conv, init_type, init_gain, generator)
    return conv


class BlurDown(nn.Module):
    """Antialiased stride-2 downsample (reference Downsample)."""

    def __init__(self, channels: int, filt_size: int = 3, stride: int = 2,
                 pad_type: str = "reflect", ndims: int = 2):
        super().__init__()
        self.filt_size, self.stride, self.pad_type = filt_size, stride, pad_type
        self.register_buffer("filt", blur_filter(filt_size, ndims, channels))

    def forward(self, x):
        return blur_downsample(x, self.filt_size, self.stride, self.pad_type,
                               filt=self.filt)


class BlurUp(nn.Module):
    """Antialiased 2x upsample (reference Upsample)."""

    def __init__(self, channels: int, filt_size: int = 4, stride: int = 2,
                 pad_type: str = "repl", ndims: int = 2):
        super().__init__()
        self.filt_size, self.stride, self.pad_type = filt_size, stride, pad_type
        self.register_buffer("filt", blur_filter(
            filt_size, ndims, channels, scale=float(stride ** ndims)))

    def forward(self, x):
        return blur_upsample(x, self.filt_size, self.stride, self.pad_type,
                             filt=self.filt)
