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
- ``conv_slab``: a zero-padded conv on this rank's slab of a volume split
  along D, or of an image split along H (``parallel/mesh.py``): a halo of
  the neighbours' rows in place of the padding along that axis;
  ``conv_transpose_slab`` the same for ``no_antialias_up``'s transposed
  conv (one row of halo above) and the UNet's (one row each side), the
  output cut to the slab's rows.

On slabs (``mesh`` splitting the first spatial axis) ``instance_norm``
takes the whole image's statistics (``parallel.mesh.spatial_sum``),
``pad_nd`` pads at the global ends only and takes a halo inside
(``ops.filters.pad_slab``), and ``Pad``, ``InstanceNorm``, ``BlurDown``
and ``BlurUp`` take the mesh in their forward.

Layout NCHW / NCDHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import init_conv_
from dfmir_tpu_torch.ops.filters import (PAD_MODES, blur_downsample,
                                         blur_filter, blur_upsample,
                                         pad_slab)
from dfmir_tpu_torch.parallel.mesh import (halo_exchange, is_spatial,
                                           spatial_sum)

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


def instance_norm(x, eps: float = 1e-5, mesh=None):
    """Per-sample, per-channel spatial normalisation, no affine parameters;
    statistics in float32 at least (float64 stays float64), the result cast
    back to the input dtype.  ``mesh`` splitting the image: ``x`` is this
    rank's slab, and the statistics are the whole image's, summed over the
    spatial ranks in two passes: the mean first, then the centred sum of
    squares (the biased variance)."""
    stats = torch.promote_types(x.dtype, torch.float32)
    if is_spatial(mesh):
        xs = x.to(stats)
        dims = tuple(range(2, x.ndim))
        n = x[0, 0].numel() * mesh.n_spatial
        mean = spatial_sum(xs.sum(dims, keepdim=True), mesh) / n
        xc = xs - mean
        var = spatial_sum((xc * xc).sum(dims, keepdim=True), mesh) / n
        return (xc / torch.sqrt(var + eps)).to(x.dtype)
    if x[0, 0].numel() == 1:
        # one element a channel: x - mean is 0 (torch's op refuses it)
        xs = x.to(stats)
        return ((xs - xs) * eps ** -0.5).to(x.dtype)
    return F.instance_norm(x.to(stats), eps=eps).to(x.dtype)


def call_in(dtype: torch.dtype, net: nn.Module, *args,
            round_only: bool = False, **kwargs):
    """``net(*args, **kwargs)`` with its float32 parameters cast to
    ``dtype`` for this call alone: the master parameters stay float32, and
    their gradients come back through the cast.  ``kwargs`` reach ``net``
    as they are (``mesh``: netG and netR in bfloat16 on slabs).  Buffers
    are not cast (the blur filters follow their input's dtype).
    ``round_only``: the parameters are rounded to ``dtype`` and computed
    in float32, what flax's dtype promotion does with float32 inputs and
    low-precision kernels."""
    if dtype == torch.float32:
        return net(*args, **kwargs)
    params = {name: p.to(dtype).float() if round_only else p.to(dtype)
              for name, p in net.named_parameters()
              if p.dtype == torch.float32}
    return torch.func.functional_call(net, params, args, kwargs)


def pad_nd(x, pad: int, mode: str = "reflect", mesh=None):
    """Pad every spatial axis of (B, C, *spatial) by ``pad`` on both sides.
    On slabs (``mesh``): the split axis takes ``pad`` rows of halo each
    side, padded at the global ends only, so that each rank holds its
    ``pad``-extended window of the whole padded image."""
    if is_spatial(mesh):
        x = pad_slab(x, pad, pad, mode, mesh)
        return F.pad(x, [pad] * (2 * (x.ndim - 3)) + [0, 0],
                     mode=PAD_MODES[mode])
    return F.pad(x, [pad] * (2 * (x.ndim - 2)), mode=PAD_MODES[mode])


def upsample_nearest(x, scale: int = 2):
    """Nearest-neighbour upsample of every spatial axis."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class InstanceNorm(nn.Module):
    def forward(self, x, mesh=None):
        return instance_norm(x, mesh=mesh)


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

    def forward(self, x, mesh=None):
        return pad_nd(x, self.pad, self.mode, mesh)


def conv_nd(in_ch, out_ch, kernel, stride=1, padding=0, bias=True, *,
            init_type="xavier", init_gain=0.02, ndims=2,
            generator: torch.Generator):
    conv = skip_init(_CONV[ndims], in_ch, out_ch, kernel, stride=stride,
                     padding=padding, bias=bias)
    init_conv_(conv, init_type, init_gain, generator)
    return conv


def conv_slab(conv: nn.Module, x, mesh=None):
    """``conv(x)`` for this rank's slab ``x`` (B, C, D, H, W) of a volume
    split along D, or (B, C, H, W) of an image split along H: the rows of
    the whole output that this slab owns.  The conv's zero padding p along
    the split axis becomes a halo of p rows below and k - s - p above
    (zeros past the ends), and the conv runs with no padding along that
    axis and its own along the others: a stride-1 3^3 conv takes 1 plane
    each side, a stride-2 one 1 plane below and none above.  The slab holds
    s * (its output's rows), starting on a multiple of s.  ``conv(x)``
    itself where ``mesh`` does not split the volume."""
    if not is_spatial(mesh):
        return conv(x)
    (k, *_), (s, *_), (p, *rest) = (conv.kernel_size, conv.stride,
                                    conv.padding)
    x = halo_exchange(x, p, k - s - p, mesh)
    fn = F.conv2d if x.ndim == 4 else F.conv3d
    return fn(x, conv.weight, conv.bias, conv.stride, (0, *rest),
              conv.dilation, conv.groups)


def conv_transpose_nd(in_ch, out_ch, kernel=3, stride=2, padding=1,
                      output_padding=1, bias=True, *, init_type="xavier",
                      init_gain=0.02, ndims=2, generator: torch.Generator):
    conv = skip_init(_CONV_T[ndims], in_ch, out_ch, kernel, stride=stride,
                     padding=padding, output_padding=output_padding,
                     bias=bias)
    init_conv_(conv, init_type, init_gain, generator)
    return conv


# the transposed convs that run on slabs: (kernel, stride, padding, output
# padding) -> the halo (below, above) that output rows 2y and 2y + 1 read
_CONV_T_HALOS = {
    (3, 2, 1, 1): (0, 1),    # no_antialias_up's: input rows y and y + 1
    (4, 2, 1, 0): (1, 1),    # the UNet's up_<i>: input rows y - 1 .. y + 1
}


def conv_transpose_slab(conv: nn.Module, x, mesh=None):
    """``conv(x)`` of a stride-2 transposed conv for this rank's slab ``x``
    of a map split along axis 2: this slab's rows of the whole output,
    twice its own.  Two geometries (``_CONV_T_HALOS``): ``no_antialias_up``'s
    (kernel 3, padding 1, output padding 1), whose output rows 2y and
    2y + 1 read input rows y and y + 1, and the UNet's (kernel 4, padding
    1), whose read y - 1, y and y + 1.  The slab takes that halo (zeros
    past the global ends, where the whole conv reads nothing), the conv
    runs as it is on it, and the output is cut to the slab's own rows: the
    halo below's 2 rows off the front, the rows past the slab's output,
    which would need a row past the halo, off the end.  ``conv(x)`` itself
    where ``mesh`` does not split the map."""
    if not is_spatial(mesh):
        return conv(x)
    (k, *_), (s, *_), (p, *_), (op, *_) = (conv.kernel_size, conv.stride,
                                           conv.padding, conv.output_padding)
    if (k, s, p, op) not in _CONV_T_HALOS:
        raise NotImplementedError(
            f"a transposed conv on slabs takes (kernel, stride, padding, "
            f"output padding) {' or '.join(map(str, _CONV_T_HALOS))} "
            f"(no_antialias_up's, the UNet's), not {(k, s, p, op)}")
    lo, hi = _CONV_T_HALOS[(k, s, p, op)]
    rows = x.shape[2]
    return conv(halo_exchange(x, lo, hi, mesh)).narrow(2, 2 * lo, 2 * rows)


class BlurDown(nn.Module):
    """Antialiased stride-2 downsample (reference Downsample)."""

    def __init__(self, channels: int, filt_size: int = 3, stride: int = 2,
                 pad_type: str = "reflect", ndims: int = 2):
        super().__init__()
        self.filt_size, self.stride, self.pad_type = filt_size, stride, pad_type
        self.register_buffer("filt", blur_filter(filt_size, ndims, channels))

    def forward(self, x, mesh=None):
        return blur_downsample(x, self.filt_size, self.stride, self.pad_type,
                               filt=self.filt, mesh=mesh)


class BlurUp(nn.Module):
    """Antialiased 2x upsample (reference Upsample)."""

    def __init__(self, channels: int, filt_size: int = 4, stride: int = 2,
                 pad_type: str = "repl", ndims: int = 2):
        super().__init__()
        self.filt_size, self.stride, self.pad_type = filt_size, stride, pad_type
        self.register_buffer("filt", blur_filter(
            filt_size, ndims, channels, scale=float(stride ** ndims)))

    def forward(self, x, mesh=None):
        return blur_upsample(x, self.filt_size, self.stride, self.pad_type,
                             filt=self.filt, mesh=mesh)
