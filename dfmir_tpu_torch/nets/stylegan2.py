"""The StyleGAN2 family (the JAX package's ``nets/stylegan2.py``): the
``--netG stylegan2 / smallstylegan2`` generators and the ``--netD
stylegan2 / patchstylegan2 / smallpatchstylegan2 / tilestylegan2``
discriminators, with the synthesis generator and its mapping network.

The math is the JAX package's, in NCHW:

- ``upfirdn2d``: zero-insert by ``up`` (``up - 1`` trailing zeros an
  axis), pad, correlate with the flipped FIR kernel, keep every
  ``down``-th sample; one depthwise conv.
- ``EqualConv`` / ``EqualLinear``: N(0, 1) weights scaled at run time by
  1/sqrt(fan_in) (``lr_mul`` too for the linear layer).
- ``ModulatedConv``: the input scaled by the style, one conv shared by
  the batch, the output demodulated by rsqrt(s^2 . sum(w^2) + 1e-8).  Its
  upsampling is a stride-2 transposed conv (the flipped kernel on a
  dilated input), then the blur.
- ``NoiseInjection`` adds noise only when it is given some: the JAX
  engine passes no ``noise`` rng, so its paths add none, and neither do
  the port's.

Parameters keep the JAX names (``from_rgb.conv.weight``, ``act_bias``,
``modulation``, ...), in torch layouts: a conv weight (out, in, k, k), a
linear weight (out, in).  Each module with its own parameters converts a
JAX subtree with ``flax_state`` (``compat/convert.py``).

On slabs (``mesh`` splitting H over ranks, ``parallel/mesh.py``) the
generator's ops run on this rank's rows, every pad being zeros (a halo,
zeros past the image's ends: ``halo_exchange``), each op's halo derived
from its own pads (``halo``):

- ``upfirdn2d``: ``pad0 // up`` input rows of halo below and
  ``ceil(pad1 / up)`` above stand in for the pad along H; the FIR then
  runs on the slab's window and gives the whole output's rows from
  ``y0 * up / down`` on: its slab where the op maps H to H * up / down,
  and one row more for ConvLayer's x4 blur before a valid stride-2 conv
  (pads (2, 2): H + 1 rows), the rows that conv reads;
- a stride-1 conv with zero padding p: a halo of (p, k - 1 - p) rows;
  the downsampling ConvLayer: the blur's halo, then its valid stride-2
  conv on the blur's window;
- ModulatedConv's upsampling (the stride-2 transposed conv, 2H + 1 rows,
  then the x4 blur): ``(pad0 + k - 1) // 2`` input rows below and
  ``(K - pad0) // 2`` above (1 and 1 for the 3x3 conv and 4-tap blur),
  the transposed conv's rows cut to those the blur reads for the slab's
  own 2 * rows;
- demodulation reads the style alone (ones without one): a per-channel
  constant, the same on every rank.

The StyleGAN2 discriminators have no slab form: the engine runs them on
the gathered image (``nets/discriminators.py::discriminate``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dfmir_tpu_torch.parallel.mesh import halo_exchange, is_spatial

SQRT2 = math.sqrt(2.0)


def make_kernel(k) -> torch.Tensor:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return torch.from_numpy(k / k.sum())


def _zero_insert(x, up: int):
    """(B, C, H, W) -> (B, C, H * up, W * up), x at every ``up``-th sample
    (``up - 1`` trailing zeros an axis)."""
    if up == 1:
        return x
    B, C, H, W = x.shape
    z = x.new_zeros(B, C, H * up, W * up)
    z[:, :, ::up, ::up] = x
    return z


def _fir(x, kernel: torch.Tensor, down: int, rows: Tuple[int, int],
         cols: Tuple[int, int]):
    """The depthwise FIR of (B, C, H, W) zero-padded by ``rows`` (low,
    high) along H and ``cols`` along W, every ``down``-th sample."""
    C = x.shape[1]
    x = F.pad(x, (*cols, *rows))
    w = kernel.flip(0, 1).to(x.device, x.dtype)
    w = w[None, None].expand(C, 1, *kernel.shape)
    return F.conv2d(x, w, stride=down, groups=C)


def fir_halo(up: int, pad: Tuple[int, int]) -> Tuple[int, int]:
    """The input rows (below, above) that ``upfirdn2d`` on a slab takes
    from its neighbours in place of the pad along H."""
    return pad[0] // up, -(-pad[1] // up)


def upfirdn2d(x, kernel: torch.Tensor, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0), mesh=None):
    """(B, C, H, W) up-fir-down: zero-insert by ``up``, pad both axes by
    ``pad`` (low, high), correlate with the flipped kernel, take every
    ``down``-th sample.

    ``mesh`` splitting H: ``x`` is this rank's slab of R rows starting at
    y0 (``down`` dividing ``y0 * up``), and the result the whole output's
    rows from ``y0 * up / down`` on, ``(R * up + pad0 + pad1 - K) // down
    + 1`` of them (K the kernel's taps): the slab's window of the padded
    input, with ``fir_halo`` rows of the neighbours' (zeros past the
    image's ends) in place of the pad along H."""
    if not is_spatial(mesh):
        return _fir(_zero_insert(x, up), kernel, down, pad, pad)
    lo, hi = fir_halo(up, pad)
    rows = x.shape[2]
    x = _zero_insert(halo_exchange(x, lo, hi, mesh), up)
    x = x.narrow(2, lo * up - pad[0], rows * up + pad[0] + pad[1])
    return _fir(x, kernel, down, (0, 0), pad)


def _conv(x, w, bias, stride: int, padding: int, mesh=None):
    """``F.conv2d`` zero-padded by ``padding``; ``mesh`` splitting H: on
    this rank's slab, a halo of (p, k - stride - p) rows in place of the
    padding along H (``conv_halo``).  A conv without padding runs on its
    input as it is (on a slab: the window an ``upfirdn2d`` left it)."""
    if not (is_spatial(mesh) and padding):
        return F.conv2d(x, w, bias, stride, padding)
    x = halo_exchange(x, *conv_halo(w.shape[2], stride, padding), mesh)
    return F.conv2d(x, w, bias, stride, (0, padding))


def conv_halo(kernel: int, stride: int, padding: int) -> Tuple[int, int]:
    """The rows (below, above) a zero-padded conv takes on a slab."""
    return (padding, kernel - stride - padding) if padding else (0, 0)


def _widest(modules) -> Tuple[int, int]:
    """The largest halo below and above of ``modules`` (each ``halo()``)."""
    halos = [m.halo() for m in modules]
    return max(h[0] for h in halos), max(h[1] for h in halos)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2):
    """(x + bias over channels) -> leaky ReLU -> * sqrt(2); ``x`` is
    (B, C, ...) or (B, C)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(x, negative_slope) * scale


def pixel_norm(x, eps: float = 1e-8):
    """x * rsqrt(mean(x^2 over the last axis) + eps)."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def blur_pad(kernel_len: int, factor: int, conv_kernel: int,
             upsample: bool) -> Tuple[int, int]:
    if upsample:
        p = (kernel_len - factor) - (conv_kernel - 1)
        return ((p + 1) // 2 + factor - 1, p // 2 + 1)
    p = (kernel_len - factor) + (conv_kernel - 1)
    return ((p + 1) // 2, p // 2)


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


def _hwio(k) -> torch.Tensor:
    """A JAX (kh, kw, in, out) kernel as torch's (out, in, kh, kw)."""
    return torch.from_numpy(np.array(
        np.transpose(np.asarray(k, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


class EqualConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, use_bias: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1.0 / math.sqrt(in_ch * kernel ** 2)
        self.weight = _normal((out_ch, in_ch, kernel, kernel), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x, mesh=None):
        return _conv(x, self.weight * self.scale, self.bias, self.stride,
                     self.padding, mesh)

    def halo(self) -> Tuple[int, int]:
        return conv_halo(self.weight.shape[2], self.stride, self.padding)

    @staticmethod
    def flax_state(node):
        out = {"weight": _hwio(node["weight"])}
        if "bias" in node:
            out["bias"] = _vec(node["bias"])
        return out


class EqualLinear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: Optional[str] = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.lr_mul, self.activation = lr_mul, activation
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.weight = _normal((out_dim, in_dim), 1.0 / lr_mul, generator)
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init)))
                     if use_bias else None)

    def forward(self, x):
        out = x @ (self.weight * self.scale).T
        b = self.bias * self.lr_mul if self.bias is not None else None
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, b)
        return out + b if b is not None else out

    @staticmethod
    def flax_state(node):
        out = {"weight": _vec(np.asarray(node["weight"]).T)}
        if "bias" in node:
            out["bias"] = _vec(node["bias"])
        return out


class ConvLayer(nn.Module):
    """[blur + stride-2] EqualConv, then bias + fused leaky ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 use_bias: bool = True, activate: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.downsample, self.activate = downsample, activate
        if downsample:
            self.register_buffer("blur", make_kernel(blur_kernel),
                                 persistent=False)
            self.pad = blur_pad(len(blur_kernel), 2, kernel, False)
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel // 2
        self.conv = EqualConv(in_ch, out_ch, kernel, stride, padding,
                              use_bias=use_bias and not activate,
                              generator=generator)
        self.act_bias = (nn.Parameter(torch.zeros(out_ch))
                         if activate and use_bias else None)

    def forward(self, x, mesh=None):
        if self.downsample:
            x = upfirdn2d(x, self.blur, pad=self.pad, mesh=mesh)
        x = self.conv(x, mesh)
        if self.activate:
            if self.act_bias is not None:
                return fused_leaky_relu(x, self.act_bias)
            return F.leaky_relu(x, 0.2) * SQRT2
        return x

    def halo(self) -> Tuple[int, int]:
        """The blur's halo before a downsampling conv, which then runs on
        the blur's window; the conv's own otherwise."""
        return fir_halo(1, self.pad) if self.downsample else self.conv.halo()


class ResBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 downsample: bool = True, skip_gain: float = 1.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.skip_gain = skip_gain
        self.conv1 = ConvLayer(in_ch, in_ch, 3, generator=generator)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=downsample,
                               blur_kernel=blur_kernel, generator=generator)
        self.skip = None
        if in_ch != out_ch or downsample:
            self.skip = ConvLayer(in_ch, out_ch, 1, downsample=downsample,
                                  activate=False, use_bias=False,
                                  generator=generator)

    def forward(self, x, mesh=None):
        h = self.conv2(self.conv1(x, mesh), mesh)
        skip = x if self.skip is None else self.skip(x, mesh)
        return (h * self.skip_gain + skip) / math.sqrt(
            self.skip_gain ** 2 + 1.0)

    def halo(self) -> Tuple[int, int]:
        return _widest([self.conv1, self.conv2]
                       + ([] if self.skip is None else [self.skip]))


class ModulatedConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 style_dim: Optional[int] = None, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel, self.demodulate = kernel, demodulate
        self.upsample, self.downsample = upsample, downsample
        self.scale = 1.0 / math.sqrt(in_ch * kernel ** 2)
        self.weight = _normal((out_ch, in_ch, kernel, kernel), 1.0, generator)
        self.modulation = (EqualLinear(style_dim, in_ch, bias_init=1.0,
                                       generator=generator)
                           if style_dim else None)
        if upsample or downsample:
            k = make_kernel(blur_kernel) * (4.0 if upsample else 1.0)
            self.register_buffer("blur", k, persistent=False)
            self.pad = blur_pad(len(blur_kernel), 2, kernel, upsample)

    def halo(self) -> Tuple[int, int]:
        """The rows (below, above) a slab takes: the upsampling's from the
        transposed conv's kernel and the blur's pads, the blur's before a
        downsampling conv, a plain conv's own."""
        if self.upsample:
            taps = self.blur.shape[0]
            return ((self.pad[0] + self.kernel - 1) // 2,
                    (taps - self.pad[0]) // 2)
        if self.downsample:
            return fir_halo(1, self.pad)
        return conv_halo(self.kernel, 1, self.kernel // 2)

    def _upsample(self, x, w, mesh):
        """The stride-2 transposed conv (2H + 1 rows) and the x4 blur (2H);
        on a slab of R rows: the transposed conv of the slab and its halo,
        cut to the 2R + K - 1 rows that the blur reads for the slab's own
        2R rows, the blur then padded along W alone."""
        wt = w.transpose(0, 1)
        if not is_spatial(mesh):
            out = F.conv_transpose2d(x, wt, stride=2)
            return upfirdn2d(out, self.blur, pad=self.pad)
        lo, hi = self.halo()
        rows = x.shape[2]
        out = F.conv_transpose2d(halo_exchange(x, lo, hi, mesh), wt,
                                 stride=2)
        out = out.narrow(2, 2 * lo - self.pad[0],
                         2 * rows + self.blur.shape[0] - 1)
        return _fir(out, self.blur, 1, (0, 0), self.pad)

    def forward(self, x, style=None, mesh=None):
        B, C = x.shape[:2]
        w = self.weight * self.scale
        if style is not None and self.modulation is not None:
            s = self.modulation(style)
        else:
            s = x.new_ones(B, C)
        x = x * s[:, :, None, None]
        if self.upsample:
            out = self._upsample(x, w, mesh)
        elif self.downsample:
            out = F.conv2d(upfirdn2d(x, self.blur, pad=self.pad, mesh=mesh),
                           w, stride=2)
        else:
            out = _conv(x, w, None, 1, self.kernel // 2, mesh)
        if self.demodulate:
            w2 = w.square().sum(dim=(2, 3))                  # (out, in)
            demod = torch.rsqrt(s.square() @ w2.T + 1e-8)    # (B, out)
            out = out * demod[:, :, None, None]
        return out

    @staticmethod
    def flax_state(node):
        return {"weight": _hwio(node["weight"])}


class NoiseInjection(nn.Module):
    """x + weight * noise; without ``noise``, x (no noise is drawn)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, noise=None):
        if noise is None:
            return x
        return x + self.weight * noise


class StyledConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 style_dim: Optional[int] = None, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 demodulate: bool = True, inject_noise: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, kernel, style_dim,
                                  demodulate=demodulate, upsample=upsample,
                                  blur_kernel=blur_kernel,
                                  generator=generator)
        self.noise = NoiseInjection() if inject_noise else None
        self.act_bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x, style=None, noise=None, mesh=None):
        out = self.conv(x, style, mesh)
        if self.noise is not None:
            out = self.noise(out, noise)
        return fused_leaky_relu(out, self.act_bias)

    def halo(self) -> Tuple[int, int]:
        return self.conv.halo()


class ToRGB(nn.Module):
    def __init__(self, in_ch: int, style_dim: int, out_channels: int = 3,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1), *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_channels, 1, style_dim,
                                  demodulate=False, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("blur", make_kernel(blur_kernel) * 4.0,
                             persistent=False)
        p = len(blur_kernel) - 2
        self.pad = ((p + 1) // 2 + 1, p // 2)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias[None, :, None, None]
        if skip is not None:
            out = out + upfirdn2d(skip, self.blur, up=2, pad=self.pad)
        return out


def g_channels(ngf: int):
    m = ngf / 32
    return {r: (min(512, int(round(c * m))) if r <= 32
                else int(round(c * m)))
            for r, c in ((4, 4096), (8, 2048), (16, 1024), (32, 512),
                         (64, 256), (128, 128), (256, 64), (512, 32),
                         (1024, 16))}


def d_channels(ndf: int):
    m = ndf / 64
    return {r: (min(384, int(c * m)) if r <= 32 else int(c * m))
            for r, c in ((4, 4096), (8, 2048), (16, 1024), (32, 512),
                         (64, 256), (128, 128), (256, 64), (512, 32),
                         (1024, 16))}


class StyleGAN2Encoder(nn.Module):
    """ops: 0 identity, 1 from_rgb, then ``num_downsampling`` down ResBlocks
    and ``n_blocks // 2`` ResBlocks; ``layers`` index them (-1 the last)."""

    def __init__(self, input_nc: int = 1, ngf: int = 64, n_blocks: int = 6,
                 size: int = 256, num_downsampling: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        ch = g_channels(ngf)
        cur = size
        self.from_rgb = ConvLayer(input_nc, ch[cur], 1, generator=generator)
        self.n_down, self.n_res = num_downsampling, n_blocks // 2
        for i in range(num_downsampling):
            setattr(self, f"down_{i}", ResBlock(ch[cur], ch[cur // 2],
                                                downsample=True,
                                                generator=generator))
            cur //= 2
        for i in range(self.n_res):
            setattr(self, f"res_{i}", ResBlock(ch[cur], ch[cur],
                                               downsample=False,
                                               generator=generator))
        self.out_channels = ch[cur]

    def ops(self):
        return ([nn.Identity(), self.from_rgb]
                + [getattr(self, f"down_{i}") for i in range(self.n_down)]
                + [getattr(self, f"res_{i}") for i in range(self.n_res)])

    def forward(self, x, layers: Sequence[int] = (),
                get_features: bool = False, encode_only: bool = False,
                mesh=None):
        """``encode_only`` stops after the last tap and returns the taps
        (what a full pass would tap: later ops never feed them).
        ``mesh`` splitting H: ``x`` and the taps are this rank's rows."""
        ops = self.ops()
        layers = list(layers)
        if -1 in layers:
            layers.append(len(ops) - 1)
        feats = []
        h = x
        for i, op in enumerate(ops):
            h = op(h) if isinstance(op, nn.Identity) else op(h, mesh)
            if i in layers:
                feats.append(h)
            if encode_only and layers and i == max(layers):
                return feats
        if encode_only:
            return feats
        return (h, feats) if get_features else h


class StyleGAN2Decoder(nn.Module):
    def __init__(self, output_nc: int = 1, ngf: int = 64, n_blocks: int = 6,
                 size: int = 256, num_downsampling: int = 1,
                 inject_noise: bool = True, *, generator: torch.Generator):
        super().__init__()
        ch = g_channels(ngf)
        cur = size // (2 ** num_downsampling)
        self.n_res, self.n_up = n_blocks // 2, num_downsampling
        for i in range(self.n_res):
            setattr(self, f"res_{i}", ResBlock(ch[cur], ch[cur],
                                               downsample=False,
                                               generator=generator))
        for i in range(num_downsampling):
            setattr(self, f"up_{i}", StyledConv(
                ch[cur], ch[cur * 2], 3, upsample=True,
                inject_noise=inject_noise, generator=generator))
            cur *= 2
        self.to_rgb = ConvLayer(ch[cur], output_nc, 1, generator=generator)

    def forward(self, x, mesh=None):
        h = x
        for i in range(self.n_res):
            h = getattr(self, f"res_{i}")(h, mesh)
        for i in range(self.n_up):
            h = getattr(self, f"up_{i}")(h, mesh=mesh)
        return self.to_rgb(h, mesh)


class StyleGAN2Generator(nn.Module):
    """The encoder/decoder translator with encoder taps (``stylegan2``;
    ``small``: ``smallstylegan2``, no noise injection in the decoder).
    ``train`` and ``generator`` are taken and ignored: the net has no
    dropout."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 6, size: int = 256,
                 num_downsampling: int = 1, small: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.encoder = StyleGAN2Encoder(input_nc, ngf, n_blocks, size,
                                        num_downsampling, generator=generator)
        self.decoder = StyleGAN2Decoder(output_nc, ngf, n_blocks, size,
                                        num_downsampling,
                                        inject_noise=not small,
                                        generator=generator)

    def forward(self, x, layers: Sequence[int] = (),
                encode_only: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None):
        """``mesh`` splitting H: ``x``, the output and each tap are this
        rank's rows of the whole image's."""
        if encode_only:
            return self.encoder(x, layers, encode_only=True, mesh=mesh)
        feat, feats = self.encoder(x, layers, get_features=True, mesh=mesh)
        fake = self.decoder(feat, mesh)
        return (fake, feats) if layers else fake

    def slab_level_pads(self) -> List[int]:
        """The largest halo (below or above) of an op at each level of the
        generator (level l: after l downsamplings), from each op's pads:
        the rows a slab must hold there
        (``parallel.mesh.check_joint_slabs``)."""
        enc, dec = self.encoder, self.decoder
        pads = [0] * (enc.n_down + 1)
        level = 0

        def take(module):
            pads[level] = max(pads[level], *module.halo())
        take(enc.from_rgb)
        for i in range(enc.n_down):
            take(getattr(enc, f"down_{i}"))
            level += 1
        for block in ([getattr(enc, f"res_{i}") for i in range(enc.n_res)]
                      + [getattr(dec, f"res_{i}") for i in range(dec.n_res)]):
            take(block)
        for i in range(dec.n_up):
            take(getattr(dec, f"up_{i}"))
            level -= 1
        take(dec.to_rgb)
        return pads

    def tap_pads(self, layers: Sequence[int]) -> List[int]:
        """0 for every tap: each is an op's output (op 0 the input), whose
        rows on a slab are the slab's own."""
        return [0] * len(layers)


def _disc_out_size(n: int, blocks: int) -> int:
    """Spatial size after ``blocks`` blur + stride-2 3x3 downsamplings."""
    for _ in range(blocks):
        n = (n + 1 - 3) // 2 + 1
    return n


class StyleGAN2Discriminator(nn.Module):
    """``size`` sets the channels and the number of ResBlocks, as in JAX
    (whose engine leaves it at 256 whatever the crop); ``in_size`` is the
    input's side, which sets ``linear_0``'s input width (flax infers it
    from the input)."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, size: int = 256,
                 patch: bool = False, small_patch: bool = False,
                 in_size: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        ch = d_channels(ndf)
        self.head = patch or small_patch
        self.from_rgb = ConvLayer(input_nc, ch[size], 1, generator=generator)
        log_size = int(math.log2(size))
        final_log2 = 4 if small_patch else (3 if patch else 2)
        self.levels = list(range(log_size, final_log2, -1))
        prev = ch[size]
        for i in self.levels:
            setattr(self, f"res_{i}", ResBlock(prev, ch[2 ** (i - 1)],
                                               generator=generator))
            prev = ch[2 ** (i - 1)]
        self.final_conv = ConvLayer(prev, ch[4], 3, generator=generator)
        if self.head:
            self.final_linear = ConvLayer(ch[4], 1, 3, use_bias=False,
                                          activate=False, generator=generator)
        else:
            side = _disc_out_size(in_size or size, len(self.levels))
            self.linear_0 = EqualLinear(ch[4] * side * side, ch[4],
                                        activation="fused_lrelu",
                                        generator=generator)
            self.linear_1 = EqualLinear(ch[4], 1, generator=generator)

    def forward(self, x):
        h = self.from_rgb(x)
        for i in self.levels:
            h = getattr(self, f"res_{i}")(h)
        h = self.final_conv(h)
        if self.head:
            return self.final_linear(h)
        # flattened in JAX's (H, W, C) order
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return self.linear_1(self.linear_0(h))


class TileStyleGAN2Discriminator(nn.Module):
    """``patch_size`` tiles folded into the batch, each scored by a
    StyleGAN2Discriminator of that size."""

    def __init__(self, input_nc: int = 1, ndf: int = 64,
                 patch_size: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.patch_size = patch_size
        self.disc = StyleGAN2Discriminator(input_nc, ndf, size=patch_size,
                                           generator=generator)

    def forward(self, x):
        B, C, H, W = x.shape
        s = self.patch_size
        Y, X = H // s, W // s
        x = x.reshape(B, C, Y, s, X, s)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(B * Y * X, C, s, s)
        return self.disc(x)


class MappingNetwork(nn.Module):
    """z -> w: pixel norm, then ``n_mlp`` equalised-lr linear layers."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 8,
                 lr_mlp: float = 0.01, *, generator: torch.Generator):
        super().__init__()
        self.n_mlp = n_mlp
        for i in range(n_mlp):
            setattr(self, f"mlp_{i}", EqualLinear(
                style_dim, style_dim, lr_mul=lr_mlp,
                activation="fused_lrelu", generator=generator))

    def forward(self, z):
        h = pixel_norm(z)
        for i in range(self.n_mlp):
            h = getattr(self, f"mlp_{i}")(h)
        return h


class StyleGAN2SynthesisGenerator(nn.Module):
    """The style-based generator: a learned 4x4 constant, a pyramid of
    styled convs with ToRGB skips."""

    def __init__(self, size: int = 256, style_dim: int = 512, ngf: int = 64,
                 out_channels: int = 3, *, generator: torch.Generator):
        super().__init__()
        ch = g_channels(ngf * 2)
        self.log_size = int(math.log2(size))
        self.mapping = MappingNetwork(style_dim, generator=generator)
        self.const_input = _normal((1, ch[4], 4, 4), 1.0, generator)
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim,
                                generator=generator)
        self.to_rgb1 = ToRGB(ch[4], style_dim, out_channels,
                             generator=generator)
        prev, cur = ch[4], 4
        for i in range(3, self.log_size + 1):
            cur *= 2
            setattr(self, f"conv_{i}_up", StyledConv(
                prev, ch[cur], 3, style_dim, upsample=True,
                generator=generator))
            setattr(self, f"conv_{i}", StyledConv(ch[cur], ch[cur], 3,
                                                  style_dim,
                                                  generator=generator))
            setattr(self, f"to_rgb_{i}", ToRGB(ch[cur], style_dim,
                                               out_channels,
                                               generator=generator))
            prev = ch[cur]

    def forward(self, z, input_is_latent: bool = False):
        w = z if input_is_latent else self.mapping(z)
        h = self.const_input.expand(w.shape[0], -1, -1, -1)
        h = self.conv1(h, w)
        skip = self.to_rgb1(h, w)
        for i in range(3, self.log_size + 1):
            h = getattr(self, f"conv_{i}_up")(h, w)
            h = getattr(self, f"conv_{i}")(h, w)
            skip = getattr(self, f"to_rgb_{i}")(h, w, skip)
        return skip

    @staticmethod
    def flax_state(node):
        return {"const_input": torch.from_numpy(np.array(
            np.transpose(np.asarray(node["const_input"], np.float32),
                         (0, 3, 1, 2))))}
