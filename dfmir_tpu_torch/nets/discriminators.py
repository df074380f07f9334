"""The discriminators of ``--netD`` (the JAX package's
``nets/discriminators.py``; the reference networks.py's), for
``--lambda_GAN > 0``:

- ``NLayerDiscriminator``: the 70x70 PatchGAN; 4x4 convs with padding 1,
  LeakyReLU 0.2, instance norm after every conv but the first and the
  last; each downsampling is a stride-1 conv and a binomial blur-down
  (``ops/filters.py::blur_downsample``), or with ``no_antialias`` a
  stride-2 conv.  Its Sequential indices are the reference's
  (``model.<i>.*``, as ``dfmir_tpu/compat/torch_ref.py``'s
  ``RefNLayerDiscriminator``).
- ``PixelDiscriminator``: the 1x1-conv pixelGAN (``net.<i>.*``).
- ``PatchDiscriminator``: the input cut into 16x16 tiles folded into the
  batch, each scored by a 2-layer NLayer net.

Every conv has a bias, and every op is per-sample (instance norm or
none), as in the JAX package.  Layout NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dfmir_tpu_torch.nets.layers import BlurDown, conv_nd, norm_layer


def _lrelu():
    return nn.LeakyReLU(0.2)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 norm: str = "instance", no_antialias: bool = False,
                 init_type: str = "xavier", init_gain: float = 0.02, *,
                 generator: torch.Generator):
        super().__init__()
        init = dict(init_type=init_type, init_gain=init_gain,
                    generator=generator)
        stride = 2 if no_antialias else 1

        def conv(c_in, c_out, s):
            return conv_nd(c_in, c_out, 4, s, 1, True, **init)

        def blur(ch):
            return [] if no_antialias else [BlurDown(ch)]

        seq = [conv(input_nc, ndf, stride), _lrelu()] + blur(ndf)
        mult = 1
        for n in range(1, n_layers):
            mult_prev, mult = mult, min(2 ** n, 8)
            seq += [conv(ndf * mult_prev, ndf * mult, stride),
                    norm_layer(norm), _lrelu()] + blur(ndf * mult)
        mult_prev, mult = mult, min(2 ** n_layers, 8)
        seq += [conv(ndf * mult_prev, ndf * mult, 1), norm_layer(norm),
                _lrelu(), conv(ndf * mult, 1, 1)]
        self.model = nn.Sequential(*seq)

    def forward(self, x):
        return self.model(x)


class PixelDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 1, ndf: int = 64,
                 norm: str = "instance", init_type: str = "xavier",
                 init_gain: float = 0.02, *, generator: torch.Generator):
        super().__init__()
        init = dict(init_type=init_type, init_gain=init_gain,
                    generator=generator)
        self.net = nn.Sequential(
            conv_nd(input_nc, ndf, 1, 1, 0, True, **init), _lrelu(),
            conv_nd(ndf, ndf * 2, 1, 1, 0, True, **init), norm_layer(norm),
            _lrelu(), conv_nd(ndf * 2, 1, 1, 1, 0, True, **init))

    def forward(self, x):
        return self.net(x)


class PatchDiscriminator(NLayerDiscriminator):
    """16x16 tiles folded into the batch, scored by a 2-layer NLayer net."""

    def __init__(self, input_nc: int = 1, ndf: int = 64,
                 norm: str = "instance", no_antialias: bool = False,
                 init_type: str = "xavier", init_gain: float = 0.02, *,
                 generator: torch.Generator, tile: int = 16):
        super().__init__(input_nc, ndf, 2, norm, no_antialias, init_type,
                         init_gain, generator=generator)
        self.tile = tile

    def forward(self, x):
        B, C, H, W = x.shape
        s = self.tile
        Y, X = H // s, W // s
        x = x.reshape(B, C, Y, s, X, s).permute(0, 2, 4, 1, 3, 5)
        return super().forward(x.reshape(B * Y * X, C, s, s))
