"""The UNet generator (the JAX package's ``nets/unet_gen.py``; ``--netG
unet_256`` has 8 levels, ``unet_128`` 7).

Encoder: 4x4 stride-2 convs (``down_<i>``), LeakyReLU 0.2 before every
conv but the first, the norm after every conv but the outermost and the
innermost.  Decoder: ReLU -> 4x4 stride-2 transposed conv (``up_<i>``) ->
norm [-> Dropout(0.5) on the middle 8ngf levels with ``use_dropout``] ->
concatenation ``[skip, h]``; Tanh at the output.  Widths ngf, 2ngf,
4ngf, then 8ngf.  Tap ``i`` is the encoder's activation after ``down_i``
(after its norm); a tap outside 0..num_downs-1 raises ``ValueError``.

Dropout is active only in a ``train=True`` forward, its masks drawn from
the explicit ``generator`` given there (``resnet_gen.Dropout``).

``ndims=3`` builds it for (B, C, D, H, W) volumes (``nn.Conv3d`` /
``nn.ConvTranspose3d``), as JAX's ``ConvND`` / ``ConvTransposeTorch`` take
the rank from their input; a side must then be a multiple of
2^num_downs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfmir_tpu_torch.nets.layers import conv_nd, conv_transpose_nd, norm_layer
from dfmir_tpu_torch.nets.resnet_gen import Dropout


class UnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 1, output_nc: int = 1,
                 num_downs: int = 8, ngf: int = 64, norm: str = "instance",
                 use_dropout: bool = False, init_type: str = "xavier",
                 init_gain: float = 0.02, ndims: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_downs, self.use_dropout = num_downs, use_dropout
        self.norm = norm_layer(norm)
        self.dropout = Dropout(0.5)
        init = dict(init_type=init_type, init_gain=init_gain, ndims=ndims,
                    generator=generator)
        self.widths = [ngf * min(2 ** i, 8) for i in range(num_downs)]
        prev = input_nc
        for i, w in enumerate(self.widths):
            setattr(self, f"down_{i}", conv_nd(prev, w, 4, 2, 1, True, **init))
            prev = w
        for i in reversed(range(num_downs)):
            out_ch = output_nc if i == 0 else self.widths[i - 1]
            c_in = self.widths[i] * (1 if i == num_downs - 1 else 2)
            setattr(self, f"up_{i}", conv_transpose_nd(
                c_in, out_ch, 4, 2, 1, 0, True, **init))

    def forward(self, x, layers: Sequence[int] = (), encode_only: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The output; with ``layers``, ``(output, feats)``, or the feats
        alone with ``encode_only`` (the encoder stops at the last tap).
        ``train``: dropout active (with ``use_dropout``), its masks from
        ``generator``, which must then be given."""
        layers = tuple(layers)
        n = self.num_downs
        if layers and (min(layers) < 0 or max(layers) >= n):
            raise ValueError(
                f"UnetGenerator taps index encoder levels 0..{n - 1}; got "
                f"nce_layers={layers}.  Pass e.g. --nce_layers "
                + ",".join(str(i) for i in range(0, n, 2)))
        if not (train and self.use_dropout):
            generator = None
        elif generator is None:
            raise ValueError("a train=True forward with dropout needs a "
                             "generator for its masks")
        skips, feats = [], []
        h = x
        for i in range(n):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            h = getattr(self, f"down_{i}")(h)
            if 0 < i < n - 1:
                h = self.norm(h)
            skips.append(h)
            if i in layers:
                feats.append(h)
                if encode_only and i == max(layers):
                    return feats
        for i in reversed(range(n)):
            h = getattr(self, f"up_{i}")(F.relu(h))
            if i == 0:
                out = torch.tanh(h)
                return (out, feats) if layers else out
            h = self.norm(h)
            if generator is not None and 4 <= i < n - 1:
                h = self.dropout(h, generator)
            h = torch.cat([skips[i - 1], h], dim=1)
        raise AssertionError("unreachable")
