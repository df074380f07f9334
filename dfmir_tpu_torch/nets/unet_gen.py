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

On slabs (``mesh`` splitting axis 2, H at 2-D and D at 3-D,
``parallel/mesh.py``) level l (the map after l strided convs, l = 0 the
input) splits while n_spatial divides its rows, as netR's UNet's levels
do (``nets/vxm.py``): the convs there take a halo of a row each side
(``conv_slab``, ``conv_transpose_slab``), the norms the whole map's
statistics.  The first level that does not split
(``parallel.mesh.first_whole_level``; the innermost's single row always
stops splitting) and every coarser one run whole on every spatial rank:
the strided conv into it takes the finer map gathered (``gather_slabs``),
and on the way up the transposed conv out of it is cut to this rank's rows
(``slab_slice``) before the skip concat.  Tap i is level i + 1: this
rank's rows where that level splits, the whole map where it is gathered
(``whole_taps``).  Dropout keeps this rank's rows of the whole map's mask
at a level that splits, the whole mask where it is gathered: every
spatial rank draws what one process draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfmir_tpu_torch.nets.layers import (InstanceNorm, conv_nd, conv_slab,
                                         conv_transpose_nd,
                                         conv_transpose_slab, norm_layer)
from dfmir_tpu_torch.nets.resnet_gen import Dropout
from dfmir_tpu_torch.parallel.mesh import (first_whole_level, gather_slabs,
                                           is_spatial, slab_slice)


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

    def slab_level_pads(self) -> List[int]:
        """The rows a slab must exceed at each level (0..num_downs) when the
        level splits (``parallel.mesh.check_joint_slabs`` with
        ``gathered``): 0, every pad being a zero pad whose halo of one row
        a slab of one row holds."""
        return [0] * (self.num_downs + 1)

    def tap_pads(self, layers: Sequence[int]) -> List[int]:
        """No tap carries rows past the map's ends (zero pads only)."""
        return [0] * len(layers)

    def whole_taps(self, layers: Sequence[int], extent: int,
                   n_spatial: int) -> List[bool]:
        """Which taps are whole on every spatial rank for an input of
        ``extent`` rows over ``n_spatial`` ranks: tap i is level i + 1,
        whole from netG's first level that does not split."""
        whole = first_whole_level(extent, n_spatial, self.num_downs)
        return [whole is not None and i + 1 >= whole for i in layers]

    def _norm(self, h, mesh):
        """The norm, over the whole map's statistics on slabs."""
        if isinstance(self.norm, InstanceNorm):
            return self.norm(h, mesh)
        return self.norm(h)

    def forward(self, x, layers: Sequence[int] = (), encode_only: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None):
        """The output; with ``layers``, ``(output, feats)``, or the feats
        alone with ``encode_only`` (the encoder stops at the last tap).
        ``train``: dropout active (with ``use_dropout``), its masks from
        ``generator``, which must then be given.  ``mesh`` splitting the
        image: ``x`` and the output are this rank's slabs, and each tap its
        rows or, at a gathered level, the whole map."""
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
        whole = None
        if is_spatial(mesh):
            whole = first_whole_level(x.shape[2] * mesh.n_spatial,
                                      mesh.n_spatial, n)

        def at(level):
            """The mesh where ``level`` runs on slabs, else None."""
            return mesh if whole is None or level < whole else None
        skips, feats = [], []
        h = x
        for i in range(n):
            if i > 0:
                h = F.leaky_relu(h, 0.2)
            if i + 1 == whole:
                h = gather_slabs(h, mesh)
            h = conv_slab(getattr(self, f"down_{i}"), h, at(i + 1))
            if 0 < i < n - 1:
                h = self._norm(h, at(i + 1))
            skips.append(h)
            if i in layers:
                feats.append(h)
                if encode_only and i == max(layers):
                    return feats
        for i in reversed(range(n)):
            h = conv_transpose_slab(getattr(self, f"up_{i}"), F.relu(h),
                                    at(i + 1))
            if i + 1 == whole:
                h = slab_slice(h, mesh.spatial_rank, mesh.n_spatial)
            if i == 0:
                out = torch.tanh(h)
                return (out, feats) if layers else out
            h = self._norm(h, at(i))
            if generator is not None and 4 <= i < n - 1:
                h = self.dropout(h, generator, at(i))
            h = torch.cat([skips[i - 1], h], dim=1)
        raise AssertionError("unreachable")
