"""The netF heads besides PatchSampleF (the JAX package's
``nets/feature_nets.py``), on NCHW feature maps (NCDHW at ``ndims=3``):

- ``PoolingF`` (``global_pool``): the max over the first two spatial
  axes, L2 norm over channels, one row a map: (B, C) at 2-D.  At 3-D
  this is what JAX computes: its ``max(axis=(1, 2))`` of (B, D, H, W, C)
  pools D and H and keeps W, and the engine's ``reshape(B, -1)`` makes
  one row of W * C a volume, in (W, C) order.
- ``ReshapeF`` (``reshape``): a 4x4 adaptive mean, the 16 locations into
  the batch, L2 norm: (B * 16, C), rows in (b, i, j) order (2-D only: JAX
  unpacks four dims).
- ``StridedConvF`` (``strided_conv``): per tapped map of (C, side), ``n_down
  = max(rint(log2(side / 32)), 0)`` stride-2 VALID 3x3 convs with ReLU
  (channels halving down to 64), a VALID 3x3 conv to 64 channels, minus
  an EMA buffer ``ema_<i>`` of (64, *spatial), [instance norm,] L2 norm
  over channels; ``ndims=3`` builds 3x3x3 convs, ``side`` then the tap's
  D (JAX reads ``shape[1]`` of its NDHWC tap).  The engine never updates
  the EMA (JAX's ``update_ema=False``); with ``update_ema=True`` the
  buffer moves by 0.001 toward the batch mean, and the output subtracts
  the moved value, as JAX's ``stats`` collection does.  Parameter names
  are JAX's: ``conv_<i>_<d>``, ``conv_<i>_out``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dfmir_tpu_torch.nets.layers import conv_nd, instance_norm
from dfmir_tpu_torch.nets.patch_sample import l2_normalize


def adaptive_pool(x, out_size: int, reduce: str = "mean"):
    """torch's AdaptiveAvg/MaxPool2d on (B, C, H, W): bin i of an axis of
    n spans [floor(i n / out), ceil((i + 1) n / out))."""
    H, W = x.shape[2:]

    def bins(n):
        return [(int(np.floor(i * n / out_size)),
                 int(np.ceil((i + 1) * n / out_size)))
                for i in range(out_size)]

    def red(t):
        return t.mean(dim=(2, 3)) if reduce == "mean" else t.amax(dim=(2, 3))

    rows = [torch.stack([red(x[:, :, r0:r1, c0:c1]) for c0, c1 in bins(W)],
                        dim=-1) for r0, r1 in bins(H)]
    return torch.stack(rows, dim=-2)


def channels_last_rows(x):
    """(B, C, *spatial) -> (B * prod(spatial), C), rows in (b, *spatial)
    order (JAX's ``reshape(-1, C)`` of an NHWC map)."""
    return x.movedim(1, -1).reshape(-1, x.shape[1])


class PoolingF(nn.Module):
    def forward(self, x):
        """(B, C, H, W) -> (B, C); (B, C, D, H, W) -> (B, W * C)."""
        h = l2_normalize(x.amax(dim=(2, 3)).movedim(1, -1))
        return h.reshape(x.shape[0], -1)


class ReshapeF(nn.Module):
    def forward(self, x):
        return l2_normalize(channels_last_rows(adaptive_pool(x, 4)))


def strided_n_down(H: int) -> int:
    return max(int(np.rint(np.log2(H / 32))), 0)


class StridedConvF(nn.Module):
    """specs: per tapped layer (channels, side of its cube)."""

    def __init__(self, specs: Sequence[Tuple[int, int]],
                 init_type: str = "normal", init_gain: float = 0.02,
                 ndims: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.specs = [tuple(s) for s in specs]
        init = dict(init_type=init_type, init_gain=init_gain, ndims=ndims,
                    generator=generator)
        self.n_down = []
        for i, (C, H) in enumerate(self.specs):
            n_down = strided_n_down(H)
            ch, side = C, H
            for d in range(n_down):
                out = max(ch // 2, 64)
                setattr(self, f"conv_{i}_{d}",
                        conv_nd(ch, out, 3, 2, 0, True, **init))
                ch, side = out, (side - 3) // 2 + 1
            setattr(self, f"conv_{i}_out",
                    conv_nd(ch, 64, 3, 1, 0, True, **init))
            side -= 2
            self.register_buffer(f"ema_{i}",
                                 torch.zeros((64,) + (side,) * ndims))
            self.n_down.append(n_down)

    def forward(self, feats: Sequence[torch.Tensor],
                use_instance_norm: bool = False,
                update_ema: bool = False) -> List[torch.Tensor]:
        """feats: list of (B, C, *spatial).  Returns one (B, 64,
        *spatial') map a tap, L2-normalised over channels."""
        outs = []
        for i, feat in enumerate(feats):
            h = feat
            for d in range(self.n_down[i]):
                h = torch.relu(getattr(self, f"conv_{i}_{d}")(h))
            h = getattr(self, f"conv_{i}_out")(h)
            ema = getattr(self, f"ema_{i}")
            if update_ema:
                ema = ema * 0.999 + h.mean(dim=0) * 0.001
                getattr(self, f"ema_{i}").copy_(ema.detach())
            h = h - ema
            if use_instance_norm:
                h = instance_norm(h)
            outs.append(l2_normalize(h.movedim(1, -1)).movedim(-1, 1))
        return outs
