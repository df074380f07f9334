"""Learned affine registration (the JAX package's ``nets/affine_net.py``;
the reference's AffineTransformer): a strided-conv localisation tower
regresses a (nd, nd + 1) pixel-space matrix from the stacked (moving,
fixed) pair, and the moving image is resampled under it.

2-D and 3-D from one module.  ``fc_theta`` starts at zero, so training
starts from the identity (the matrix is ``theta + I`` about the image
centre, ``ops.affine.centered_affine``).  Module names are flax's (``loc``,
``loc_{i}``, ``fc_0``, ``fc_theta``), so ``compat.convert.state_from_flax``
maps a JAX tree.  flax flattens the tower's channels-last map before
``fc_0``; the port flattens its NCHW map, and ``fc_0`` permutes the JAX
kernel's rows once, where the weights are bridged
(``FlatDense.flax_state``), not on every call.

The port needs the input's spatial size up front (``inshape``) to size
``fc_0``; flax infers it at ``init``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import lecun_normal_
from dfmir_tpu_torch.nets.layers import conv_nd
from dfmir_tpu_torch.ops.affine import (affine_to_flow, affine_warp,
                                        centered_affine)


class FlatDense(nn.Linear):
    """``nn.Linear`` on an NC(D)HW map flattened as it lies, whose flax
    twin sees the same map channels-last: ``flax_state`` reorders the
    kernel's rows from (*spatial, C) to (C, *spatial)."""

    def __init__(self, channels: int, spatial: Sequence[int], out: int,
                 device=None):
        super().__init__(channels * math.prod(spatial), out, device=device)
        self.channels, self.spatial = channels, tuple(spatial)

    def flax_state(self, node):
        k = np.asarray(node["kernel"])
        k = k.reshape(*self.spatial, self.channels, self.out_features)
        k = np.moveaxis(k, -2, 0).reshape(self.in_features,
                                          self.out_features)
        return {"weight": torch.from_numpy(np.array(k.T, np.float32)),
                "bias": torch.from_numpy(np.array(node["bias"],
                                                  np.float32))}


class AffineLocalizationNet(nn.Module):
    """Per-sample (nd, nd + 1) pixel-space affine matrices of (moving,
    fixed) pairs of ``inshape`` and ``in_channels`` channels together."""

    def __init__(self, inshape: Sequence[int], ndims: int = 2,
                 enc_features: Sequence[int] = (16, 32, 32),
                 in_channels: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.inshape, self.ndims = tuple(inshape), ndims
        spatial, c = self.inshape, in_channels
        for i, nf in enumerate(enc_features):
            setattr(self, f"loc_{i}", conv_nd(c, nf, 3, stride=2, padding=1,
                                              ndims=ndims,
                                              generator=generator))
            spatial, c = tuple((s - 1) // 2 + 1 for s in spatial), nf
        self.n_convs = len(enc_features)
        self.fc_0 = skip_init(FlatDense, c, spatial, 32)
        lecun_normal_(self.fc_0.weight, self.fc_0.in_features, generator)
        nn.init.zeros_(self.fc_0.bias)
        self.fc_theta = skip_init(nn.Linear, 32, ndims * (ndims + 1))
        nn.init.zeros_(self.fc_theta.weight)
        nn.init.zeros_(self.fc_theta.bias)

    def forward(self, moving, fixed):
        x = torch.cat([moving, fixed], dim=1)
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"loc_{i}")(x), 0.2)
        x = F.leaky_relu(self.fc_0(x.flatten(1)), 0.2)
        nd = self.ndims
        theta = self.fc_theta(x).reshape(-1, nd, nd + 1)
        linear = theta[:, :, :nd] + torch.eye(nd, dtype=theta.dtype,
                                              device=theta.device)
        return centered_affine(moving.shape[2:], linear, theta[:, :, nd])


class AffineRegistration(nn.Module):
    """Localise and warp: returns (warped moving, matrix, dense flow)."""

    def __init__(self, inshape: Sequence[int], ndims: int = 2,
                 enc_features: Sequence[int] = (16, 32, 32),
                 in_channels: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.loc = AffineLocalizationNet(inshape, ndims, enc_features,
                                         in_channels, generator=generator)

    def forward(self, moving, fixed):
        matrix = self.loc(moving, fixed)
        warped = affine_warp(moving, matrix)
        return warped, matrix, affine_to_flow(matrix, moving.shape[2:])
