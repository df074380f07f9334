"""Patch sampling and projection head for PatchNCE: the reference
PatchSampleF (``mlp_sample``; ``sample`` without the MLPs).

Per tapped layer: flatten the spatial grid, take ``num_patches`` random
locations (the ids are shared between the key and the query pass), project
through the layer's two-layer MLP (in -> nc -> nc, ReLU between) and
L2-normalise with ``x / (||x|| + 1e-7)``.

The MLPs are declared from the tapped layers' channel counts
(``nce_feature_dims``), so there is no lazy, data-dependent
initialisation.  Parameter names are the reference's: ``mlp_{i}.0.*`` and
``mlp_{i}.2.*``.  Patch ids are passed in, or drawn with ``torch.randperm``
from an explicit generator.

On slabs (``mesh`` splitting the first spatial axis over ranks,
``parallel/mesh.py``) each tap is this rank's rows of the whole map (a
pad's tap with its ``tap_pads`` rows past each global end on the end
ranks).  Every spatial rank draws the same ids over the whole map's
locations (one generator seed, or the ids given), takes the samples at
the ids that fall in its rows, and the samples are put together in id
order on every spatial rank (``parallel.mesh.gather_rows``); the MLP and
``l2_normalize`` then run on them there, so every spatial rank holds the
whole batch item's samples.  A tap of a level that runs gathered (netG
``unet_*``'s coarse levels, ``whole_taps``) is the whole map on every
spatial rank: its samples are taken there as in one process, with no
exchange.  Its gradient then reaches every spatial rank's copy of the
map whole, as a gathered sample's reaches every rank through
``gather_rows``' backward: the module's convention for what every
spatial rank holds whole (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import init_conv_
from dfmir_tpu_torch.parallel.mesh import gather_rows, is_spatial, slab_rows


def l2_normalize(x, eps: float = 1e-7):
    """The reference Normalize(2): x / (||x||_2 + eps) over the last axis.
    The norm is ``torch.linalg.vector_norm``, whose gradient at a zero
    vector is 0: a patch of exactly 0 gets the function's derivative
    there, I / eps.  The JAX package's ``sqrt(sum(x ** 2))`` gives NaN
    (0 times the square root's infinite slope), and so did this function,
    and bfloat16 generators do output exact zeros."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


class PatchSampleF(nn.Module):
    def __init__(self, feature_dims: Sequence[int], nc: int = 256,
                 use_mlp: bool = True, init_type: str = "xavier",
                 init_gain: float = 0.02, *, generator: torch.Generator):
        super().__init__()
        self.n_layers = len(feature_dims)
        self.use_mlp = use_mlp
        if use_mlp:
            for i, c_in in enumerate(feature_dims):
                mlp = nn.Sequential(skip_init(nn.Linear, c_in, nc), nn.ReLU(),
                                    skip_init(nn.Linear, nc, nc))
                for lin in (mlp[0], mlp[2]):
                    init_conv_(lin, init_type, init_gain, generator)
                setattr(self, f"mlp_{i}", mlp)

    def forward(self, feats: Sequence[torch.Tensor], num_patches: int = 256,
                patch_ids: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None, mesh=None,
                tap_pads: Optional[Sequence[int]] = None,
                whole_taps: Optional[Sequence[bool]] = None):
        """feats: list of (B, C, *spatial).  Returns (samples, ids):
        samples[i] is (B * P, nc), L2-normalised ((B * HW, nc) when
        ``num_patches`` is 0); ids[i] the (P,) locations taken, drawn from
        ``generator`` (a CPU generator) unless ``patch_ids`` gives them.
        ``mesh`` splitting the maps: feats[i] is this rank's rows, with
        ``tap_pads[i]`` rows past each global end (0 by default); the ids
        are over the whole map, and the samples the whole map's;
        ``whole_taps[i]`` true: feats[i] is the whole map on every spatial
        rank (no rank's rows)."""
        if len(feats) != self.n_layers:
            raise ValueError(f"{len(feats)} feature maps for "
                             f"{self.n_layers} layers")
        spatial = is_spatial(mesh)
        if spatial and num_patches <= 0:
            raise NotImplementedError("PatchSampleF on slabs samples "
                                      "patches: num_patches must be > 0")
        samples: List[torch.Tensor] = []
        ids: List[Optional[torch.Tensor]] = []
        for i, feat in enumerate(feats):
            B, C = feat.shape[:2]
            flat = feat.reshape(B, C, -1).transpose(1, 2)       # (B, HW, C)
            n_loc, offset = flat.shape[1], 0
            slab = spatial and not (whole_taps and whole_taps[i])
            if slab:
                plane = flat.shape[1] // feat.shape[2]
                first, total = slab_rows(feat.shape[2],
                                         tap_pads[i] if tap_pads else 0,
                                         mesh)
                n_loc, offset = total * plane, first * plane
            if num_patches > 0:
                if patch_ids is not None:
                    patch_id = patch_ids[i]
                else:
                    if generator is None:
                        raise ValueError(
                            "generator required when patch_ids is None")
                    patch_id = torch.randperm(n_loc, generator=generator)[
                        :min(num_patches, n_loc)]
                patch_id = patch_id.to(feat.device)
                if slab:
                    local = patch_id - offset
                    owned = (local >= 0) & (local < flat.shape[1])
                    x = gather_rows(
                        flat[:, local.clamp(0, flat.shape[1] - 1)], owned,
                        mesh).reshape(-1, C)
                else:
                    x = flat[:, patch_id].reshape(-1, C)
            else:
                patch_id = None
                x = flat.reshape(-1, C)
            if self.use_mlp:
                x = getattr(self, f"mlp_{i}")(x)
            ids.append(patch_id)
            samples.append(l2_normalize(x))
        return samples, ids
