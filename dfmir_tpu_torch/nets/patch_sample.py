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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import init_conv_


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
                generator: Optional[torch.Generator] = None):
        """feats: list of (B, C, *spatial).  Returns (samples, ids):
        samples[i] is (B * P, nc), L2-normalised ((B * HW, nc) when
        ``num_patches`` is 0); ids[i] the (P,) locations taken, drawn from
        ``generator`` (a CPU generator) unless ``patch_ids`` gives them."""
        if len(feats) != self.n_layers:
            raise ValueError(f"{len(feats)} feature maps for "
                             f"{self.n_layers} layers")
        samples: List[torch.Tensor] = []
        ids: List[Optional[torch.Tensor]] = []
        for i, feat in enumerate(feats):
            B, C = feat.shape[:2]
            flat = feat.reshape(B, C, -1).transpose(1, 2)       # (B, HW, C)
            if num_patches > 0:
                if patch_ids is not None:
                    patch_id = patch_ids[i]
                else:
                    if generator is None:
                        raise ValueError(
                            "generator required when patch_ids is None")
                    n_loc = flat.shape[1]
                    patch_id = torch.randperm(n_loc, generator=generator)[
                        :min(num_patches, n_loc)]
                patch_id = patch_id.to(feat.device)
                x = flat[:, patch_id].reshape(-1, C)
            else:
                patch_id = None
                x = flat.reshape(-1, C)
            if self.use_mlp:
                x = getattr(self, f"mlp_{i}")(x)
            ids.append(patch_id)
            samples.append(l2_normalize(x))
        return samples, ids
