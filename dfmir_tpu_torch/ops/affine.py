"""Affine warps (the JAX package's ``ops/affine.py``; the reference's
SpatialTransformerAffine / AffineTransformer and affine_to_shift).

Matrices (B, nd, nd + 1) act on pixel coordinates, ``p_src = M[:, :, :nd]
@ p_out + M[:, :, nd]``, in the dense flows' axis order (axis 0 first).
``affine_warp`` samples the source at those absolute coordinates with
``grid_sample_pixel``, the plain gather: no warp kernel takes absolute
coordinates, as no Pallas kernel serves the JAX package's affine warp.

Layout NCHW / NCDHW; coordinates and flows (B, nd, *spatial).
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops.warp import grid_sample_pixel, identity_grid


def affine_grid(matrix, spatial):
    """matrix (B, nd, nd + 1) -> absolute source coords (B, nd, *spatial)."""
    nd = len(spatial)
    grid = identity_grid(spatial, dtype=matrix.dtype, device=matrix.device)
    coords = torch.einsum("bij,j...->bi...", matrix[:, :, :nd], grid)
    return coords + matrix[:, :, nd].reshape(-1, nd, *(1,) * nd)


def affine_to_flow(matrix, spatial):
    """The dense displacement field of an affine matrix."""
    grid = identity_grid(spatial, dtype=matrix.dtype, device=matrix.device)
    return affine_grid(matrix, spatial) - grid[None]


def affine_warp(src, matrix, mode="bilinear"):
    """Warp (B, C, *spatial) by per-sample affine matrices (B, nd, nd+1)."""
    return grid_sample_pixel(src, affine_grid(matrix, src.shape[2:]),
                             mode=mode)


def centered_affine(spatial, linear, translation=None):
    """(B, nd, nd + 1) matrices that apply ``linear`` (B, nd, nd) about the
    image centre, then ``translation`` (B, nd) pixels; float32 at least,
    as JAX's float32 centre promotes them."""
    dtype = torch.promote_types(linear.dtype, torch.float32)
    center = torch.tensor([(s - 1) / 2.0 for s in spatial], dtype=dtype,
                          device=linear.device)
    linear = linear.to(dtype)
    if translation is None:
        translation = torch.zeros(linear.shape[:2], dtype=dtype,
                                  device=linear.device)
    off = center[None] - torch.einsum("bij,j->bi", linear, center) \
        + translation
    return torch.cat([linear, off[:, :, None]], dim=-1)
