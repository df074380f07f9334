"""N-D numpy utilities (the JAX package's ``utils/ndutils.py``; the
reference's pynd side library, util/pynd/ndutils.py and segutils.py):
synthetic volumes, signed distance transforms and contour extraction,
host-side helpers for evaluation and data generation (scipy imported
inside the functions that need it)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def bw_grid(vol_shape: Sequence[int], spacing, thickness: int = 1
            ) -> np.ndarray:
    """Binary grid-line volume (pynd ndutils.bw_grid)."""
    vol_shape = tuple(vol_shape)
    if np.isscalar(spacing):
        spacing = [spacing] * len(vol_shape)
    grid = np.zeros(vol_shape, np.float32)
    for ax, sp in enumerate(spacing):
        idx = [slice(None)] * len(vol_shape)
        for start in range(0, vol_shape[ax], sp):
            idx[ax] = slice(start, start + thickness)
            grid[tuple(idx)] = 1.0
    return grid


def bw_sphere(vol_shape: Sequence[int], rad: float,
              loc: Optional[Sequence[float]] = None) -> np.ndarray:
    """Binary sphere volume (pynd ndutils.bw_sphere)."""
    vol_shape = tuple(vol_shape)
    if loc is None:
        loc = [(s - 1) / 2.0 for s in vol_shape]
    grids = np.meshgrid(*[np.arange(s) for s in vol_shape], indexing="ij")
    d2 = sum((g - c) ** 2 for g, c in zip(grids, loc))
    return (d2 <= rad ** 2).astype(np.float32)


def gaussian_kernel(sigma, windowsize: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
    """Separable N-D gaussian kernel (pynd ndutils.gaussian_kernel)."""
    if np.isscalar(sigma):
        sigma = [sigma]
    sigma = [max(s, np.finfo(float).eps) for s in sigma]
    if windowsize is None:
        windowsize = [int(np.round(s * 3) * 2 + 1) for s in sigma]
    axes = [np.arange(w) - (w - 1) / 2 for w in windowsize]
    grids = np.meshgrid(*axes, indexing="ij")
    k = np.ones(tuple(windowsize), np.float64)
    for g, s in zip(grids, sigma):
        k = k * np.exp(-(g ** 2) / (2 * s ** 2))
    return (k / k.sum()).astype(np.float32)


def bw2sdtrf(bwvol: np.ndarray) -> np.ndarray:
    """Signed distance transform of a binary volume: negative inside,
    positive outside, ~0 at the boundary (pynd ndutils.bw2sdtrf)."""
    from scipy.ndimage import distance_transform_edt

    bw = np.asarray(bwvol).astype(bool)
    if not bw.any():
        return distance_transform_edt(~bw).astype(np.float32)
    if bw.all():
        return -distance_transform_edt(bw).astype(np.float32)
    posdst = distance_transform_edt(~bw)
    negdst = distance_transform_edt(bw)
    return (posdst * ~bw - negdst * bw).astype(np.float32)


def perlin_vol(vol_shape: Sequence[int], min_scale: int = 0,
               max_scale: Optional[int] = None,
               seed: Optional[int] = None) -> np.ndarray:
    """Multi-octave smooth noise: sum of bilinearly-upsampled random grids
    at power-of-two scales, monotonic weights (pynd ndutils.perlin_vol)."""
    from scipy.ndimage import zoom

    vol_shape = tuple(vol_shape)
    rng = np.random.default_rng(seed)
    if max_scale is None:
        max_width = max(vol_shape)
        max_scale = int(np.ceil(np.log2(max_width)))
    out = np.zeros(vol_shape, np.float64)
    for i in range(min_scale, max_scale + 1):
        scale = 2 ** i
        wt = scale
        low_shape = [max(int(np.ceil(s / scale)) + 1, 2) for s in vol_shape]
        noise = rng.random(low_shape)
        factors = [s / l for s, l in zip(vol_shape, low_shape)]
        up = zoom(noise, factors, order=1)
        up = up[tuple(slice(0, s) for s in vol_shape)]
        out += wt * up
    out -= out.min()
    m = out.max()
    return (out / m if m > 0 else out).astype(np.float32)


def seg2contour(seg: np.ndarray, thickness: int = 1) -> np.ndarray:
    """Label-map boundary voxels keep their label, interior goes to 0
    (pynd segutils.seg2contour, erosion-based)."""
    from scipy.ndimage import binary_erosion

    seg = np.asarray(seg)
    contour = np.zeros_like(seg)
    for lab in np.unique(seg):
        if lab == 0:
            continue
        bw = seg == lab
        interior = binary_erosion(bw, iterations=thickness)
        contour[bw & ~interior] = lab
    return contour
