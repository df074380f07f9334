"""Jacobian-determinant visualization: a midpoint-normalized blue-white-red
colormap centred at |J| = 1, in numpy (a copy of the JAX package's
``utils/jac_vis.py``; the determinant is ``ops/jacobian.py``'s)."""

from __future__ import annotations

import numpy as np


def midpoint_normalize(x: np.ndarray, vmin=None, vmax=None,
                       midpoint: float = 1.0) -> np.ndarray:
    """Map x to [0,1] piecewise-linearly with ``midpoint`` -> 0.5
    (reference MidpointNormalize, util/jac_vis.py:7-17)."""
    x = np.asarray(x, np.float32)
    vmin = float(x.min()) if vmin is None else vmin
    vmax = float(x.max()) if vmax is None else vmax
    vmin = min(vmin, midpoint)
    vmax = max(vmax, midpoint)
    return np.interp(x, [vmin, midpoint, vmax], [0.0, 0.5, 1.0]).astype(
        np.float32)


def diverging_rgb(t: np.ndarray) -> np.ndarray:
    """t in [0,1] -> blue-white-red RGB uint8 (bwr-style)."""
    t = np.clip(np.asarray(t, np.float32), 0.0, 1.0)
    r = np.where(t < 0.5, 2 * t, 1.0)
    b = np.where(t < 0.5, 1.0, 2 * (1 - t))
    g = 1.0 - np.abs(2 * t - 1.0)
    rgb = np.stack([r, g, b], axis=-1)
    return (rgb * 255).astype(np.uint8)


def jac_det_to_rgb(jac_det: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """|J| map -> RGB overlay image: blue = contraction (<1), white = volume
    preserving (=1), red = expansion (>1); folded voxels (<0) saturate."""
    return diverging_rgb(midpoint_normalize(jac_det, vmin, vmax))


def overlay(image_m1p1: np.ndarray, jac_rgb: np.ndarray,
            alpha: float = 0.5) -> np.ndarray:
    """Blend a [-1,1] grayscale image with a |J| RGB map -> uint8 RGB."""
    img = (np.asarray(image_m1p1, np.float32) + 1.0) / 2.0
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    base = np.stack([img] * 3, axis=-1) * 255.0
    out = (1 - alpha) * base + alpha * jac_rgb.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)
