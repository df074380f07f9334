"""N-D patch library: grid / stack / quilt / patch_gen (the JAX package's
``utils/patchlib.py``; the reference's pynd patchlib, util/pynd/
patchlib.py: quilt :21, stack :66, grid2volsize :197, gridsize :230, grid
:293, patch_gen :375).  Host-side numpy: cut volumes into (possibly
overlapping) patch libraries and rebuild volumes from them; patch
extraction is one strided-view gather and quilting one bincount-based
scatter-average.

Conventions (the reference's): a patch grid over ``vol_size`` with
``patch_size`` and ``patch_stride`` covers ``grid_size * stride +
(patch_size - stride)`` voxels; patches are a library matrix ``[N,
prod(patch_size)]`` (or ``[N, V, K]`` with K candidates).  NaN entries are
ignored when quilting, as the reference's nanmean default.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

IntOrSeq = Union[int, Sequence[int]]


def _as_vec(x: IntOrSeq, nd: int) -> np.ndarray:
    a = np.asarray(x, int)
    if a.ndim == 0:
        a = np.repeat(a, nd)
    assert a.shape == (nd,), (x, nd)
    return a


def grid2volsize(grid_size, patch_size, patch_stride: IntOrSeq = 1):
    """Volume size covered by a full patch grid (reference :197)."""
    nd = len(np.atleast_1d(patch_size))
    grid_size = _as_vec(grid_size, nd)
    patch_size = _as_vec(patch_size, nd)
    stride = _as_vec(patch_stride, nd)
    return grid_size * stride + (patch_size - stride)


def gridsize(vol_size, patch_size, patch_stride: IntOrSeq = 1,
             start_sub: IntOrSeq = 0, nargout: int = 1):
    """Number of patches per dimension that fit in ``vol_size``
    (reference :230)."""
    nd = len(np.atleast_1d(patch_size))
    vol_size = _as_vec(vol_size, nd)
    patch_size = _as_vec(patch_size, nd)
    stride = _as_vec(patch_stride, nd)
    start = _as_vec(start_sub, nd)
    mod = vol_size - start
    assert np.all(mod > 0), "start_sub exceeds volume"
    gs = (mod - (patch_size - stride)) // stride
    assert np.all(gs > 0), "patch does not fit in volume"
    if nargout == 1:
        return gs
    return gs, grid2volsize(gs, patch_size, stride)


def grid(vol_size, patch_size, patch_stride: IntOrSeq = 1,
         start_sub: IntOrSeq = 0, nargout: int = 1, grid_type: str = "idx"):
    """Patch starting points (reference :293).

    grid_type 'idx': linear indices into ``vol_size``; 'sub': an
    ``[N, nd]`` array of subscripts.
    """
    nd = len(np.atleast_1d(patch_size))
    vol_size = _as_vec(vol_size, nd)
    stride = _as_vec(patch_stride, nd)
    start = _as_vec(start_sub, nd)
    gs, new_vol = gridsize(vol_size, patch_size, patch_stride, start_sub,
                           nargout=2)
    axes = [start[d] + np.arange(gs[d]) * stride[d] for d in range(nd)]
    sub = np.stack([a.ravel() for a in np.meshgrid(*axes, indexing="ij")],
                   axis=-1)
    if grid_type == "idx":
        out = np.ravel_multi_index(tuple(sub.T), tuple(vol_size))
    elif grid_type == "sub":
        out = sub
    else:
        raise ValueError(grid_type)
    if nargout == 1:
        return out
    if nargout == 2:
        return out, new_vol
    return out, new_vol, gs


def patch_gen(vol: np.ndarray, patch_size, stride: IntOrSeq = 1,
              rand: bool = False, rand_seed: Optional[int] = None):
    """All patches of ``vol`` on the stride grid, as an ``[N, *patch_size]``
    array (reference :375 yields them one by one from a Python loop; here
    one strided-view gather).  ``rand`` shuffles patch order."""
    nd = vol.ndim
    patch_size = _as_vec(patch_size, nd)
    stride = _as_vec(stride, nd)
    gs = gridsize(vol.shape, patch_size, stride)
    win = np.lib.stride_tricks.sliding_window_view(vol, tuple(patch_size))
    sl = tuple(slice(0, gs[d] * stride[d], stride[d]) for d in range(nd))
    patches = win[sl].reshape(-1, *patch_size).copy()
    if rand:
        order = np.random.RandomState(rand_seed).permutation(len(patches))
        patches = patches[order]
    return patches


def stack(patches: np.ndarray, patch_size, grid_size,
          patch_stride: IntOrSeq = 1, nargout: int = 1):
    """Stack a patch library into sparse NaN-padded layers such that no two
    patches in one layer overlap (reference :66).  Returns
    ``[n_layers, *vol_size]`` (and optionally the per-layer patch ids).
    """
    nd = len(np.atleast_1d(patch_size))
    patch_size = _as_vec(patch_size, nd)
    grid_size = _as_vec(grid_size, nd)
    stride = _as_vec(patch_stride, nd)
    vol_size = grid2volsize(grid_size, patch_size, stride)
    N = int(np.prod(grid_size))
    assert patches.shape[0] == N, (patches.shape, grid_size)
    V = int(np.prod(patch_size))

    # patches k = ceil(patch/stride) apart along each dim do not overlap
    layer_shape = np.maximum(-(-patch_size // stride), 1)
    n_layers = int(np.prod(layer_shape))
    subs = grid(vol_size, patch_size, stride, nargout=1, grid_type="sub")
    layer_of = np.zeros(N, int)
    gsub = (subs // stride)
    for d in range(nd):
        layer_of = layer_of * layer_shape[d] + (gsub[:, d] % layer_shape[d])

    layers = np.full((n_layers,) + tuple(vol_size), np.nan,
                     dtype=np.float64)
    pf = patches.reshape(N, V)
    offs = np.stack([a.ravel() for a in np.meshgrid(
        *[np.arange(p) for p in patch_size], indexing="ij")], axis=-1)
    for i in range(N):
        tgt = tuple((subs[i] + offs).T)
        layers[(layer_of[i],) + tgt] = pf[i]
    if nargout == 1:
        return layers
    ids = [np.where(layer_of == l)[0] for l in range(n_layers)]
    return layers, ids


def quilt(patches: np.ndarray, patch_size, grid_size,
          patch_stride: IntOrSeq = 1,
          nan_func_layers=np.nanmean, nan_func_K=np.nanmean):
    """Reconstruct a volume from a ``[N, V]`` or ``[N, V, K]`` patch
    library by averaging overlaps (reference :21).  Vectorized: one
    scatter-add of values and one of counts, NaNs excluded."""
    nd = len(np.atleast_1d(patch_size))
    patch_size = _as_vec(patch_size, nd)
    grid_size = _as_vec(grid_size, nd)
    stride = _as_vec(patch_stride, nd)
    vol_size = grid2volsize(grid_size, patch_size, stride)
    N = int(np.prod(grid_size))
    V = int(np.prod(patch_size))

    p = np.asarray(patches, np.float64)
    if p.ndim == 3:  # K candidates -> reduce over K first (NaN-aware)
        with np.errstate(invalid="ignore"):
            p = nan_func_K(p, axis=2)
    assert p.shape == (N, V), (patches.shape, (N, V))

    if nan_func_layers is not np.nanmean:
        # general reduction (e.g. nanmedian): go through explicit layers
        layers = stack(p, patch_size, grid_size, stride)
        with np.errstate(invalid="ignore"):
            return nan_func_layers(layers, axis=0)

    starts = grid(vol_size, patch_size, stride, nargout=1, grid_type="sub")
    offs = np.stack([a.ravel() for a in np.meshgrid(
        *[np.arange(s) for s in patch_size], indexing="ij")], axis=-1)
    # [N, V] linear target index of every patch voxel
    lin = np.ravel_multi_index(
        tuple((starts[:, None, :] + offs[None, :, :]).reshape(-1, nd).T),
        tuple(vol_size))
    vals = p.reshape(-1)
    valid = ~np.isnan(vals)
    total = np.bincount(lin[valid], weights=vals[valid],
                        minlength=int(np.prod(vol_size)))
    count = np.bincount(lin[valid], minlength=int(np.prod(vol_size)))
    with np.errstate(invalid="ignore"):
        vol = total / count
    return vol.reshape(tuple(vol_size))
