"""Flow-field integration and resizing.

- ``vecint``: scaling and squaring, ``vec *= 1/2**nsteps`` then ``nsteps``
  times ``vec = vec + warp(vec, vec)`` (the reference VecInt); a 2-D or
  3-D float32 CUDA field runs the whole chain in one kernel launch each way
  (``warp_cuda.VecInt2dFunction``, ``VecInt3dFunction``).
  ``vecint_bwd_plain`` is the plain version of the chains' backward, and
  ``vecint2d_bwd_fixed_plain`` the 2-D chain backward as its kernel sums
  it, bit for bit.
- ``resize_flow``: resize and rescale a displacement field (the reference
  ResizeTransform): a factor below 1 resizes first and then scales, a factor
  above 1 scales first and then resizes, with align-corners linear
  interpolation to ``floor(S * factor)``.
- ``resize_flow_slab`` / ``resize_flow_to_slab``: ``resize_flow`` for a
  volume split along D over ranks (``parallel/mesh.py``), from this
  rank's slab or from the whole field, to this rank's slab of the result:
  each rank computes only its own rows of the D axis's align-corners
  matrix (an output plane o samples input plane o (n_in - 1) / (n_out -
  1), so the slabs' edges do not line up between the two sizes), from the
  input planes those rows reach.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.parallel.mesh import (halo_exchange, is_spatial,
                                           slab_slice)
from dfmir_tpu_torch.ops.warp import (warp, warp2d_dsrc_fixed_plain,
                                      warp_bwd_plain)


def linear_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) align-corners linear-interpolation matrix, float32
    (positions and weights computed in float64)."""
    if n_out == 1 or n_in == 1:
        pos = torch.zeros(n_out, dtype=torch.float64)
    else:
        pos = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / (n_out - 1)
    i0 = torch.floor(pos).long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(0, n_in - 1)
    w = (pos - i0).float()
    rows = torch.arange(n_out)
    M = torch.zeros(n_out, n_in)
    M.index_put_((rows, i0), 1.0 - w, accumulate=True)
    M.index_put_((rows, i1), w, accumulate=True)
    return M


def resize_linear(x, out_spatial):
    """Align-corners linear resize of (B, C, *spatial) to ``out_spatial``,
    as one small matmul per axis (the same interpolation as
    ``F.interpolate(align_corners=True)``, with the JAX package's rounding)."""
    for axis, (n_in, n_out) in enumerate(zip(x.shape[2:], out_spatial)):
        if n_in == n_out:
            continue
        M = linear_resize_matrix(n_in, int(n_out)).to(x.device, x.dtype)
        x = (x.movedim(axis + 2, -1) @ M.T).movedim(-1, axis + 2)
    return x


def resize_flow(flow, factor: float):
    """Resize a displacement field (B, nd, *spatial) and rescale its
    magnitudes by ``factor``; output spatial dims are ``floor(S * factor)``."""
    if factor == 1.0:
        return flow
    out_spatial = tuple(int(s * factor) for s in flow.shape[2:])
    if factor < 1:
        return resize_linear(flow, out_spatial) * factor
    return resize_linear(flow * factor, out_spatial)


def _resize_axis(x, M, axis):
    """``M`` (n_out, n_in) applied along ``axis`` of ``x``."""
    return (x.movedim(axis, -1) @ M.T).movedim(-1, axis)


def _slab_rows(n_in: int, n_out: int, rank: int, n: int):
    """Spatial rank ``rank``'s rows of the (n_out, n_in) align-corners
    matrix, ``[rank * n_out / n, (rank + 1) * n_out / n)``."""
    k = n_out // n
    return linear_resize_matrix(n_in, n_out)[rank * k:(rank + 1) * k]


def _band(n_in: int, n_out: int, n: int):
    """(lo, hi): the most planes below and above its own input slab that
    any spatial rank's output rows reach, the halo every rank takes."""
    lo = hi = 0
    k_in = n_in // n
    for r in range(n):
        cols = _slab_rows(n_in, n_out, r, n).abs().sum(0).nonzero()
        lo = max(lo, r * k_in - int(cols.min()))
        hi = max(hi, int(cols.max()) - ((r + 1) * k_in - 1))
    return lo, hi


def _slab_resize(x, out_spatial, mesh, whole: bool):
    """``resize_linear`` of a field split along D to this rank's slab of
    the result, ``out_spatial`` the whole result's spatial shape: from the
    whole field on every rank (``whole``), or from this rank's slab with a
    halo of the planes its rows reach (the same on every rank)."""
    n, r = mesh.n_spatial, mesh.spatial_rank
    n_out = int(out_spatial[0])
    if n_out % n:
        raise ValueError(f"{n_out} planes do not divide into {n} slabs")
    if whole:
        n_in = x.shape[2]
        M = _slab_rows(n_in, n_out, r, n)
    else:
        k_in = x.shape[2]
        n_in = k_in * n
        lo, hi = _band(n_in, n_out, n)
        x = halo_exchange(x, lo, hi, mesh)
        # the halo'd slab's planes, with zero columns past the volume
        first = r * k_in - lo
        M = torch.zeros(n_out // n, k_in + lo + hi)
        cols = slice(max(first, 0), min(first + M.shape[1], n_in))
        M[:, cols.start - first:cols.stop - first] = _slab_rows(
            n_in, n_out, r, n)[:, cols]
    x = _resize_axis(x, M.to(x.device, x.dtype), 2)
    return resize_linear(x, (x.shape[2], *out_spatial[1:]))


def resize_flow_slab(flow, factor: float, mesh=None):
    """``resize_flow`` of a field split along D, from this rank's slab
    ``flow`` to its slab of the result; ``resize_flow`` itself where
    ``mesh`` does not split the volume."""
    if factor == 1.0 or not is_spatial(mesh):
        return resize_flow(flow, factor)
    out = tuple(int(s * factor) for s in
                (flow.shape[2] * mesh.n_spatial, *flow.shape[3:]))
    if factor < 1:
        return _slab_resize(flow, out, mesh, whole=False) * factor
    return _slab_resize(flow * factor, out, mesh, whole=False)


def resize_flow_to_slab(flow, factor: float, mesh=None):
    """``resize_flow`` of the whole field ``flow`` (on every spatial rank)
    to this rank's slab of the result: its own rows alone; ``resize_flow``
    itself where ``mesh`` does not split the volume."""
    if not is_spatial(mesh):
        return resize_flow(flow, factor)
    if factor == 1.0:
        return slab_slice(flow, mesh.spatial_rank, mesh.n_spatial)
    out = tuple(int(s * factor) for s in flow.shape[2:])
    if factor < 1:
        return _slab_resize(flow, out, mesh, whole=True) * factor
    return _slab_resize(flow * factor, out, mesh, whole=True)


def _chain_takes(vec):
    """Whether ``impl="auto"`` sends ``vec`` to the chain kernels."""
    return (vec.ndim in (4, 5) and vec.shape[1] == vec.ndim - 2
            and vec.is_cuda and vec.dtype == torch.float32)


def vecint(vec, nsteps: int = 7, impl: str = "auto"):
    """Integrate a stationary velocity field (B, nd, *spatial), pixel units,
    by scaling and squaring; returns the displacement field.

    ``impl``: ``"torch"`` is the plain loop below, each step a warp of the
    field by itself; ``"cuda"`` runs a 2-D or 3-D field through the chain
    kernels (one launch forward, one backward; a CPU tensor raises);
    ``"auto"`` sends 2-D and 3-D float32 CUDA fields to the chain kernels
    and everything else (CPU fields, 1-D) to the plain loop."""
    if nsteps < 0:
        raise ValueError(f"nsteps must be >= 0, got {nsteps}")
    if vec.ndim in (4, 5) and (impl == "cuda"
                               or (impl == "auto" and _chain_takes(vec))):
        fn = (warp_cuda.VecInt2dFunction if vec.ndim == 4
              else warp_cuda.VecInt3dFunction)
        return fn.apply(vec.contiguous(), nsteps)
    vec = vec * (1.0 / (2 ** nsteps))
    for _ in range(nsteps):
        vec = vec + warp(vec, vec, mode="bilinear", impl=impl)
    return vec


def vecint_bwd_plain(vec, nsteps: int, g):
    """The chain kernels' backwards' plain version: the gradient of
    ``vecint(vec, nsteps, impl="torch")`` for the output cotangent ``g``, by
    autograd of the plain loop."""
    with torch.enable_grad():
        v = vec.detach().requires_grad_()
        (dvec,) = torch.autograd.grad(vecint(v, nsteps, impl="torch"), v, g)
    return dvec


def vecint2d_bwd_fixed_plain(steps, g):
    """``vecint2d_bwd_cuda`` in plain PyTorch, bit for bit: ``steps`` the
    forward's saved (nsteps, B, 2, H, W) fields, ``g`` the cotangent of its
    output.  Last step first, G_k = (G_{k+1} + dflow) + dsrc: dflow from
    ``warp_bwd_plain`` of the self-warp of v_k (the kernel's order), dsrc
    from ``warp2d_dsrc_fixed_plain`` (its fixed point, scaled per batch
    item); then G_0 * 2^-n."""
    n = steps.shape[0]
    G = g
    for k in range(n - 1, -1, -1):
        _, dflow = warp_bwd_plain(steps[k], steps[k], G, need_dsrc=False)
        G = (G + dflow) + warp2d_dsrc_fixed_plain(steps[k], G)
    return G * (1.0 / (2 ** n))

