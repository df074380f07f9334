"""Flow-field integration and resizing.

- ``vecint``: scaling and squaring, ``vec *= 1/2**nsteps`` then ``nsteps``
  times ``vec = vec + warp(vec, vec)`` (the reference VecInt); a 2-D or
  3-D float32 CUDA field runs the whole chain in one kernel launch each way
  (``warp_cuda.VecInt2dFunction``, ``VecInt3dFunction``).
  ``vecint_bwd_plain`` is the plain version of the chains' backward.
- ``resize_flow``: resize and rescale a displacement field (the reference
  ResizeTransform): a factor below 1 resizes first and then scales, a factor
  above 1 scales first and then resizes, with align-corners linear
  interpolation to ``floor(S * factor)``.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import warp


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
