"""Flow regularizers on NCHW / NCDHW flows (B, nd, *spatial).

- ``smoothness_loss``: the paper model's flow smoothness, the mean squared
  finite difference of the integrated full-resolution flow, averaged over
  the spatial axes.
- ``grad_loss``: the reference Grad_Loss, l1 or l2, 2-D or 3-D.  With a
  ``mesh`` that splits the volume along D (``parallel/mesh.py``), ``flow``
  is this rank's slab: the D differences take a 1-plane halo from the
  slab above (the last slab has one difference fewer), each axis's sum is
  divided by the global count over ``world`` (B * 3 * (D - 1) * H * W for
  D, B the global batch), and ``global_mean`` gives the whole volume's
  value with ``world`` times this rank's share of the gradient.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.parallel.mesh import (global_mean, halo_exchange,
                                           is_spatial)


def _axis_diffs(flow):
    """|forward difference| along each spatial axis."""
    return [flow.diff(dim=axis).abs() for axis in range(2, flow.ndim)]


def smoothness_loss(flow):
    diffs = _axis_diffs(flow)
    return sum((d * d).mean() for d in diffs) / len(diffs)


def grad_loss(flow, penalty: str = "l2", mesh=None):
    if penalty not in ("l1", "l2"):
        raise ValueError(f"penalty must be 'l1' or 'l2', got {penalty!r}")
    if is_spatial(mesh):
        return _grad_loss_slab(flow, penalty, mesh)
    diffs = _axis_diffs(flow)
    if penalty == "l2":
        diffs = [d * d for d in diffs]
    return sum(d.mean() for d in diffs) / len(diffs)


def _grad_loss_slab(flow, penalty, mesh):
    """``grad_loss`` of the whole volume from this rank's slab ``flow``."""
    B, nd, D = flow.shape[:3]
    ext = halo_exchange(flow, 0, 1, mesh)
    # the last slab's last difference reaches past the volume: weight 0,
    # the same ops on every rank
    keep = torch.ones(D, dtype=flow.dtype, device=flow.device)
    if mesh.spatial_rank == mesh.n_spatial - 1:
        keep[-1] = 0.0
    diffs = [ext.diff(dim=2).abs() * keep.reshape(D, 1, 1)]
    diffs += [flow.diff(dim=axis).abs() for axis in range(3, flow.ndim)]
    if penalty == "l2":
        diffs = [d * d for d in diffs]
    spatial = [D * mesh.n_spatial, *flow.shape[3:]]
    total = 0.0
    for axis, d in enumerate(diffs):
        sizes = list(spatial)
        sizes[axis] -= 1
        count = B * mesh.n_data * nd * torch.Size(sizes).numel()
        total = total + d.sum() / (count / mesh.world)
    return global_mean(total, mesh) / len(diffs)
