"""Jacobian-determinant maps for deformation fields.

``flow`` is a displacement field (B, nd, *spatial) in pixel units; the map
is ``phi(p) = p + flow(p)``.  Derivatives are central differences inside
and one-sided at the edges (the numpy.gradient convention).  With a
``mesh`` that splits the volume along D (``parallel/mesh.py``), ``flow`` is
this rank's slab: the D derivative takes a 1-plane halo each side, and is
one-sided only at the volume's first and last planes, so that a slab's
determinant equals the whole volume's rows.
"""

from __future__ import annotations

from typing import Dict

import torch

from dfmir_tpu_torch.parallel.mesh import (all_reduce_max, all_reduce_metrics,
                                           halo_exchange, is_spatial)


def _gradient(u, axis):
    """d u / d axis with unit spacing; central interior, one-sided edges."""
    n = u.shape[axis]
    if n < 2:
        return torch.zeros_like(u)
    interior = (u.narrow(axis, 2, n - 2) - u.narrow(axis, 0, n - 2)) * 0.5
    first = u.narrow(axis, 1, 1) - u.narrow(axis, 0, 1)
    last = u.narrow(axis, n - 1, 1) - u.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


def _gradient_slab(flow, mesh):
    """d flow / d D of this rank's slab (B, nd, D, ...): central
    differences over a 1-plane halo, one-sided at the volume's ends."""
    ext = halo_exchange(flow, 1, 1, mesh)
    d = (ext[:, :, 2:] - ext[:, :, :-2]) * 0.5
    if mesh.spatial_rank == 0:
        d[:, :, 0] = ext[:, :, 2] - ext[:, :, 1]
    if mesh.spatial_rank == mesh.n_spatial - 1:
        d[:, :, -1] = ext[:, :, -2] - ext[:, :, -3]
    return d


def jacobian_det(flow, mesh=None):
    """Pointwise determinant of the deformation Jacobian, (B, *spatial)."""
    nd = flow.shape[1]
    dz = _gradient_slab(flow, mesh) if is_spatial(mesh) else None

    def grad(i, j):
        if j == 0 and dz is not None:
            return dz[:, i]
        return _gradient(flow[:, i], 1 + j)
    # J[i][j] = d phi_i / d axis_j = d flow_i / d axis_j + delta_ij; the
    # spatial axes of flow[:, i] are 1..nd
    J = [[grad(i, j) + (1.0 if i == j else 0.0)
          for j in range(nd)] for i in range(nd)]
    if nd == 1:
        return J[0][0]
    if nd == 2:
        return J[0][0] * J[1][1] - J[0][1] * J[1][0]
    if nd == 3:
        return (J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1])
                - J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0])
                + J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]))
    raise ValueError(f"unsupported ndims={nd}")


def folding_fraction(flow):
    """%|J|<0: the fraction of pixels where the deformation folds, (B,)."""
    det = jacobian_det(flow)
    return (det < 0).float().mean(dim=tuple(range(1, det.ndim)))


def field_stats(flow, mesh=None) -> Dict[str, torch.Tensor]:
    """Scalar field-health statistics of a batch of flows: the folding
    fraction, |J|'s least, most and mean, and the largest displacement.
    With a ``mesh`` (``parallel.mesh``, ``flow`` this rank's slice), the
    global batch's: the extremes over the ranks, the means' mean; a mesh
    that splits the volume along D takes ``flow`` as this rank's slab, and
    gives the whole volume's (every slab the same size)."""
    det = jacobian_det(flow, mesh)
    fold = (det < 0).float().mean(dim=tuple(range(1, det.ndim)))
    means = all_reduce_metrics({"fold": fold.mean(),
                                "jac_mean": det.mean()}, mesh)
    neg_min, jac_max, flow_max = all_reduce_max(
        torch.stack([-det.min(), det.max(), flow.abs().max()]), mesh)
    return {"fold": means["fold"], "jac_min": -neg_min, "jac_max": jac_max,
            "jac_mean": means["jac_mean"], "flow_max": flow_max}
