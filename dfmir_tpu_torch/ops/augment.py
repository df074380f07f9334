"""Random spatial deformation (the JAX package's ``ops/augment.py``; the
reference's TensorDeformation: a random affine and a low-resolution SVF).

Each random function is a draw and a deterministic part:
``draw_deformation`` draws the angles (degrees), the scalings and
translations (pixels) of the affine and the SVF's gaussian noise from a
``torch.Generator``, on the generator's device, and
``deformation_from_draws`` turns those draws into one dense flow,
``total(p) = affine(p + svf(p)) - p``, so that one warp applies both.
``deform`` warps an image (bilinear) and its label map (nearest) by a
flow; ``augment`` is ``deform`` by a ``random_deformation``.

The SVF is integrated with ``vecint`` and the image warped with ``warp``,
both ``impl="auto"``: on a float32 CUDA tensor that is the chain kernel
(``vecint2d_fwd`` / ``vecint3d_fwd``) at the SVF's low resolution, then B1
/ B3 at full size; the label's nearest warp is the plain gather.

Layout NCHW / NCDHW; flows (B, nd, *spatial).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from dfmir_tpu_torch.ops.affine import centered_affine
from dfmir_tpu_torch.ops.integrate import resize_linear, vecint
from dfmir_tpu_torch.ops.warp import identity_grid, warp


class DeformationDraws(NamedTuple):
    """The random numbers of one deformation of a batch."""

    angles: torch.Tensor        # (B, 1) in 2-D, (B, 3) in 3-D, degrees
    scalings: torch.Tensor      # (B, nd), the scale's deviation from 1
    translations: torch.Tensor  # (B, nd), pixels
    svf_noise: torch.Tensor     # (B, nd, *low), N(0, 1)


def svf_size(spatial: Sequence[int], svf_scale: int = 8):
    """The SVF's low resolution: ``max(s // svf_scale, 2)`` an axis."""
    return tuple(max(s // svf_scale, 2) for s in spatial)


def _uniform(generator, shape, bound):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * bound) - bound


def _affine_draws(generator, batch, nd, max_rotation, max_scaling,
                  max_translation):
    """Angles U(+-max_rotation) (one in 2-D, one an axis in 3-D), scalings
    U(+-max_scaling), translations U(+-max_translation)."""
    return (_uniform(generator, (batch, 1 if nd == 2 else 3), max_rotation),
            _uniform(generator, (batch, nd), max_scaling),
            _uniform(generator, (batch, nd), max_translation))


def draw_deformation(generator: torch.Generator, batch: int,
                     spatial: Sequence[int], max_rotation: float = 10.0,
                     max_scaling: float = 0.1, max_translation: float = 5.0,
                     svf_scale: int = 8) -> DeformationDraws:
    """The affine's draws and the SVF's N(0, 1) noise at ``svf_size``."""
    nd = len(spatial)
    return DeformationDraws(
        *_affine_draws(generator, batch, nd, max_rotation, max_scaling,
                       max_translation),
        svf_noise=torch.randn((batch, nd, *svf_size(spatial, svf_scale)),
                              generator=generator, device=generator.device))


def _rotation(a, axis=None):
    """(B, 2, 2) rotations by angles ``a`` (B,) radians in 2-D, or (B, 3,
    3) about spatial ``axis`` in 3-D."""
    c, s = torch.cos(a), torch.sin(a)
    if axis is None:
        rows = [[c, -s], [s, c]]
    else:
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        rows = {0: [[one, zero, zero], [zero, c, -s], [zero, s, c]],
                1: [[c, zero, s], [zero, one, zero], [-s, zero, c]],
                2: [[c, -s, zero], [s, c, zero], [zero, zero, one]]}[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def affine_from_draws(spatial: Sequence[int], angles, scalings,
                      translations):
    """Centred affine matrices (B, nd, nd + 1): the rotation (3-D: about
    axes 0, 1, 2, composed in that order) times the per-axis scales
    ``1 + scalings`` (columns), then the translation."""
    radians = angles * (math.pi / 180.0)
    if len(spatial) == 2:
        lin = _rotation(radians[:, 0])
    else:
        lin = (_rotation(radians[:, 0], 0) @ _rotation(radians[:, 1], 1)
               @ _rotation(radians[:, 2], 2))
    lin = lin * (1.0 + scalings)[:, None, :]
    return centered_affine(spatial, lin, translations)


def random_affine_matrix(generator: torch.Generator, batch: int,
                         spatial: Sequence[int], max_rotation: float = 10.0,
                         max_scaling: float = 0.1,
                         max_translation: float = 5.0):
    """Random centred affine matrices (B, nd, nd + 1), 2-D or 3-D."""
    return affine_from_draws(spatial, *_affine_draws(
        generator, batch, len(spatial), max_rotation, max_scaling,
        max_translation))


def svf_flow_from_noise(noise, spatial: Sequence[int], svf_std: float = 1.0,
                        int_steps: int = 5):
    """A smooth diffeomorphic flow at ``spatial``: the SVF ``noise *
    svf_std`` (B, nd, *low) integrated by scaling and squaring, resized
    and its displacements scaled to the full size."""
    low = noise.shape[2:]
    flow = resize_linear(vecint(noise * svf_std, int_steps), tuple(spatial))
    scale = torch.tensor([s / n for s, n in zip(spatial, low)],
                         dtype=flow.dtype, device=flow.device)
    return flow * scale.reshape(1, -1, *(1,) * len(spatial))


def random_svf_flow(generator: torch.Generator, batch: int,
                    spatial: Sequence[int], svf_std: float = 1.0,
                    svf_scale: int = 8, int_steps: int = 5):
    """``svf_flow_from_noise`` of N(0, 1) noise drawn at ``svf_size``."""
    noise = torch.randn((batch, len(spatial), *svf_size(spatial, svf_scale)),
                        generator=generator, device=generator.device)
    return svf_flow_from_noise(noise, spatial, svf_std, int_steps)


def compose_deformation(matrix, flow_svf):
    """One flow of the SVF, then the affine: ``affine(p + svf(p)) - p``."""
    nd = flow_svf.shape[1]
    grid = identity_grid(flow_svf.shape[2:], dtype=flow_svf.dtype,
                         device=flow_svf.device)[None]
    coords = torch.einsum("bij,bj...->bi...", matrix[:, :, :nd],
                          grid + flow_svf)
    return coords + matrix[:, :, nd].reshape(-1, nd, *(1,) * nd) - grid


def deformation_from_draws(draws: DeformationDraws, spatial: Sequence[int],
                           svf_std: float = 1.0, int_steps: int = 5):
    """The dense flow (B, nd, *spatial) of ``draws``."""
    matrix = affine_from_draws(spatial, draws.angles, draws.scalings,
                               draws.translations)
    flow_svf = svf_flow_from_noise(draws.svf_noise, spatial, svf_std,
                                   int_steps)
    return compose_deformation(matrix, flow_svf)


def random_deformation(generator: torch.Generator, batch: int,
                       spatial: Sequence[int], max_rotation: float = 10.0,
                       max_scaling: float = 0.1,
                       max_translation: float = 5.0, svf_std: float = 1.0,
                       svf_scale: int = 8, int_steps: int = 5):
    """A random affine and a random SVF composed into one dense flow."""
    draws = draw_deformation(generator, batch, spatial, max_rotation,
                             max_scaling, max_translation, svf_scale)
    return deformation_from_draws(draws, spatial, svf_std, int_steps)


def deform(src, flow, label=None):
    """Warp ``src`` (bilinear) and ``label`` (nearest) by ``flow``:
    (aug, flow) or (aug, lab, flow)."""
    out = warp(src, flow)
    if label is None:
        return out, flow
    return out, warp(label, flow, mode="nearest"), flow


def augment(src, generator: torch.Generator, label=None, **kwargs):
    """Random-deform ``src`` and, with the same flow, its ``label`` map;
    ``generator`` lies on ``src``'s device.  Returns (aug, flow) or (aug,
    lab, flow)."""
    flow = random_deformation(generator, src.shape[0], src.shape[2:],
                              **kwargs)
    return deform(src, flow, label)
