"""GAN objectives (the JAX package's ``losses/gan.py``; the reference
GANLoss): lsgan, vanilla, wgangp and nonsaturating, and the WGAN-GP
gradient penalty.  The paper model runs with ``lambda_GAN`` 0; these serve
``--lambda_GAN > 0`` and the discriminators of ``nets/discriminators.py``.

On slabs (``mesh`` splitting axis 2, ``parallel/mesh.py``) a prediction
map that is itself split (the pixel discriminator's, run on the slab)
takes its means over the whole map: the ranks' sums added with
``spatial_sum``, so every spatial rank holds the whole map's loss and,
under the module's convention, its share of the gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from dfmir_tpu_torch.parallel.mesh import is_spatial, spatial_sum

GAN_MODES = ("lsgan", "vanilla", "wgangp", "nonsaturating")


def _mean(x, per_sample: bool = False, mesh=None):
    """The mean of ``x`` over every element (``per_sample``: over all but
    the batch axis), of the whole map where ``mesh`` splits axis 2."""
    if per_sample:
        x = x.reshape(x.shape[0], -1)
    if not is_spatial(mesh):
        return x.mean(dim=1) if per_sample else x.mean()
    total = x.sum(dim=1) if per_sample else x.sum()
    count = (x.shape[1] if per_sample else x.numel()) * mesh.n_spatial
    return spatial_sum(total, mesh) / count


def gan_loss(prediction, target_is_real: bool, gan_mode: str = "lsgan",
             target_real_label: float = 1.0,
             target_fake_label: float = 0.0, mesh=None):
    """The loss of D's ``prediction`` against a real or fake target: a
    scalar, or for ``nonsaturating`` one mean a sample, (B,), unreduced
    over the batch as in the JAX package.  ``mesh``: ``prediction`` is
    this rank's slab of the map, and the means are the whole map's."""
    if gan_mode in ("lsgan", "vanilla"):
        target = target_real_label if target_is_real else target_fake_label
        if gan_mode == "lsgan":
            return _mean((prediction - target).square(), mesh=mesh)
        # BCE with logits in its stable form
        return _mean(prediction.clamp(min=0) - prediction * target
                     + torch.log1p(torch.exp(-prediction.abs())), mesh=mesh)
    if gan_mode == "wgangp":
        mean = _mean(prediction, mesh=mesh)
        return -mean if target_is_real else mean
    if gan_mode == "nonsaturating":
        x = -prediction if target_is_real else prediction
        return _mean(F.softplus(x), per_sample=True, mesh=mesh)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def gradient_penalty(disc_fn: Callable, real, fake, kind: str = "mixed",
                     constant: float = 1.0, lambda_gp: float = 10.0,
                     alpha: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """The WGAN-GP penalty: mean over samples of (||grad_x D(x)|| -
    constant)^2 times ``lambda_gp``, at ``real``, ``fake`` or (``mixed``)
    ``alpha * real + (1 - alpha) * fake`` with ``alpha`` (B, 1, ...) given
    or drawn U(0, 1) from ``generator`` (on the inputs' device).

    JAX ``vmap``s a gradient of each sample's summed D output; here one
    gradient of the output summed over the batch gives the same per-sample
    gradients, because every discriminator of the port is per-sample
    (instance norm or none: no statistic crosses the batch)."""
    if lambda_gp <= 0.0:
        return 0.0
    if kind == "real":
        x = real
    elif kind == "fake":
        x = fake
    elif kind == "mixed":
        if alpha is None:
            alpha = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                               generator=generator, device=real.device,
                               dtype=real.dtype)
        x = alpha * real + (1 - alpha) * fake
    else:
        raise NotImplementedError(kind)
    x = x.detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    norm = (grads.reshape(real.shape[0], -1) + 1e-16).norm(dim=1)
    return (norm - constant).square().mean() * lambda_gp
