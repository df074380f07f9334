"""GAN objectives (the JAX package's ``losses/gan.py``; the reference
GANLoss): lsgan, vanilla, wgangp and nonsaturating, and the WGAN-GP
gradient penalty.  The paper model runs with ``lambda_GAN`` 0; these serve
``--lambda_GAN > 0`` and the discriminators of ``nets/discriminators.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

GAN_MODES = ("lsgan", "vanilla", "wgangp", "nonsaturating")


def gan_loss(prediction, target_is_real: bool, gan_mode: str = "lsgan",
             target_real_label: float = 1.0,
             target_fake_label: float = 0.0):
    """The loss of D's ``prediction`` against a real or fake target: a
    scalar, or for ``nonsaturating`` one mean a sample, (B,), unreduced
    over the batch as in the JAX package."""
    if gan_mode in ("lsgan", "vanilla"):
        target = target_real_label if target_is_real else target_fake_label
        if gan_mode == "lsgan":
            return (prediction - target).square().mean()
        # BCE with logits in its stable form
        return (prediction.clamp(min=0) - prediction * target
                + torch.log1p(torch.exp(-prediction.abs()))).mean()
    if gan_mode == "wgangp":
        return -prediction.mean() if target_is_real else prediction.mean()
    if gan_mode == "nonsaturating":
        x = -prediction if target_is_real else prediction
        return F.softplus(x).reshape(prediction.shape[0], -1).mean(dim=1)
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
