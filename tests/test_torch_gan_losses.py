"""losses/gan.py against the JAX package: gan_loss in its four modes
(1e-6 relative), an unknown mode refused, and gradient_penalty (real,
fake, mixed with JAX's alpha given; 1e-5 relative) through the basic
discriminator on converted weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.losses import gan as jax_gan
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.losses.gan import GAN_MODES, gan_loss, gradient_penalty
from test_torch_gan_nets import jax_and_port_D, np_rng
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("mode", GAN_MODES)
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    pred = (np_rng().standard_normal((3, 7, 7, 1)) * 2).astype(np.float32)
    ref = np.asarray(jax_gan.gan_loss(jnp.asarray(pred), real, mode))
    out = gan_loss(torch.from_numpy(to_nchw(pred)), real, mode).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_gan_loss_unknown_mode_raises():
    with pytest.raises(NotImplementedError):
        gan_loss(torch.zeros(2, 1, 3, 3), True, "hinge")


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(kind):
    jd, params, td = jax_and_port_D("basic", size=32)
    rng = np_rng(2)
    real, fake = (np.tanh(rng.standard_normal((3, 32, 32, 1))).astype(
        np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    ref = float(jax_gan.gradient_penalty(
        lambda x: jd.apply({"params": params}, x), jnp.asarray(real),
        jnp.asarray(fake), key, kind))
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))
    out = gradient_penalty(td, torch.from_numpy(to_nchw(real)),
                           torch.from_numpy(to_nchw(fake)), kind,
                           alpha=torch.from_numpy(alpha))
    got = float(out.detach())
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    # differentiable in D's weights, as a penalty on D must be (no bias
    # moves grad_x D)
    out.backward()
    assert all(p.grad is not None for p in td.parameters() if p.ndim > 1)
