"""nets/discriminators.py with nets/factory.py::define_D and the netD
weight bridge against the JAX package's discriminators (the discriminator
phase's step: ``test_torch_gan.py``).

Bars: the discriminators (basic / n_layers / pixel / patch, antialiased
and not) against their JAX modules on converted weights: 1e-5 of max(1,
max |D|); ``basic`` against RefNLayerDiscriminator holding the port's own
state_dict: 1e-6.  ``gradient_penalty`` drawing its alpha from a
generator: the same value twice, 0 at lambda_gp 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat.torch_ref import RefNLayerDiscriminator
from dfmir_tpu.nets import define_D as jax_define_D
from dfmir_tpu_torch.compat.convert import netD_state_from_jax, to_nchw
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.losses.gan import gradient_penalty
from dfmir_tpu_torch.nets.factory import define_D
from test_torch_gan import GAN, np_rng
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


def jax_and_port_D(netD, seed=0, size=64, **kw):
    """A JAX discriminator's init params and the port's module holding
    them (converted)."""
    jd = jax_define_D(input_nc=1, ndf=8, netD=netD, **kw)
    x0 = jnp.zeros((1, size, size, 1), jnp.float32)
    params = jax.tree.map(np.asarray,
                          jd.init(jax.random.PRNGKey(seed), x0)["params"])
    td = define_D(input_nc=1, ndf=8, netD=netD, **kw,
                  generator=torch.Generator().manual_seed(0))
    sd = dict(td.state_dict())
    sd.update(netD_state_from_jax(params, td))
    td.load_state_dict(sd)
    return jd, params, td


D_CASES = [("basic", {}), ("basic", {"no_antialias": True}),
           ("n_layers", {"n_layers_D": 4}),
           ("n_layers", {"n_layers_D": 2, "no_antialias": True}),
           ("pixel", {}), ("patch", {}), ("patch", {"no_antialias": True}),
           ("basic", {"norm": "none"})]


@pytest.mark.parametrize("netD,kw", D_CASES)
def test_discriminators_match_jax(netD, kw):
    jd, params, td = jax_and_port_D(netD, **kw)
    x = np.tanh(np_rng(1).standard_normal((2, 64, 64, 1))).astype(
        np.float32)
    ref = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = td(torch.from_numpy(to_nchw(x)))
    assert out.shape == to_nchw(ref).shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), to_nchw(ref), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("no_antialias", [False, True])
def test_basic_matches_the_torch_reference(no_antialias):
    td = define_D(input_nc=1, ndf=8, netD="basic", no_antialias=no_antialias,
                  generator=torch.Generator().manual_seed(3))
    ref = RefNLayerDiscriminator(input_nc=1, ndf=8, n_layers=3,
                                 no_antialias=no_antialias)
    ref.load_state_dict(td.state_dict(), strict=True)
    x = torch.tanh(torch.randn((2, 1, 64, 64),
                               generator=torch.Generator().manual_seed(4)))
    with torch.no_grad():
        torch.testing.assert_close(td(x), ref(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("netD", ["nope"])
def test_stylegan2_discriminators_raise(netD):
    """The StyleGAN2 discriminators are ported (test_torch_zoo_nets.py):
    only an unknown name is refused."""
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_D(netD=netD, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="not recognized"):
        RegistrationModel(RegistrationConfig(**dict(GAN, netD=netD)),
                          device="cpu")


def test_gradient_penalty_alpha_from_a_generator():
    td = define_D(input_nc=1, ndf=8, generator=torch.Generator().manual_seed(0))
    real, fake = torch.rand((2, 2, 1, 32, 32),
                            generator=torch.Generator().manual_seed(1))
    a, b = (gradient_penalty(td, real, fake,
                             generator=torch.Generator().manual_seed(6))
            for _ in range(2))
    assert float(a) == float(b) > 0
    assert gradient_penalty(td, real, fake, lambda_gp=0.0) == 0.0
