"""The 3-D zoo in the joint model, case unet: netG unet with 4 levels on
both sides (the JAX model's ``netG`` attribute, the port's engine's
factory while the model is built), its taps 0-3 through netF mlp_sample,
against the JAX model (``test_torch_zoo3d_train.py`` holds the setup and
the bars); and the real ``unet_128`` at 128^3, its smallest cube, at ngf
2: the port's ``register`` against JAX's on the port's weights (JAX's
eager ``init_state`` there takes a minute; its shapes are traced)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from test_torch_joint3d import CFG3D, FLOW_GAIN, REGISTER_TOL

from dfmir_tpu_torch.nets.unet_gen import UnetGenerator
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo3d_train import (UNET_DOWNS, check_launches,
                                    check_register, jax_params, make_case3d)
from test_torch_zoo_train import check_loss_fn, check_train_step
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def case():
    return make_case3d("unet")


def test_register_matches_jax(case):
    check_register(case)


def test_loss_fn_matches_jax(case):
    tm = case["port_model"]()
    assert isinstance(tm.netG, UnetGenerator)
    assert tm.netG.num_downs == UNET_DOWNS and tm.netG.up_0.weight.ndim == 5
    check_loss_fn(case)


def test_train_step_matches_jax(case):
    check_train_step(case)


def test_launches_3d_zoo(case, counted_kernels):
    check_launches(case, counted_kernels)


def test_unet_128_register_at_128_matches_jax():
    cfg = dict(CFG3D, netG="unet_128", nce_layers=(0, 2, 4, 6),
               crop_size=128, ngf=2)
    tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        tm.netR.flow.weight.mul_(FLOW_GAIN)
    assert tm.netG.num_downs == 7
    jm = JaxModel(JaxConfig(**cfg))
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    params = jax.tree.map(jnp.asarray, jax_params(cfg, tm, shapes))
    rng = np.random.default_rng(5)
    a, b = (np.tanh(2 * rng.standard_normal((1, 128, 128, 128, 1))).astype(
        np.float32) for _ in range(2))
    ref = jm.register({k: params[k] for k in "GR"}, jnp.asarray(a),
                      jnp.asarray(b))
    out = tm.register(torch.from_numpy(to_nchw(a)),
                      torch.from_numpy(to_nchw(b)))
    assert float(out[3].abs().max()) > 0.1          # the warps deform
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          ref):
        err = float(np.abs(to_nhwc(o) - np.asarray(r)).max())
        assert err <= REGISTER_TOL, (name, err)
