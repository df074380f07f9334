"""The slice as a whole: the port's RegistrationModel.register and
infer.register_pair_outputs against the JAX RegistrationModel, with the
JAX model's own init_state weights carried over by load_jax_params.

Tolerances: 1e-3 max-abs on register's outputs (the end-to-end parity
bar), 1e-4 on the Jacobian map and folding fraction, exact equality on the
nearest-mode label warp."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.ops import folding_fraction as jax_folding_fraction
from dfmir_tpu.ops import jacobian_det as jax_jacobian_det
from dfmir_tpu.ops import warp as jax_warp
from dfmir_tpu_torch import infer
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel

CFG = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
           vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
           netF_nc=16, num_patches=16)
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(**CFG))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    tm = RegistrationModel(RegistrationConfig(**CFG), device="cpu")
    load_jax_params(tm, params)
    return jm, jax.tree.map(jnp.asarray, params), tm


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    b = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    label = (rng.integers(0, 4, (2, 64, 64, 1)) * 60 / 255).astype(np.float32)
    return a, b, label


def test_register_matches_jax(models, pair):
    jm, params, tm = models
    a, b, _ = pair
    ref = jm.register(params, jnp.asarray(a), jnp.asarray(b))
    out = tm.register(torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)))
    assert np.max(np.abs(np.asarray(ref[3]))) > 0.5     # pos_flow deforms
    names = ("fake_B", "idt_B", "y_source", "pos_flow")
    for name, o, r in zip(names, out, ref):
        assert o.shape == to_nchw(r).shape, name
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0,
                                   atol=1e-3, err_msg=name)


def test_register_pair_outputs_match_test_py(models, pair):
    """The per-pair outputs test.py composes from register (test.py:82-97)."""
    jm, params, tm = models
    a, b, label = pair
    _, _, _, pos_flow = jm.register(params, jnp.asarray(a), jnp.asarray(b))
    lab_ref = np.asarray(jax_warp(jnp.asarray(label), pos_flow,
                                  mode="nearest"))
    det_ref = np.asarray(jax_jacobian_det(pos_flow))
    fold_ref = np.asarray(jax_folding_fraction(pos_flow))

    out = infer.register_pair_outputs(
        tm, torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)),
        label=torch.from_numpy(to_nchw(label)))
    assert not np.array_equal(lab_ref, label)           # the labels moved
    np.testing.assert_array_equal(to_nhwc(out["label_warped"]), lab_ref)
    np.testing.assert_allclose(out["jac_det"].numpy(), det_ref, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["folding_fraction"].numpy(), fold_ref,
                               rtol=0, atol=1e-4)


def test_flow_stats_and_metrics_agree(models, pair):
    _, _, tm = models
    a, b, _ = (torch.from_numpy(to_nchw(x)) for x in pair)
    stats = tm.flow_stats(a, b)
    metrics = tm.registration_metrics(a, b)
    assert float(stats["jac_min"]) == float(metrics["jac_det"].min())
    assert float(stats["fold"]) == float(metrics["folding_fraction"].mean())
    assert float(stats["flow_max"]) > 0.5


def test_no_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RegistrationModel(RegistrationConfig(**CFG))


@pytest.mark.parametrize("field,value", [
    ("netG", "nope_9blocks"), ("netR", "nope"),
])
def test_unported_choices_raise(field, value):
    """Every JAX choice is ported: only an unknown name is refused."""
    cfg = RegistrationConfig(**dict(CFG, **{field: value}))
    with pytest.raises(NotImplementedError, match="nope"):
        RegistrationModel(cfg, device="cpu")


@pytest.mark.parametrize("field,value,match", [
    ("netG", "unet_256", "A13c"), ("netF", "reshape", "A13c"),
    ("netR", "vxm_dual", "A13c"), ("netD", "tilestylegan2", "A13c"),
    ("ndims", 3, "cannot run"),
])
def test_zoo_refusals(field, value, match):
    """bfloat16 with a zoo choice waits for ROADMAP A13c; the zoo at
    ndims=3 is what the JAX package cannot run."""
    kw = dict(CFG, compute_dtype="bfloat16", lambda_GAN=1.0,
              **{field: value})
    if field == "ndims":
        kw.update(compute_dtype="float32", netR="vxm_dual", lambda_GAN=0.0)
    with pytest.raises(NotImplementedError, match=match):
        RegistrationModel(RegistrationConfig(**kw), device="cpu")
