"""``compute_dtype="bfloat16"`` with each zoo choice in 2-D, against the
JAX package's bfloat16 model (never against float32): ``register`` and
``loss_fn`` from the same weights and patch ids, one case a choice.

Each case changes one choice from test_torch_train.py's small config, at
2 integration steps (``test_torch_zoo_train.py``'s ``CASES_BASE``: the
7-step chain is held in bfloat16 by test_torch_bf16.py).  The weights are
the port's initial ones, the flow head's times BF16_GAIN, carried to JAX
in the shapes of its ``init_state`` (traced, not compiled); JAX's
``register`` and ``_loss_fn`` are compiled once for the cases that share
them (``jax_run``), neither with a gradient.

What JAX computes, and the port with it: ``_cast_params`` casts every
float32 leaf of netG and netR, whatever the family; netG takes a bfloat16
input (unet's skip concatenations and final tanh in bfloat16, munit's
LayerNorm reducing in float32 and returning bfloat16, StyleGAN2's FIR
taps and runtime scales in the input's dtype, no noise drawn); the
transformer netRs take float32 inputs, which flax promotes against the
bfloat16 kernels, so they compute in float32 on rounded weights; netF and
netD are not cast and see float32 maps.  JAX's ``_loss_fn`` holds no
netD term (G_GAN 0), so a netD case also scores JAX's bfloat16 fake_B and
real_B with both netDs (eagerly in JAX): D(fake), D(real) and their mean
at the float32 bar, 1e-4 relative.

Bars (test_torch_bf16.py's): fake_B and idt_B 0.1 max-abs, pos_flow 1e-3
on a field of about 0.1 px (BF16_GAIN: 0.03-0.1 px over the cases at 2
integration steps), y_source 1e-2; metrics 1e-2 relative (1e-7 absolute
below: global_pool's NCE is ~0).  A port step
keeps every master parameter and Adam moment float32 and launches the CUT
step's kernels.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.losses import gan_loss as jax_gan_loss
from dfmir_tpu.nets.patch_sample import l2_normalize as jax_l2_normalize
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.losses import gan_loss
from dfmir_tpu_torch.nets.patch_sample import l2_normalize
from test_torch_bf16 import METRIC_BAR, REGISTER_BARS
from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_train import CFG, KEY, LR, jax_patch_ids, tap_locations
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo_train import CASES_BASE, flax_from_port

BF16 = dict(CFG, **CASES_BASE, compute_dtype="bfloat16")
BF16_GAIN = 6e3
GAN = dict(lambda_GAN=1.0, ndf=8)
# one zoo choice a case, as chip_smoke.py's phase bf16_zoo changes them
# (unet_128 at crop 128 stands for unet_256, which needs a side of 2^8)
CHOICES = {
    "netG_unet_128": dict(netG="unet_128", nce_layers=(0, 2, 4, 6),
                          crop_size=128),
    "netG_resnet_cat": dict(netG="resnet_cat", nce_layers=(0, 1, 2, 3),
                            ngf=32),
    "netG_stylegan2": dict(netG="stylegan2", nce_layers=(1, 2, 3)),
    "netG_smallstylegan2": dict(netG="smallstylegan2", nce_layers=(1, 2, 3)),
    "netF_sample": dict(netF="sample"),
    "netF_global_pool": dict(netF="global_pool"),
    "netF_reshape": dict(netF="reshape"),
    "netF_strided_conv": dict(netF="strided_conv"),
    "netR_vxm_transformer": dict(netR="vxm_transformer", vxm_enc=(8, 16),
                                 vxm_dec=(16, 16, 8, 8)),
    "netR_vxm_dual": dict(netR="vxm_dual"),
    "netD_stylegan2": dict(netD="stylegan2", **GAN),
    "netD_patchstylegan2": dict(netD="patchstylegan2", **GAN),
    "netD_tilestylegan2": dict(netD="tilestylegan2", **GAN),
}
STEP = {"vecint2d_fwd": 1, "warp2d_bilinear_fwd": 2, "vecint2d_bwd": 1,
        "warp2d_bilinear_bwd": 2}


def close(v, r, bar=METRIC_BAR):
    return abs(float(v) - r) <= bar * abs(r) + 1e-7


# JAX's outputs, shared by the cases that run the same JAX program on the
# same inputs: ``register`` reads netG and netR alone, ``_loss_fn`` every
# net but netD, and the port draws netF after netR and netD last, so the
# netF and netD cases hold the same netG and netR weights (checked leaf
# for leaf when a case takes a shared output)
_JAX_RUNS = {}


def jax_run(what, cfg, skip, params, fn):
    """fn() once for ``what`` at ``cfg`` without the fields ``skip``; a
    later case with that key must read the same ``params``."""
    key = (what,) + tuple(sorted((k, v) for k, v in cfg.items()
                                 if k not in skip))
    if key in _JAX_RUNS:
        seen, out = _JAX_RUNS[key]
        assert jax.tree_util.tree_all(jax.tree.map(np.array_equal, seen,
                                                   params))
        return out
    out = fn()
    _JAX_RUNS[key] = (params, out)
    return out


def make_case(name):
    cfg = dict(BF16, **CHOICES[name])
    n = cfg["crop_size"]
    jm = JaxModel(JaxConfig(**cfg))
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    init = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        init.netR.flow.weight.mul_(BF16_GAIN)
    # the paper model's nets through JAX's own converters, the zoo's by
    # flax's module names
    params = {"G": (jax_convert.convert_netG(init.netG.state_dict(),
                                             init.netG.specs)
                    if cfg["netG"].startswith("resnet_") and
                    cfg["netG"].endswith("blocks") else
                    flax_from_port(init.netG, shapes["G"])),
              "F": (jax_convert.convert_netF(init.netF.state_dict(),
                                             len(init.cfg.nce_layers))
                    if cfg.get("netF", "mlp_sample") == "mlp_sample" else
                    flax_from_port(init.netF, shapes["F"])),
              "R": (jax_convert.convert_netR(init.netR.state_dict(),
                                             cfg["vxm_enc"], cfg["vxm_dec"])
                    if cfg.get("netR", "vxm") == "vxm" else
                    flax_from_port(init.netR, shapes["R"]))}
    if init.netD is not None:
        params["D"] = flax_from_port(init.netD, shapes["D"])
    params = jax.tree.map(lambda x: np.array(x, dtype=np.float32), params)
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, n, n, 1))).astype(np.float32)
            for _ in range(2))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
        load_jax_params(tm, params)
        return tm

    A, B = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))
    jp = jax.tree.map(jnp.asarray, params)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    register = jax_run(
        "register", cfg, ("netF", "netD", "lambda_GAN", "ndf"),
        {k: params[k] for k in "GR"},
        lambda: [np.asarray(o) for o in jm.register(jp, ja, jb)])
    _, (metrics, aux) = jax_run(
        "loss_fn", cfg, ("netD", "ndf"), {k: params[k] for k in "GFR"},
        lambda: jax.jit(lambda p: jm._loss_fn(p, ja, jb, KEY))(jp))
    d_losses = None
    if jm.netD is not None:
        def score(x):
            return jm.netD.apply({"params": jp["D"]}, x)

        fake, real = jax_gan_loss(score(aux["fake_B"]), False), jax_gan_loss(
            score(jb), True)
        d_losses = {"fake_B": np.array(to_nchw(aux["fake_B"])),
                    "D_fake": float(fake), "D_real": float(real),
                    "D": float((fake + real) * 0.5)}
    return dict(cfg=cfg, A=A, B=B, port_model=port_model,
                ids=jax_patch_ids(KEY, tap_locations(port_model(), A),
                                  cfg["num_patches"]),
                register=register, d_losses=d_losses,
                metrics={k: float(v) for k, v in metrics.items()},
                pos_flow=np.asarray(aux["pos_flow"]))


# the netR choices here, the netG ones in test_torch_zoo_bf16_netg.py, netF
# in test_torch_zoo_bf16_heads.py and netD in test_torch_zoo_bf16_netd.py:
# files of at most 12 cases, which the suite's workers run side by side
@pytest.fixture(scope="module", params=[k for k in CHOICES
                                        if k.startswith("netR")])
def case(request):
    return make_case(request.param)


def check_register(case):
    out = case["port_model"]().register(case["A"], case["B"])
    assert 0.02 < float(out[3].abs().max()) < 0.15      # it deforms
    for name, o, r in zip(REGISTER_BARS, out, case["register"]):
        assert o.dtype == torch.float32, name
        err = float(np.abs(to_nhwc(o) - r).max())
        assert err <= REGISTER_BARS[name], (name, err)


def check_loss_fn(case):
    tm = case["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(case["A"], case["B"],
                                     patch_ids=case["ids"])
        assert set(metrics) == set(case["metrics"])
        for k, v in metrics.items():
            assert close(v, case["metrics"][k]), (k, float(v),
                                                   case["metrics"][k])
        for k, v in aux.items():
            assert v.dtype == torch.float32, k
        np.testing.assert_allclose(to_nhwc(aux["pos_flow"]),
                                   case["pos_flow"], rtol=0,
                                   atol=REGISTER_BARS["pos_flow"])
        if case["d_losses"] is not None:
            # netD is not cast: on JAX's fake_B it scores what JAX's does,
            # at the float32 bar
            ref = dict(case["d_losses"])
            fake = gan_loss(tm.netD(torch.from_numpy(ref.pop("fake_B"))),
                            False)
            real = gan_loss(tm.netD(case["B"]), True)
            mine = {"D_fake": fake, "D_real": real, "D": (fake + real) * 0.5}
            for k, r in ref.items():
                assert close(mine[k], r, 1e-4), (k, float(mine[k]), r)


def check_step(case, counted):
    """One bf16 train step: finite, the CUT step's launches, every master
    parameter and Adam moment float32 (netD's too)."""
    tm = case["port_model"]()
    m = tm.train_step(case["A"], case["B"], LR, patch_ids=case["ids"])
    assert all(math.isfinite(float(v)) for v in m.values())
    assert counted == dict(counted, **STEP)
    assert sum(counted.values()) == sum(STEP.values())
    nets = [tm.netG, tm.netF, tm.netR] + [tm.netD] * (tm.netD is not None)
    opts = [tm.optimizer] + [tm.optimizer_D] * (tm.netD is not None)
    assert all(p.dtype == torch.float32 for net in nets
               for p in net.parameters())
    assert opts[-1].state and all(
        st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
        for opt in opts for st in opt.state.values())


def test_register_matches_jax_bf16(case):
    check_register(case)


def test_loss_fn_matches_jax_bf16(case):
    check_loss_fn(case)


def test_step_keeps_float32_state(case, counted_kernels):
    check_step(case, counted_kernels)


def test_l2_normalize_zero_patch():
    """A patch of exactly 0 (a bfloat16 generator's output holds a few
    exact zeros a step on the card, and netF ``sample`` normalises the
    1-channel tap 0 as it is) gets l2_normalize's derivative there, I /
    eps, where the JAX package's autodiff gives NaN; elsewhere the port's
    function and gradient are JAX's."""
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)
    x[3] = 0.0
    g = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    out = l2_normalize(t)
    out.backward(torch.from_numpy(g))
    ref, vjp = jax.vjp(jax_l2_normalize, jnp.asarray(x))
    ref_g = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    assert np.isnan(ref_g[3]).all()
    assert not np.isnan(np.delete(ref_g, 3, 0)).any()
    np.testing.assert_allclose(t.grad[3].numpy(), g[3] / 1e-7, rtol=1e-6)
    np.testing.assert_allclose(np.delete(t.grad.numpy(), 3, 0),
                               np.delete(ref_g, 3, 0), rtol=1e-5, atol=1e-6)
