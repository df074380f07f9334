"""The zoo through the training step: the port's RegistrationModel.loss_fn
and train_step against the JAX RegistrationModel's train_step, from the
JAX model's init_state weights carried over by load_jax_params, with the
patch ids the JAX step draws (``test_torch_train.py::jax_patch_ids``).

Each case changes several choices from test_torch_train.py's small
config (and integrates in 2 steps, ``CASES_BASE``), so that every zoo
netG, netF, netR and netD is held once:

- unet: netG unet_128 (crop 128), netF sample, netD smallpatchstylegan2;
- munit: netG resnet_cat, netF global_pool, netR vxm_transformer (two
  fused levels: the JAX engine builds 8 GPT blocks a level), netD
  stylegan2;
- stylegan2 and small (``test_torch_zoo_train_stylegan2.py``, so that
  the suite's workers share the compiles): netG stylegan2, netF reshape,
  netR vxm_dual, netD patchstylegan2; netG smallstylegan2, netF
  strided_conv, netD tilestylegan2.

The weights are the port's initial ones (its initialisers are JAX's; the
flow head's times FLOW_GAIN, as in test_torch_train.py), carried to JAX
in the shapes of its ``init_state`` (traced, not compiled): each case
compiles one JAX program, its step.

JAX's gradients are read from its step's first Adam moment: with mu = 0
before the step, mu = (1 - beta1) g, and beta1 = 0.5 makes g = 2 mu
exactly.  With the D phase, G's loss in the step holds G_GAN against the
updated netD, and the port's ``loss_fn`` (JAX's ``_loss_fn`` without
netD) is the step's metrics less G_GAN.

Bars (test_torch_train.py's): metrics 1e-4 relative (1e-7 absolute where
a metric is ~0: global_pool's NCE has one row an image, so no negative
but the masked one); gradients of G, F, R and D max-abs <= GRAD_ENV
(1e-3) of the network's max |g|; one whole train_step under the
first-step Adam sign-artefact rule (``test_torch_gan.py::check_moved``),
netD after its phase too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import (_flax_path, load_jax_params,
                                            net_state_from_jax, to_nchw)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from test_torch_gan import check_moved
from test_torch_train import (CFG, FLOW_GAIN, GRAD_ENV, KEY, LR,
                              jax_patch_ids, named_params, tap_locations)
from test_torch_cli import few_threads  # noqa: F401 (autouse fixture)

GAN = dict(lambda_GAN=1.0, ndf=8)
# 2 integration steps: XLA:CPU's compile of the step grows with each
# unrolled warp (at 2 it takes about 60% of the time it takes at 7); the
# 7-step chain is held by test_torch_train.py
CASES_BASE = dict(int_steps=2)
CASES = {
    "unet": dict(netG="unet_128", nce_layers=(0, 2, 4, 6), crop_size=128,
                 netF="sample", netD="smallpatchstylegan2", **GAN),
    "munit": dict(netG="resnet_cat", nce_layers=(0, 1, 2, 3),
                  netF="global_pool", netR="vxm_transformer",
                  vxm_enc=(8, 16), vxm_dec=(16, 16, 8, 8),
                  netD="stylegan2", **GAN),
    "stylegan2": dict(netG="stylegan2", nce_layers=(1, 2, 3),
                      netF="reshape", netR="vxm_dual",
                      netD="patchstylegan2", **GAN),
    "small": dict(netG="smallstylegan2", nce_layers=(1, 2, 3),
                  netF="strided_conv", netD="tilestylegan2", **GAN),
}


def close_metric(v, r):
    return abs(float(v) - r) <= 1e-4 * abs(r) + 1e-7


def port_tree(tm, tree):
    """A JAX tree of G, F, R [, D] (params or gradients) in the port's
    names and layouts."""
    return {k: net_state_from_jax(tm, k, v) for k, v in tree.items()}


def _flax_leaf(module, name, p):
    """A port parameter as the flax leaf it came from: (key, array)."""
    w = p.detach().numpy()
    if isinstance(module, torch.nn.LayerNorm):
        return ("scale" if name == "weight" else name), w
    if isinstance(module, torch.nn.ConvTranspose2d) and name == "weight":
        return "kernel", w.transpose(2, 3, 0, 1)
    if isinstance(module, torch.nn.Conv2d) and name == "weight":
        return "kernel", w.transpose(2, 3, 1, 0)
    if isinstance(module, torch.nn.Linear) and name == "weight":
        return "kernel", w.T
    if w.ndim == 4:          # StyleGAN2's conv weights, the const input
        return name, (w.transpose(0, 2, 3, 1) if name == "const_input"
                      else w.transpose(2, 3, 1, 0))
    if w.ndim == 2:          # StyleGAN2's linear weights
        return name, w.T
    return name, w


def flax_from_port(net, shapes):
    """The flax tree of ``shapes`` (``jax.eval_shape`` of JAX's init)
    holding ``net``'s parameters: the inverse of ``state_from_flax``."""
    tree = jax.tree.map(lambda s: None, shapes)
    for mpath, module in net.named_modules():
        own = dict(module.named_parameters(recurse=False))
        if not own:
            continue
        if isinstance(module, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                               torch.nn.Linear)):
            leaf = "kernel"
        elif isinstance(module, torch.nn.LayerNorm):
            leaf = "scale"
        else:
            leaf = next(iter(own))
        _, path = _flax_path(shapes, mpath.split(".") if mpath else [], leaf)
        node, target = shapes, tree
        for k in path:
            node, target = node[k], target[k]
        for name, p in own.items():
            key, v = _flax_leaf(module, name, p)
            target[key] = np.ascontiguousarray(v).reshape(node[key].shape)
    missing = [k for k, v in jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: x is None) if v is None]
    assert not missing, missing
    return tree


def make_case(name):
    """The JAX step of case ``name`` from the port's initial weights (its
    initialisers are JAX's, and no JAX init is compiled), carried to JAX
    by ``flax_from_port`` and JAX's own ``convert_netR``."""
    cfg = dict(CFG, **CASES_BASE, **CASES[name])
    n = cfg["crop_size"]
    jm = JaxModel(JaxConfig(**cfg))
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    init = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        init.netR.flow.weight.mul_(FLOW_GAIN)
    params = {"G": flax_from_port(init.netG, shapes["G"]),
              "F": flax_from_port(init.netF, shapes["F"]),
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
    A, B = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
        load_jax_params(tm, params)
        return tm

    tm = port_model()
    ids = jax_patch_ids(KEY, tap_locations(tm, A), cfg["num_patches"])
    jp = jax.tree.map(jnp.asarray, params)
    gfr = {k: jp[k] for k in "GFR"}
    if jm.netD is None:
        opt_state = jm.tx.init(jp)
    else:
        opt_state = (jm.tx.init(gfr), jm.tx_d.init(jp["D"]))
    new_state, jmetrics = jm.train_step(
        TrainState(params=jp, opt_state=opt_state,
                   step=jnp.zeros((), jnp.int32)),
        jnp.asarray(a), jnp.asarray(b), KEY, jnp.float32(LR))
    mu = (new_state.opt_state.mu if jm.netD is None else
          dict(new_state.opt_state[0].mu, D=new_state.opt_state[1].mu))
    grads = jax.tree.map(lambda m: 2.0 * np.asarray(m), dict(mu))
    return dict(name=name, cfg=cfg, A=A, B=B, ids=ids,
                port_model=port_model, grads=port_tree(tm, grads),
                new=port_tree(tm, jax.tree.map(np.asarray,
                                               new_state.params)),
                jmetrics={k: float(v) for k, v in jmetrics.items()})


@pytest.fixture(scope="module", params=["unet", "munit"])
def case(request):
    return make_case(request.param)


def step_nets(tm):
    """{net: {name: parameter}} of the nets a step updates."""
    nets = {k: v for k, v in named_params(tm).items() if v}
    if tm.netD is not None:
        nets["D"] = dict(tm.netD.named_parameters())
    return nets


def check_loss_fn(case):
    """The port's loss_fn: the JAX step's metrics less the GAN term."""
    tm = case["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(case["A"], case["B"],
                                     patch_ids=case["ids"])
    ref = dict(case["jmetrics"])
    gan = ref.pop("G_GAN", None)
    for k in ("D", "D_fake", "D_real"):
        ref.pop(k, None)
    if gan is not None:
        ref["G"] -= gan
        ref["total"] -= gan
        assert float(metrics.pop("G_GAN")) == 0.0
    assert set(metrics) == set(ref)
    assert float(aux["pos_flow"].abs().max()) > 0.5      # the warps deform
    for k, v in metrics.items():
        assert close_metric(v, ref[k]), (k, float(v), ref[k])


def check_train_step(case):
    """One step: its metrics, its gradients (netD's in its phase) and the
    updated parameters.  A parameter that gets no gradient (the noise
    weight: no noise is drawn) has JAX's zero."""
    tm = case["port_model"]()
    nets = step_nets(tm)
    before = {net: {k: p.detach().clone() for k, p in ps.items()}
              for net, ps in nets.items()}
    grads_D = {}
    if tm.netD is not None:
        d_step = tm.d_step

        def spy(fake_B, real_B, lr):
            out = d_step(fake_B, real_B, lr)
            grads_D.update({k: p.grad.clone()
                            for k, p in tm.netD.named_parameters()})
            return out

        tm.d_step = spy
    metrics = tm.train_step(case["A"], case["B"], LR, patch_ids=case["ids"])
    assert set(metrics) == set(case["jmetrics"])
    for k, v in metrics.items():
        assert close_metric(v, case["jmetrics"][k]), (
            k, float(v), case["jmetrics"][k])
    grads = {net: grads_D if net == "D" else
             {k: torch.zeros_like(p) if p.grad is None else p.grad
              for k, p in ps.items()} for net, ps in nets.items()}
    for net, ps in grads.items():
        ref = case["grads"][net]
        assert set(ps) <= set(ref), net           # ref: StridedConvF's EMA too
        scale = max(float(g.abs().max()) for g in ref.values())
        assert scale > 0, net
        for name, g in ps.items():
            err = float((g - ref[name]).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)
    check_moved(nets, case["new"], before, grads)


def test_loss_fn_matches_jax(case):
    check_loss_fn(case)


def test_train_step_matches_jax(case):
    check_train_step(case)
