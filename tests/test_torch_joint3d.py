"""The joint model in 3-D, float32: the port's RegistrationModel at
``ndims=3`` (a 3-D ResnetGenerator, PatchSampleF over D * H * W
locations, a 3-D VxmDense, ``registered = warp(fake_B, pos_flow)`` in
3-D) against the JAX RegistrationModel(ndims=3), from the same weights
(the port's initial ones, through JAX's converters and back through
load_jax_params) and the patch ids the JAX step draws over D * H * W
locations.

JAX compiles a 3-D joint step slowly on the CPU, so the config is small
(16^3, ngf 8, resnet_2blocks, a 4-level netR of width 4, 2 integration
steps) and each JAX function is compiled once for the file:
``register``, and ``train_step``,
whose metrics are its ``_loss_fn``'s and whose first Adam moment gives
the gradients exactly (mu = (1 - beta1) g with beta1 = 0.5: g = 2 mu, as
``test_torch_zoo_train.py`` reads them).

Bars (test_torch_train.py's): ``register`` 1e-3 max-abs (PARITY.json);
metrics 1e-4 relative; gradients of G, F and R max-abs <= GRAD_ENV
(1e-3) of the network's max |g|; one whole train_step under the
first-step Adam sign-artefact rule; the 5-D weight and Adam bridge exact
(DHWIO kernels -> OIDHW, the transposed conv's in / out order), the
generators' forwards 1e-5.
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
from dfmir_tpu.nets.resnet_gen import ResnetGenerator as JaxResnetGenerator
from dfmir_tpu.ops import folding_fraction as jax_folding_fraction
from dfmir_tpu.ops import jacobian_det as jax_jacobian_det
from dfmir_tpu.ops import warp as jax_warp
from dfmir_tpu_torch import infer
from dfmir_tpu_torch.compat.convert import (adam_state_from_jax,
                                            load_jax_params,
                                            netG_state_from_jax, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_gan import check_moved
from test_torch_train import GRAD_ENV, KEY, LR, _jax_ids, named_params
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo_train import close_metric, port_tree

S = 16
# ngf 8 and netF_nc 16 (test_torch_train.py's): at ngf 4 a tap of 4
# channels gives some patch an all-zero ReLU in netF's MLP, where JAX's
# gradients are NaN (the L2 norm's square root of 0)
# 2 integration steps: XLA:CPU compiles the unrolled 3-D chain slowly
# (register 32 s and the step 110 s at 7 steps, 4 s and 29 s at 2, on
# this config); the 7-step 3-D chain is held by test_torch_vxm3d.py and
# test_torch_vecint_chain3d.py
CFG3D = dict(ndims=3, crop_size=S, ngf=8, netG="resnet_2blocks",
             vxm_enc=(4, 4, 4, 4), vxm_dec=(4, 4, 4, 4, 4, 4, 4),
             netF_nc=16, num_patches=16, int_steps=2)
FLOW_GAIN = 1e5     # the flow head N(0, 1e-5) -> max |pos_flow| ~1 voxel
REGISTER_TOL = 1e-3
REGISTER3D = {"vecint3d_fwd": 1, "warp3d_trilinear_fwd": 1}
# the data warp's backward is dflow alone (its sources need no gradient);
# registered's is dflow and dsrc (fake_B's gradient into netG)
STEP3D = {"vecint3d_fwd": 1, "warp3d_trilinear_fwd": 2, "vecint3d_bwd": 1,
          "warp3d_trilinear_bwd_dflow": 2, "warp3d_trilinear_bwd_dsrc": 1}


def tap_locations3d(tm, x):
    """D * H * W of every tapped layer of the port's generator."""
    with torch.no_grad():
        feats = tm.netG(x, layers=tuple(tm.cfg.nce_layers), encode_only=True)
    return [int(np.prod(f.shape[2:])) for f in feats]


def jax_patch_ids3d(key, n_locs, num_patches):
    """The ids the JAX step draws for its NCE calls (kF1, kF2, kF3) over
    each tap's D * H * W locations."""
    return [_jax_ids(k, n_locs, num_patches)
            for k in jax.random.split(key, 5)[:3]]


def volumes(seed, batch=2):
    rng = np.random.default_rng(seed)
    return [np.tanh(2 * rng.standard_normal((batch, S, S, S, 1))).astype(
        np.float32) for _ in range(2)]


def make_setup(cfg, gain, jax_step=True):
    """The JAX model, the port's initial weights (flow head times
    ``gain``) carried to JAX by its own converters (JAX's eager init of
    the 3-D model takes over a minute on the CPU), two volumes, the port
    model factory (those weights back through load_jax_params), the patch
    ids and JAX's register (and train_step) outputs."""
    jm = JaxModel(JaxConfig(**cfg))
    init = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        init.netR.flow.weight.mul_(gain)
    params = {"G": jax_convert.convert_netG(init.netG.state_dict(),
                                            init.netG.specs),
              "F": jax_convert.convert_netF(init.netF.state_dict(),
                                            len(init.cfg.nce_layers)),
              "R": jax_convert.convert_netR(init.netR.state_dict(),
                                            cfg["vxm_enc"], cfg["vxm_dec"])}
    a, b = volumes(0)
    A, B = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
        load_jax_params(tm, params)
        return tm

    jp = jax.tree.map(jnp.asarray, params)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    out = dict(jm=jm, init=init, params=params, jp=jp, a=a, b=b, A=A, B=B,
               port_model=port_model,
               ids=jax_patch_ids3d(KEY, tap_locations3d(port_model(), A),
                                   cfg["num_patches"]),
               register=[np.asarray(o) for o in jm.register(jp, ja, jb)])
    if jax_step:
        assert jm.cfg.beta1 == 0.5
        new_state, metrics = jm.train_step(
            TrainState(params=jp, opt_state=jm.tx.init(jp),
                       step=jnp.zeros((), jnp.int32)),
            ja, jb, KEY, jnp.float32(LR))
        opt = jax.tree.map(np.asarray, {"count": new_state.opt_state.count,
                                        "mu": new_state.opt_state.mu,
                                        "nu": new_state.opt_state.nu})
        tm = port_model()
        out.update(metrics={k: float(v) for k, v in metrics.items()},
                   opt=opt, grads=port_tree(tm, jax.tree.map(
                       lambda m: 2.0 * m, dict(opt["mu"]))),
                   new=port_tree(tm, jax.tree.map(np.asarray,
                                                  new_state.params)))
    return out


@pytest.fixture(scope="module")
def setup():
    return make_setup(CFG3D, FLOW_GAIN)


def test_register_matches_jax(setup):
    s = setup
    out = s["port_model"]().register(s["A"], s["B"])
    assert 0.5 < float(out[3].abs().max()) < 3.0     # the warps deform
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          s["register"]):
        assert tuple(o.shape) == (2, r.shape[-1], S, S, S), name
        err = float(np.abs(to_nhwc(o) - r).max())
        assert err <= REGISTER_TOL, (name, err)


def test_register_pair_outputs_3d(setup):
    """infer.register_pair_outputs on a 3-D pair with a label volume: the
    Jacobian map, the folding fraction and the nearest label warp against
    JAX's on JAX's field."""
    s = setup
    label = (np.floor(3 * (s["a"] + 1)) * 60 / 255).astype(np.float32)
    out = infer.register_pair_outputs(s["port_model"](), s["A"], s["B"],
                                      torch.from_numpy(to_nchw(label)))
    flow = jnp.asarray(s["register"][3])
    np.testing.assert_allclose(out["jac_det"].numpy(),
                               np.asarray(jax_jacobian_det(flow)), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(out["folding_fraction"].numpy(),
                               np.asarray(jax_folding_fraction(flow)),
                               rtol=0, atol=2e-3)
    ref = np.asarray(jax_warp(jnp.asarray(label), flow, mode="nearest"))
    got = to_nhwc(out["label_warped"])
    assert set(np.unique(got)) <= set(np.unique(label))
    # a voxel whose coordinate sits within the field's error of .5 may round
    # the other way
    assert float((got != ref).mean()) < 1e-3


def test_loss_fn_matches_jax(setup):
    s = setup
    tm = s["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    assert set(metrics) == set(s["metrics"]) == {
        "G", "NCE", "NCE_Y", "R", "smooth", "local", "total"}
    assert tuple(aux["registered"].shape) == (2, 1, S, S, S)
    for k, v in metrics.items():
        assert abs(float(v) - s["metrics"][k]) <= 1e-4 * abs(
            s["metrics"][k]), (k, float(v), s["metrics"][k])


def test_gradients_match_jax(setup):
    s = setup
    tm = s["port_model"]()
    total, _, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    total.backward()
    for net, params in named_params(tm).items():
        ref = s["grads"][net]
        assert set(params) == set(ref), net
        scale = max(float(g.abs().max()) for g in ref.values())
        assert scale > 0, net
        for name, p in params.items():
            err = float((p.grad - ref[name]).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)


def test_train_step_matches_jax(setup):
    s = setup
    tm = s["port_model"]()
    nets = named_params(tm)
    before = {net: {k: p.detach().clone() for k, p in ps.items()}
              for net, ps in nets.items()}
    metrics = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    for k, v in metrics.items():
        assert close_metric(v, s["metrics"][k]), (k, float(v),
                                                  s["metrics"][k])
    grads = {net: {k: p.grad for k, p in ps.items()}
             for net, ps in nets.items()}
    check_moved(nets, s["new"], before, grads)
    # Adam's first moments against JAX's, mapped by the 5-D bridge: mu is
    # (1 - beta1) g, so the gradients' bar halves
    mine = tm.optimizer.state_dict()["state"]
    ref = adam_state_from_jax(s["opt"], tm)["state"]
    assert set(mine) == set(ref)
    owner = [net for net, ps in nets.items() for _ in ps]
    for i, st in mine.items():
        assert float(st["step"]) == float(ref[i]["step"]) == 1.0
        for key in ("exp_avg", "exp_avg_sq"):
            assert st[key].shape == ref[i][key].shape
        scale = max(float(g.abs().max())
                    for g in s["grads"][owner[i]].values())
        err = float((st["exp_avg"] - ref[i]["exp_avg"]).abs().max())
        assert err <= 0.5 * GRAD_ENV * scale, (owner[i], i, err, scale)


def test_weight_bridge_5d_round_trip(setup):
    """load_jax_params on the 3-D model's JAX tree (DHWIO conv kernels,
    (in, out) Dense kernels) gives back the port's weights bit for bit."""
    s = setup
    tm = s["port_model"]()
    for net in ("netG", "netF", "netR"):
        mine = getattr(tm, net).state_dict()
        orig = getattr(s["init"], net).state_dict()
        assert set(mine) == set(orig), net
        for k, v in orig.items():
            assert torch.equal(mine[k], v), (net, k)
    assert sum(p.ndim == 5 for p in tm.netG.parameters()) >= 10


def test_adam_state_bridge_5d(setup):
    """JAX's Adam state after the step, loaded into a port model through
    the bridge: every 5-D moment in the port's layout (a conv's OIDHW),
    equal to JAX's DHWIO one transposed, and the model steps on from it."""
    s = setup
    tm = s["port_model"]()
    tm.optimizer.load_state_dict(adam_state_from_jax(s["opt"], tm))
    mu = s["opt"]["mu"]["G"]
    k5 = [p for p in tm.netG.parameters() if p.ndim == 5]
    assert k5, "no 5-D kernel in the 3-D generator"
    st = tm.optimizer.state[tm.netG.model[1].weight]
    ref = np.transpose(mu["layer_1"]["Conv_0"]["kernel"], (4, 3, 0, 1, 2))
    assert np.array_equal(st["exp_avg"].numpy(), ref)
    assert all(tm.optimizer.state[p]["exp_avg"].shape == p.shape
               for net in (tm.netG, tm.netF, tm.netR)
               for p in net.parameters())
    m = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(tm.optimizer.state[tm.netG.model[1].weight]["step"]) == 2.0


@pytest.mark.parametrize("no_antialias", [False, True])
def test_generator_bridge_5d(no_antialias):
    """A 3-D ResnetGenerator with JAX's weights through
    netG_state_from_jax: output and taps within 1e-5 of JAX's, antialiased
    (blur down / up) and with strided and transposed convs (the
    transposed conv's kernel is (in, out, D, H, W))."""
    kw = dict(input_nc=1, output_nc=1, ngf=4, n_blocks=1,
              no_antialias=no_antialias, no_antialias_up=no_antialias)
    jg = JaxResnetGenerator(**kw)
    x = volumes(3, batch=1)[0][:, :8, :8, :8]
    layers = (0, 4, 8, 12)
    params = jg.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    out, feats = jg.apply({"params": params}, jnp.asarray(x), layers=layers)
    tg = ResnetGenerator(ndims=3, generator=torch.Generator().manual_seed(0),
                         **kw)
    sd = netG_state_from_jax(jax.tree.map(np.asarray, params), tg.specs)
    if no_antialias:
        assert sd["model.11.weight"].ndim == 5       # the first convT
        assert tuple(sd["model.11.weight"].shape[:2]) == (16, 8)
    tg.load_state_dict(sd, strict=False)
    assert set(sd) == {k for k in tg.state_dict() if not k.endswith("filt")}
    with torch.no_grad():
        t_out, t_feats = tg(torch.from_numpy(to_nchw(x)), layers=layers)
    for o, r in zip([t_out] + t_feats, [out] + list(feats)):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0,
                                   atol=1e-5)


def test_launches_3d(setup, counted_kernels):
    """A 3-D register call 1 vecint3d_fwd + 1 B3; a 3-D joint step 1 + 2
    forward, 1 vecint3d_bwd + 2 B4 + 1 B5 (registered's source gradient
    into netG), counted with the plain kernels."""
    s = setup
    tm = s["port_model"]()
    tm.register(s["A"], s["B"])
    assert counted_kernels == dict(counted_kernels, **REGISTER3D)
    assert sum(counted_kernels.values()) == 2
    for k in counted_kernels:
        counted_kernels[k] = 0
    m = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    assert counted_kernels == dict(counted_kernels, **STEP3D)
    assert sum(counted_kernels.values()) == sum(STEP3D.values())
    # the counted plain kernels compute what the CPU path computes
    assert close_metric(m["total"], s["metrics"]["total"])
