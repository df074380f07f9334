"""The 3-D zoo in the joint model: the port's RegistrationModel at
``ndims=3`` with a zoo choice against the JAX RegistrationModel(ndims=3)
with the same choice, from the same weights (the port's initial ones,
carried to JAX in the shapes of its abstractly traced ``init_state``),
the same volumes and the patch ids the JAX step draws over D * H * W
locations (``test_torch_joint3d.py``'s config: 16^3, ngf 8,
resnet_2blocks, a netR of width 4, 2 integration steps).

Each case changes several choices, so that one JAX step compile holds
them together (as ``test_torch_zoo_train.py`` does in 2-D); each case is
a file, so that the suite's workers share the compiles:

- heads (this file): netF global_pool (one row of W * C a volume: JAX
  pools D and H only), netR vxm_dual, netD n_layers with 2 layers (at
  16^3 ``basic``'s 3 layers leave an empty map: 16 -> 15 -> 8 -> 7 -> 4
  -> 3 -> 2 -> 1 -> 0);
- strided (``test_torch_zoo3d_train_strided.py``): netF strided_conv
  (taps 4-16), netD pixel;
- unet (``test_torch_zoo3d_train_unet.py``): netG unet, shallowed to 4
  levels on both sides (``unet_128``'s 7 need a side of 128, where JAX's
  compiles take minutes).

Bars (test_torch_train.py's): ``register`` 1e-3 max-abs; ``loss_fn``
metrics 1e-4 relative (1e-7 absolute where a metric is ~0; 1e-6 in case
heads, whose global_pool NCE, one row a volume and so no negative but the
masked one, is 0 up to the rounding of logits of order 1 / nce_T = 14.3,
one float32 ulp of which is 9.5e-7); a
``train_step``'s metrics likewise, its gradients (read through JAX's
first Adam moment, g = 2 mu) within GRAD_ENV (1e-3) of each network's max
|g|, netD's from ``d_step``, and every parameter moved as JAX's
(``check_moved``); launches those of the 3-D joint step.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.nets.unet_gen import UnetGenerator as JUnet
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine import registration
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from dfmir_tpu_torch.nets.unet_gen import UnetGenerator
from test_torch_joint3d import (CFG3D, FLOW_GAIN, REGISTER3D, REGISTER_TOL,
                                STEP3D, jax_patch_ids3d, tap_locations3d)
from test_torch_train import KEY, LR
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo_train import (GAN, check_loss_fn, check_train_step,
                                  close_metric, flax_from_port, port_tree)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

S = CFG3D["crop_size"]
UNET_DOWNS = 4          # 16 -> 8 -> 4 -> 2 -> 1
# strided_conv's taps but 0: tap 0, the padded input (22^3), leaves 20^3
# = 8000 patch locations, whose PatchNCE logits (8000^2 a call) take most
# of a CPU step; taps 4-16 hold the same head at 2744-8 locations
STRIDED_LAYERS = (4, 8, 12, 16)
CASES3D = {
    "heads": dict(netF="global_pool", netR="vxm_dual", netD="n_layers",
                  n_layers_D=2, **GAN),
    "strided": dict(netF="strided_conv", netD="pixel",
                    nce_layers=STRIDED_LAYERS, **GAN),
    "unet": dict(netG="unet_128", nce_layers=(0, 1, 2, 3)),
}
METRIC_FLOOR = {"heads": 1e-6}
# the flow head's gain: the unet case draws netR after another netG, whose
# field at 1e5 stays under half a voxel
FLOW_GAINS = {"unet": 2 * FLOW_GAIN}


@contextlib.contextmanager
def shallow_unet(cfg):
    """While open, the port's engine builds a ``unet_*`` netG with
    UNET_DOWNS levels (the JAX side swaps its ``netG`` attribute)."""
    real = registration.define_G

    def define_G(**kw):
        if not kw["netG"].startswith("unet"):
            return real(**kw)
        return UnetGenerator(
            kw["input_nc"], kw["output_nc"], UNET_DOWNS, kw["ngf"],
            kw["norm"], kw["use_dropout"], kw["init_type"], kw["init_gain"],
            ndims=kw["ndims"], generator=kw["generator"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registration, "define_G", define_G)
        yield


def jax_model(cfg):
    """The JAX model of ``cfg``; a unet netG shallowed to UNET_DOWNS
    levels (its attribute: the JAX package is not changed)."""
    jm = JaxModel(JaxConfig(**cfg))
    if cfg.get("netG", "").startswith("unet"):
        c = jm.cfg
        jm.netG = JUnet(input_nc=c.input_nc, output_nc=c.output_nc,
                        num_downs=UNET_DOWNS, ngf=c.ngf, norm=c.normG,
                        use_dropout=not c.no_dropout,
                        init_type=c.init_type, init_gain=c.init_gain)
    return jm


def jax_netD_tree(net):
    """The port's NLayer / pixel discriminator as JAX's tree: the k-th
    conv is ``conv_<k>/Conv_0`` ((out, in, *k) -> (*k, in, out))."""
    convs = [m for m in net.modules()
             if isinstance(m, torch.nn.modules.conv._ConvNd)]
    return {f"conv_{k}": {"Conv_0": {
        "kernel": np.moveaxis(m.weight.detach().numpy(), (1, 0), (-2, -1)),
        "bias": m.bias.detach().numpy()}} for k, m in enumerate(convs)}


def jax_params(cfg, init, shapes):
    """The weights of ``init`` (a port model of ``cfg``) as the JAX
    model's tree of ``shapes`` (its traced ``init_state``), float32."""
    params = {
        "G": (jax_convert.convert_netG(init.netG.state_dict(),
                                       init.netG.specs)
              if isinstance(init.netG, ResnetGenerator)
              else flax_from_port(init.netG, shapes["G"])),
        "F": (jax_convert.convert_netF(init.netF.state_dict(),
                                       len(init.cfg.nce_layers))
              if init.cfg.netF in ("sample", "mlp_sample")
              else flax_from_port(init.netF, shapes["F"])),
        "R": (jax_convert.convert_netR(init.netR.state_dict(),
                                       cfg["vxm_enc"], cfg["vxm_dec"])
              if init.cfg.netR == "vxm"
              else flax_from_port(init.netR, shapes["R"]))}
    if init.netD is not None:
        params["D"] = jax_netD_tree(init.netD)
    params = jax.tree.map(lambda x: np.array(x, dtype=np.float32), params)
    assert jax.tree.structure(params) == jax.tree.structure(
        jax.tree.map(lambda s: 0, shapes))
    return params


def make_case3d(name):
    """Case ``name``: the JAX step and register of the port's initial
    weights (flow head times its gain), and what the checks read
    (``test_torch_zoo_train.py``'s case dict)."""
    cfg = dict(CFG3D, **CASES3D[name])
    jm = jax_model(cfg)
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    with shallow_unet(cfg):
        init = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        init.netR.flow.weight.mul_(FLOW_GAINS.get(name, FLOW_GAIN))
    params = jax_params(cfg, init, shapes)
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, S, S, S, 1))).astype(
        np.float32) for _ in range(2))
    A, B = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        with shallow_unet(cfg):
            tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
        load_jax_params(tm, params)
        return tm

    tm = port_model()
    ids = jax_patch_ids3d(KEY, tap_locations3d(tm, A), cfg["num_patches"])
    jp = jax.tree.map(jnp.asarray, params)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    gfr = {k: jp[k] for k in "GFR"}
    register = [np.asarray(o) for o in jm.register(gfr, ja, jb)]
    if jm.netD is None:
        opt_state = jm.tx.init(jp)
    else:
        opt_state = (jm.tx.init(gfr), jm.tx_d.init(jp["D"]))
    # the step donates its state: register first
    new_state, jmetrics = jm.train_step(
        TrainState(params=jp, opt_state=opt_state,
                   step=jnp.zeros((), jnp.int32)), ja, jb, KEY,
        jnp.float32(LR))
    mu = (new_state.opt_state.mu if jm.netD is None else
          dict(new_state.opt_state[0].mu, D=new_state.opt_state[1].mu))
    grads = jax.tree.map(lambda m: 2.0 * np.asarray(m), dict(mu))
    return dict(name=name, cfg=cfg, A=A, B=B, ids=ids,
                metric_floor=METRIC_FLOOR.get(name, 1e-7),
                port_model=port_model, grads=port_tree(tm, grads),
                new=port_tree(tm, jax.tree.map(np.asarray,
                                               new_state.params)),
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                register=register)


def check_register(case):
    out = case["port_model"]().register(case["A"], case["B"])
    assert 0.5 < float(out[3].abs().max()) < 5.0      # the warps deform
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          case["register"]):
        assert tuple(o.shape) == (2, r.shape[-1], S, S, S), name
        err = float(np.abs(to_nhwc(o) - r).max())
        assert err <= REGISTER_TOL, (name, err)


def check_launches(case, counts):
    """A register call 1 vecint3d_fwd + 1 B3; a train step (the D phase
    launching no warp) the 3-D joint step's 1 + 2 forward and 1 + 2 B4
    + 1 B5 backward; counted with the plain kernels."""
    tm = case["port_model"]()
    tm.register(case["A"], case["B"])
    assert counts == dict(counts, **REGISTER3D)
    assert sum(counts.values()) == 2
    for k in counts:
        counts[k] = 0
    m = tm.train_step(case["A"], case["B"], LR, patch_ids=case["ids"])
    assert counts == dict(counts, **STEP3D)
    assert sum(counts.values()) == sum(STEP3D.values())
    assert close_metric(m["total"], case["jmetrics"]["total"],
                        case["metric_floor"])


@pytest.fixture(scope="module")
def case():
    return make_case3d("heads")


def test_register_matches_jax(case):
    check_register(case)


def test_loss_fn_matches_jax(case):
    tm = case["port_model"]()
    with torch.no_grad():
        feats = tm.netG(case["A"], layers=tm.cfg.nce_layers,
                        encode_only=True)
        rows = tm._F(feats, None)[0]
    # global_pool: one row of W * C a volume
    assert [tuple(r.shape) for r in rows] == [
        (2, f.shape[1] * f.shape[4]) for f in feats]
    check_loss_fn(case)


def test_train_step_matches_jax(case):
    check_train_step(case)


def test_launches_3d_zoo(case, counted_kernels):
    check_launches(case, counted_kernels)
