"""The zoo's networks at rank 5 (``ndims=3``) against their JAX
counterparts: the same numpy volumes (from a seed) through the flax module
and the port's module, with random weights in the flax init's shapes
(``test_torch_zoo_nets.py::random_params``) carried over by the bridge
(``compat/convert.py``: ``state_from_flax``, ``netD_state_from_jax``).

- ``UnetGenerator(num_downs=4)`` at 16^3: output, taps and
  ``encode_only``; dropout statistics at ``num_downs=6`` (the middle
  levels that carry dropout start at level 4);
- ``PoolingF``: JAX pools D and H only, so a volume gives one row of
  W * C in (W, C) order (the engine's ``reshape(B, -1)``);
- ``StridedConvF``: its specs from the taps' D (the engine's), the EMA's
  3-D shape, rows in JAX's order (every location, channels last);
- ``NLayerDiscriminator`` with 2 layers at 16^3 and 3 (``basic``) at 32^3
  (at 16^3 three layers leave an empty map), ``PixelDiscriminator`` at
  16^3;
- ``vxm_dual`` (``fuse="none"``) at 16^3, forward and ``register``.

Bars: forwards 1e-5 max-abs, relative to the output's largest magnitude
where it exceeds 1 (``close``); the gradients of a scalar (the outputs
against fixed random weights) 1e-5 of the network's max |g|; vxm_dual's
warped outputs and field 1e-3 (the end-to-end bar); the 5-D bridge exact:
DHWIO kernels to OIDHW, transposed kernels (D, H, W, in, out) to
(in, out, D, H, W), each round trip bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.nets import feature_nets as jfeat
from dfmir_tpu.nets import transfusion as jtf
from dfmir_tpu.nets.factory import define_D as jdefine_D
from dfmir_tpu.nets.unet_gen import UnetGenerator as JUnet
from dfmir_tpu_torch.compat.convert import (load_strict, netD_state_from_jax,
                                            state_from_flax, to_nhwc)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.nets import factory, feature_nets, transfusion
from dfmir_tpu_torch.nets.resnet_gen import Dropout
from dfmir_tpu_torch.nets.unet_gen import UnetGenerator
from test_torch_dropout import keep_bound
from test_torch_zoo_nets import close, gen, nhwc, random_params, t
from test_torch_zoo_train import flax_from_port
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

GRAD_TOL = 1e-5


def weights_like(outs, seed):
    """Fixed random NDHWC weights, one array an output."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]


def check_grads(jfn, params, port, pfn, ws, sd_fn):
    """The gradients of sum_i <out_i, w_i> with respect to the weights:
    JAX's (``jfn(params)`` -> list of NDHWC outputs) through ``sd_fn``
    into the port's layout, against the port's autograd of ``pfn()``
    (list of NCDHW outputs), within GRAD_TOL of the max |g|."""
    def loss(p):
        return sum(jnp.sum(o * w) for o, w in zip(jfn(p), ws))

    jg = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    ref = sd_fn(jg)
    port.zero_grad(set_to_none=True)
    total = sum((o * torch.from_numpy(np.moveaxis(w, -1, 1).copy())).sum()
                for o, w in zip(pfn(), ws))
    total.backward()
    got = dict(port.named_parameters())
    assert set(ref) == set(got)
    scale = max(float(g.abs().max()) for g in ref.values())
    assert scale > 0
    for k, p in got.items():
        err = float((p.grad - ref[k]).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def check_bridge(port, params, sd_fn):
    """The 5-D bridge exact: the JAX tree into the port's layout and back
    (``flax_from_port`` inverts the layout maps) bit for bit, every conv
    kernel 5-D."""
    sd = sd_fn(params)
    kernels = [k for k, v in sd.items() if v.ndim == 5]
    assert kernels and all(sd[k].shape == dict(port.named_parameters())[
        k].shape for k in sd)
    back = flax_from_port(port, params)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), back,
                 params)


# ------------------------------------------------------------------ unet

@pytest.fixture(scope="module")
def unet():
    x = np.tanh(nhwc(np.random.default_rng(30), 2, 16, 16, 16, 1))
    j = JUnet(num_downs=4, ngf=4)
    p = UnetGenerator(num_downs=4, ngf=4, ndims=3, generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_params(shapes["params"], seed=1)
    load_strict(p, state_from_flax(p, params))
    return x, j, p, params


def test_unet3d_forward_taps_encode(unet):
    x, j, p, params = unet
    layers = (0, 1, 2, 3)
    out, feats = jax.jit(lambda v, a: j.apply(v, a, layers=layers,
                                              train=False))(
        {"params": params}, jnp.asarray(x))
    with torch.no_grad():
        pout, pfeats = p(t(x), layers=layers)
        enc = p(t(x), layers=(0, 2), encode_only=True)
    assert tuple(pout.shape) == (2, 1, 16, 16, 16)
    close(to_nhwc(pout), out)
    assert [tuple(f.shape[2:]) for f in pfeats] == [(8,) * 3, (4,) * 3,
                                                   (2,) * 3, (1,) * 3]
    for f, r in zip(pfeats, feats):
        close(to_nhwc(f), r)
    assert len(enc) == 2
    assert torch.equal(enc[0], pfeats[0]) and torch.equal(enc[1], pfeats[2])


def test_unet3d_gradients_and_bridge(unet):
    x, j, p, params = unet
    layers = (0, 2)

    def jfn(pr):
        out, feats = j.apply({"params": pr}, jnp.asarray(x), layers=layers,
                             train=False)
        return [out] + list(feats)

    def pfn():
        out, feats = p(t(x), layers=layers)
        return [out] + list(feats)

    def sd_fn(tree):
        return state_from_flax(p, tree)

    ws = weights_like(jfn(params), 2)
    check_grads(jfn, params, p, pfn, ws, sd_fn)
    check_bridge(p, params, sd_fn)
    # the transposed conv's kernel: (D, H, W, in, out) -> (in, out, D, H, W)
    w = state_from_flax(p, params)["up_1.weight"]
    np.testing.assert_array_equal(
        w.numpy(), np.transpose(params["up_1"]["kernel"], (3, 4, 0, 1, 2)))
    assert isinstance(p.up_1, torch.nn.ConvTranspose3d)


def test_unet3d_dropout_statistics():
    """num_downs 6 at 64^3: the dropout levels 4 (of 0..5); keep rate 0.5
    within 5 binomial sigmas, one seed the same masks, another others,
    train=False none."""
    p = UnetGenerator(num_downs=6, ngf=2, use_dropout=True, ndims=3,
                      generator=gen())
    x = torch.tanh(torch.randn(2, 1, 64, 64, 64, generator=gen(3)))
    masks = []

    def hook(module, args, out):
        masks.append(out[args[0] != 0] != 0)

    handle = p.dropout.register_forward_hook(hook)
    with torch.no_grad():
        plain = p(x)
        a = p(x, train=True, generator=gen(4))
        b = p(x, train=True, generator=gen(4))
        c = p(x, train=True, generator=gen(5))
    handle.remove()
    assert isinstance(p.dropout, Dropout) and len(masks) == 3
    n = masks[0].numel()
    assert abs(float(masks[0].float().mean()) - 0.5) <= keep_bound(n)
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0],
                                                               masks[2])
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert not torch.equal(a, c)


# ---------------------------------------------------------- feature nets

def test_pooling_head_3d():
    """JAX's max over axes (1, 2) of (B, D, H, W, C): D and H pooled, W
    kept; one row of W * C a volume, in (W, C) order."""
    x = nhwc(np.random.default_rng(31), 2, 4, 5, 6, 3)
    want = np.asarray(jfeat.PoolingF().apply({}, jnp.asarray(x)))
    assert want.shape == (2, 1, 1, 6, 3)
    got = feature_nets.PoolingF()(t(x))
    assert tuple(got.shape) == (2, 18)
    close(got, want.reshape(2, -1))
    # row b, block w: the L2-normalised max over D and H of x[b, :, :, w]
    h = x.max(axis=(1, 2))
    h = h / (np.sqrt((h ** 2).sum(-1, keepdims=True)) + 1e-7)
    close(got, h.reshape(2, -1))


@pytest.fixture(scope="module")
def strided():
    """StridedConvF over two taps of a 3-D model: specs from the port's
    engine (against JAX's), weights and EMA from JAX's init shapes."""
    rng = np.random.default_rng(32)
    feats = [nhwc(rng, 2, 64, 64, 64, 4), nhwc(rng, 2, 32, 32, 32, 8)]
    specs = [(4, 64), (8, 32)]
    j = jfeat.StridedConvF(specs=specs)
    p = feature_nets.StridedConvF(specs, ndims=3, generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    params = random_params(shapes["params"], seed=3)
    sd = state_from_flax(p, params)
    sd.update({k: torch.zeros_like(b) for k, b in p.named_buffers()})
    load_strict(p, sd)
    stats = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         shapes["stats"])
    return feats, j, p, params, stats


def test_strided_conv_head_3d(strided):
    feats, j, p, params, stats = strided
    assert p.n_down == [1, 0]
    assert [tuple(getattr(p, f"ema_{i}").shape) for i in range(2)] == [
        (64, 29, 29, 29), (64, 30, 30, 30)]
    assert [tuple(np.moveaxis(np.zeros(getattr(p, f"ema_{i}").shape), 0,
                              -1).shape) for i in range(2)] == [
        tuple(stats[f"ema_{i}"].shape) for i in range(2)]
    want = jax.jit(lambda v, f: j.apply(v, f, update_ema=False))(
        {"params": params, "stats": stats}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = p([t(f) for f in feats])
    for g, w in zip(got, want):
        close(to_nhwc(g), w)
        # the engine's rows: every location, channels last (JAX's reshape)
        rows = feature_nets.channels_last_rows(g)
        close(rows, np.asarray(w).reshape(-1, 64))


def test_strided_conv_gradients_and_bridge(strided):
    feats, j, p, params, stats = strided

    def jfn(pr):
        return j.apply({"params": pr, "stats": stats},
                       [jnp.asarray(f) for f in feats], update_ema=False)

    def sd_fn(tree):
        return state_from_flax(p, tree)

    ws = weights_like(jfn(params), 4)
    check_grads(jfn, params, p, lambda: p([t(f) for f in feats]), ws, sd_fn)
    check_bridge(p, params, sd_fn)


def test_strided_specs_from_depth():
    """The engine's StridedConvF specs are (C, D) of each tap, as JAX's
    ``(s.shape[-1], s.shape[1])`` of its NDHWC taps, and the EMA is 3-D."""
    cfg = dict(ndims=3, crop_size=16, ngf=4, netG="unet_128",
               nce_layers=(0, 2), netF="strided_conv",
               vxm_enc=(4, 4, 4, 4), vxm_dec=(4, 4, 4, 4, 4, 4, 4))
    jm = JaxModel(JaxConfig(**dict(cfg, crop_size=128)))
    want = [(int(s.shape[-1]), int(s.shape[1])) for s in jm._tap_shapes()]
    tm = RegistrationModel(RegistrationConfig(**dict(cfg, crop_size=128)),
                           device="cpu")
    assert tm.netF.specs == want == [(4, 64), (16, 16)]
    assert tuple(tm.netF.ema_0.shape) == (64, 29, 29, 29)
    assert tuple(tm.netF.ema_1.shape) == (64, 14, 14, 14)
    assert tm.netF.conv_0_0.weight.ndim == 5


# ------------------------------------------------------- discriminators

@pytest.mark.parametrize("netD,n_layers,side", [("n_layers", 2, 16),
                                                ("basic", 3, 32),
                                                ("pixel", 3, 16)])
def test_discriminators_3d(netD, n_layers, side):
    x = np.tanh(nhwc(np.random.default_rng(33), 2, side, side, side, 1))
    j = jdefine_D(input_nc=1, ndf=4, netD=netD, n_layers_D=n_layers)
    p = factory.define_D(1, 4, netD, n_layers_D=n_layers, ndims=3,
                         generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_params(shapes["params"], seed=5)

    def sd_fn(tree):
        return netD_state_from_jax(tree, p)

    load_strict(p, sd_fn(params))
    want = jax.jit(j.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = p(t(x))
    assert got.ndim == 5 and got.numel() > 0
    if netD != "pixel":
        assert tuple(got.shape) == (2, 1, 2, 2, 2)
    close(to_nhwc(got), want)
    ws = weights_like([want], 6)
    check_grads(lambda pr: [j.apply({"params": pr}, jnp.asarray(x))],
                params, p, lambda: [p(t(x))], ws, sd_fn)
    # the 5-D bridge: JAX's conv_<k> is the k-th conv, DHWIO -> OIDHW
    convs = [m for m in p.modules() if isinstance(m, torch.nn.Conv3d)]
    assert len(convs) == len(params)
    for k, m in enumerate(convs):
        jp = params[f"conv_{k}"]["Conv_0"]
        np.testing.assert_array_equal(
            m.weight.detach().numpy(),
            np.transpose(jp["kernel"], (4, 3, 0, 1, 2)))
        np.testing.assert_array_equal(m.bias.detach().numpy(), jp["bias"])


# -------------------------------------------------------------- vxm_dual

ENC3, DEC3 = (4, 4, 4, 4), (4, 4, 4, 4, 4, 4, 4)


@pytest.fixture(scope="module")
def vxm_dual():
    rng = np.random.default_rng(34)
    x, y = (np.tanh(2 * nhwc(rng, 2, 16, 16, 16, 1)) for _ in range(2))
    j = jtf.VxmDenseTransformer(ndims=3, nb_features=(ENC3, DEC3),
                                int_steps=2, fuse="none")
    p = transfusion.VxmDenseDual(ndims=3, nb_features=(ENC3, DEC3),
                                 int_steps=2, generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(y))
    params = random_params(shapes["params"], seed=7)
    params["flow"]["kernel"] *= 3.0      # displacements of a few voxels
    load_strict(p, state_from_flax(p, params))
    return x, y, j, p, params


def test_vxm_dual_3d_forward_and_register(vxm_dual):
    x, y, j, p, params = vxm_dual
    v = {"params": params}
    want = jax.jit(j.apply)(v, jnp.asarray(x), jnp.asarray(y))
    reg = jax.jit(lambda v, a, b: j.apply(v, a, b, registration=True))(
        v, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = p(t(x), t(y))
        got_reg = p(t(x), t(y), registration=True)
    assert float(np.abs(np.asarray(want[2])).max()) > 0.5   # it deforms
    assert tuple(got[2].shape) == (2, 3, 16, 16, 16)
    for g, w in zip(got, want):
        close(to_nhwc(g), w, 1e-3)
    assert len(got_reg) == 2
    for g, w in zip(got_reg, reg):
        close(to_nhwc(g), w, 1e-3)
    assert isinstance(p.flow, torch.nn.Conv3d)


def test_vxm_dual_3d_gradients_and_bridge(vxm_dual):
    """The dual-encoder UNet and the 3-D flow head: the gradients of the
    pre-integration field (the unidirectional module's second output, the
    flow head's field at half resolution) at 1e-5 of the max |g|; the
    bridge exact."""
    x, y, _, p, params = vxm_dual
    kw = dict(ndims=3, nb_features=(ENC3, DEC3), int_steps=2, bidir=False)
    j = jtf.VxmDenseTransformer(fuse="none", **kw)
    uni = transfusion.VxmDenseDual(generator=gen(), **kw)
    load_strict(uni, state_from_flax(uni, params))

    def jfn(pr):
        return [j.apply({"params": pr}, jnp.asarray(x), jnp.asarray(y))[1]]

    def sd_fn(tree):
        return state_from_flax(uni, tree)

    ws = weights_like(jfn(params), 8)
    check_grads(jfn, params, uni, lambda: [uni(t(x), t(y))[1]], ws, sd_fn)
    check_bridge(p, params, lambda tree: state_from_flax(p, tree))
    np.testing.assert_array_equal(
        p.flow.weight.detach().numpy(),
        np.transpose(params["flow"]["kernel"], (4, 3, 0, 1, 2)))
