"""The network zoo's modules against their JAX counterparts: the same numpy
inputs (from a seed) through the flax module and the port's module, with
the flax init's weights carried over by ``compat/convert.py``'s
``state_from_flax``.

Bar: forwards agree to 1e-5 max-abs, relative to the output's largest
magnitude where it exceeds 1 (``close``); the whole transformer netR
(flow head, integration, warps) to 1e-4 of it; the numpy models of
upfirdn2d and of the per-sample-weight modulated conv to 1e-4, as the
JAX suite holds its own (``tests/test_stylegan2.py``).  Weights are drawn
from a seed in the shapes of the flax init (``random_params``), so no
bias or scale is zero.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.nets import feature_nets as jfeat
from dfmir_tpu.nets import munit as jmunit
from dfmir_tpu.nets import stylegan2 as jsg
from dfmir_tpu.nets import transfusion as jtf
from dfmir_tpu.nets.factory import define_D as jdefine_D
from dfmir_tpu.nets.factory import define_F as jdefine_F
from dfmir_tpu.nets.factory import define_G as jdefine_G
from dfmir_tpu.nets.unet_gen import UnetGenerator as JUnet
from dfmir_tpu_torch.compat.convert import (load_strict, state_from_flax,
                                            to_nchw, to_nhwc)
from dfmir_tpu_torch.nets import factory, feature_nets, munit, stylegan2, \
    transfusion
from dfmir_tpu_torch.nets.unet_gen import UnetGenerator
from test_stylegan2 import upfirdn2d_numpy
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def close(got, want, tol=TOL):
    """max |got - want| <= tol * max(1, max |want|); NCHW vs NHWC arrays
    are compared in the layout of ``want``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, (got.shape, want.shape)
    assert err <= tol * scale, (err, scale)


def nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(x_nhwc):
    return torch.from_numpy(to_nchw(x_nhwc))


def random_params(shapes, seed=0):
    """A flax param tree of the shapes of ``shapes`` (``jax.eval_shape`` of
    the module's init), drawn from a seed: kernels N(0, 1/fan_in),
    StyleGAN2's equalised weights N(0, 1), biases, scales and embeddings
    around their init values, so no term is zero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            std = 1.0 / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name in ("weight", "const_input"):
            std = 1.0
        else:
            std = 0.1
        x = rng.standard_normal(shape) * std
        if name == "scale":
            x += 1.0
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def carry(jmod, port, *args, **kw):
    """Random params of ``jmod``'s shapes on ``args``, loaded into
    ``port``; returns (params, variables)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args, **kw)
    params = random_params(shapes["params"])
    load_strict(port, state_from_flax(port, params))
    return params, {"params": params}


def japply(jmod, variables, *args, **kw):
    """``jmod.apply`` jitted (static keywords)."""
    return jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(variables, *args)


# ------------------------------------------------------------- stylegan2

@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)),
                                         (1, 2, (2, 2)), (2, 2, (1, 1))])
def test_upfirdn2d(up, down, pad):
    rng = np.random.default_rng(0)
    x = nhwc(rng, 2, 8, 8, 3)
    k = jsg.make_kernel([1, 3, 3, 1])
    got = stylegan2.upfirdn2d(t(x), stylegan2.make_kernel([1, 3, 3, 1]),
                              up, down, pad)
    close(to_nhwc(got), jsg.upfirdn2d(jnp.asarray(x), k, up, down, pad))
    for c in range(3):
        np.testing.assert_allclose(
            got[1, c].numpy(), upfirdn2d_numpy(x[1, :, :, c], k, up, down,
                                               pad), atol=1e-4)


def test_elementwise_helpers():
    rng = np.random.default_rng(1)
    x, b = nhwc(rng, 2, 4, 4, 5), nhwc(rng, 5)
    close(to_nhwc(stylegan2.fused_leaky_relu(t(x), torch.from_numpy(b))),
          jsg.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    z = nhwc(rng, 3, 16)
    close(stylegan2.pixel_norm(torch.from_numpy(z)),
          jsg.pixel_norm(jnp.asarray(z)))
    for args in [(4, 2, 3, True), (4, 2, 3, False), (4, 2, 1, False)]:
        assert stylegan2.blur_pad(*args) == jsg.blur_pad(*args)


@pytest.mark.parametrize("lr_mul,activation", [(1.0, None),
                                               (0.01, "fused_lrelu")])
def test_equal_linear(lr_mul, activation):
    x = nhwc(np.random.default_rng(2), 3, 12)
    j = jsg.EqualLinear(7, bias_init=0.5, lr_mul=lr_mul,
                        activation=activation)
    p = stylegan2.EqualLinear(12, 7, bias_init=0.5, lr_mul=lr_mul,
                              activation=activation, generator=gen())
    _, v = carry(j, p, jnp.asarray(x))
    close(p(torch.from_numpy(x)), j.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [dict(), dict(downsample=True),
                                dict(kernel=1, use_bias=False,
                                     activate=False)])
def test_conv_layer(kw):
    x = nhwc(np.random.default_rng(3), 2, 16, 16, 4)
    kernel = kw.pop("kernel", 3)
    j = jsg.ConvLayer(6, kernel, **kw)
    p = stylegan2.ConvLayer(4, 6, kernel, **kw, generator=gen())
    _, v = carry(j, p, jnp.asarray(x))
    close(to_nhwc(p(t(x))), j.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [dict(), dict(upsample=True),
                                dict(downsample=True),
                                dict(demodulate=False, kernel=1)])
def test_modulated_conv(kw):
    rng = np.random.default_rng(4)
    x, s = nhwc(rng, 2, 8, 8, 4), nhwc(rng, 2, 8)
    kernel = kw.pop("kernel", 3)
    j = jsg.ModulatedConv(6, kernel, style_dim=8, **kw)
    p = stylegan2.ModulatedConv(4, 6, kernel, style_dim=8, **kw,
                                generator=gen())
    _, v = carry(j, p, jnp.asarray(x), jnp.asarray(s))
    close(to_nhwc(p(t(x), torch.from_numpy(s))),
          j.apply(v, jnp.asarray(x), jnp.asarray(s)))


def test_modulated_conv_is_the_per_sample_weight_conv():
    """Scaling the input by the style and demodulating the output equals
    the reference's per-sample weights (stylegan_networks.py:304-315)."""
    rng = np.random.default_rng(5)
    B, C, O, k = 2, 4, 6, 3
    x, s_in = nhwc(rng, B, C, 8, 8), nhwc(rng, B, 8)
    p = stylegan2.ModulatedConv(C, O, k, style_dim=8, generator=gen(1))
    with torch.no_grad():
        got = p(torch.from_numpy(x), torch.from_numpy(s_in)).numpy()
        s = p.modulation(torch.from_numpy(s_in)).numpy()
    w = p.weight.detach().numpy() * p.scale                  # (O, C, k, k)
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros_like(got)
    for b in range(B):
        wb = w * s[b][None, :, None, None]
        wb = wb / np.sqrt((wb ** 2).sum(axis=(1, 2, 3)) + 1e-8)[:, None,
                                                                  None, None]
        for i in range(8):
            for j in range(8):
                want[b, :, i, j] = np.einsum(
                    "chw,ochw->o", xp[b, :, i:i + k, j:j + k], wb)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_noise_injection_and_styled_conv():
    rng = np.random.default_rng(6)
    x, noise = nhwc(rng, 2, 8, 8, 4), nhwc(rng, 2, 8, 8, 1)
    j = jsg.NoiseInjection()
    p = stylegan2.NoiseInjection()
    v = j.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(noise))
    v = {"params": {"weight": jnp.asarray([0.3], jnp.float32)}}
    with torch.no_grad():
        p.weight.fill_(0.3)
    close(to_nhwc(p(t(x), t(noise))),
          j.apply(v, jnp.asarray(x), jnp.asarray(noise)))
    # without noise (JAX's engine passes no noise rng) nothing is added
    assert torch.equal(p(t(x)), t(x))
    js = jsg.StyledConv(6, 3, upsample=True)
    ps = stylegan2.StyledConv(4, 6, 3, upsample=True, generator=gen())
    _, v = carry(js, ps, jnp.asarray(x))
    close(to_nhwc(ps(t(x))), js.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("small", [False, True])
def test_stylegan2_generator(small):
    x = np.tanh(nhwc(np.random.default_rng(7), 2, 32, 32, 1))
    kw = dict(ngf=8, n_blocks=8 if small else 9, size=32, small=small)
    j = jsg.StyleGAN2Generator(**kw)
    p = stylegan2.StyleGAN2Generator(1, 1, **kw, generator=gen())
    _, v = carry(j, p, jnp.asarray(x))
    out, feats = japply(j, v, jnp.asarray(x), layers=(1, 2, 3))
    with torch.no_grad():
        pout, pfeats = p(t(x), layers=(1, 2, 3))
        enc = p(t(x), layers=(1, 2, 3), encode_only=True)
    close(to_nhwc(pout), out)
    assert len(pfeats) == len(feats) == len(enc) == 3
    for f, r, e in zip(pfeats, feats, enc):
        close(to_nhwc(f), r)
        assert torch.equal(f, e)


@pytest.mark.parametrize("netD", ["stylegan2", "patchstylegan2",
                                  "smallpatchstylegan2", "tilestylegan2"])
def test_stylegan2_discriminators(netD):
    """At the JAX engine's construction: size 256 (and tiles of 64)
    whatever the crop; the port sizes linear_0 from the crop (64)."""
    x = np.tanh(nhwc(np.random.default_rng(8), 2, 64, 64, 1))
    j = jdefine_D(input_nc=1, ndf=8, netD=netD)
    p = factory.define_D(1, 8, netD, in_size=64, generator=gen())
    _, v = carry(j, p, jnp.asarray(x))
    want = japply(j, v, jnp.asarray(x))
    got = p(t(x))
    close(to_nhwc(got) if got.ndim == 4 else got, want)


def test_mapping_and_synthesis_generator():
    rng = np.random.default_rng(9)
    z = nhwc(rng, 2, 16)
    j = jsg.StyleGAN2SynthesisGenerator(size=16, style_dim=16, ngf=4,
                                        out_channels=3)
    p = stylegan2.StyleGAN2SynthesisGenerator(16, 16, 4, 3, generator=gen())
    _, v = carry(j, p, jnp.asarray(z))
    close(to_nhwc(p(torch.from_numpy(z))), japply(j, v, jnp.asarray(z)))


# ---------------------------------------------------------- feature nets

@pytest.mark.parametrize("H,out", [(8, 4), (6, 4), (4, 8), (5, 3)])
def test_adaptive_pool_bins(H, out):
    x = nhwc(np.random.default_rng(10), 2, H, H + 1, 3)
    for red, jred in (("mean", jnp.mean), ("max", jnp.max)):
        close(to_nhwc(feature_nets.adaptive_pool(t(x), out, red)),
              jfeat._adaptive_pool(jnp.asarray(x), out, jred))
    close(to_nhwc(transfusion.adaptive_avg_pool(t(x[:, :, :H]), out)),
          jtf._adaptive_avg_pool(jnp.asarray(x[:, :, :H]), out))


@pytest.mark.parametrize("H", [8, 6])
def test_pooling_and_reshape_heads(H):
    x = nhwc(np.random.default_rng(11), 2, H, H, 5)
    close(feature_nets.PoolingF()(t(x)),
          np.asarray(jfeat.PoolingF().apply({}, jnp.asarray(x))).reshape(2, -1))
    close(feature_nets.ReshapeF()(t(x)),
          jfeat.ReshapeF().apply({}, jnp.asarray(x)))


def _strided(rng):
    feats = [nhwc(rng, 2, 64, 64, 8), nhwc(rng, 2, 32, 32, 16)]
    specs = [(8, 64), (16, 32)]
    j = jfeat.StridedConvF(specs=specs)
    p = feature_nets.StridedConvF(specs, generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0),
                            [jnp.asarray(f) for f in feats])
    params = random_params(shapes["params"])
    sd = state_from_flax(p, params)
    sd.update({k: torch.zeros_like(b) for k, b in p.named_buffers()})
    load_strict(p, sd)
    stats = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                         shapes["stats"])
    return feats, j, p, {"params": params, "stats": stats}


@pytest.mark.parametrize("instance_norm", [False, True])
def test_strided_conv_head(instance_norm):
    feats, j, p, v = _strided(np.random.default_rng(12))
    want = j.apply(v, [jnp.asarray(f) for f in feats],
                   use_instance_norm=instance_norm, update_ema=False)
    got = p([t(f) for f in feats], use_instance_norm=instance_norm)
    assert [g.shape[1:] for g in got] == [(64, 29, 29), (64, 30, 30)]
    for g, w in zip(got, want):
        close(to_nhwc(g), w)


def test_strided_conv_ema_update():
    """update_ema=True: JAX's stats collection after two updates, and the
    outputs that subtract the moved EMA."""
    feats, j, p, v = _strided(np.random.default_rng(13))
    jf = [jnp.asarray(f) for f in feats]
    for _ in range(2):
        want, upd = j.apply(v, jf, mutable=["stats"])
        v = dict(v, stats=upd["stats"])
        got = p([t(f) for f in feats], update_ema=True)
    for i, (g, w) in enumerate(zip(got, want)):
        close(to_nhwc(g), w)
        ema = np.asarray(v["stats"][f"ema_{i}"])
        assert float(np.abs(ema).max()) > 0
        close(getattr(p, f"ema_{i}").permute(1, 2, 0), ema)


# ----------------------------------------------------------- transfusion

@pytest.mark.parametrize("n_in,n_out", [(8, 4), (8, 3), (8, 32), (8, 12)])
def test_antialiased_token_resize(n_in, n_out):
    """jax.image.resize(bilinear): antialiased when it shrinks (8 -> 4 is
    the last level at crop 256, below ``anchors``)."""
    x = nhwc(np.random.default_rng(14), 2, n_in, n_in, 3)
    close(to_nhwc(transfusion.bilinear_resize(t(x), n_out, n_out)),
          jtf._bilinear_resize(jnp.asarray(x), n_out, n_out))


def test_attention_and_transformer_block():
    rng = np.random.default_rng(15)
    tok = nhwc(rng, 2, 10, 8) * 2 + 0.5
    j = jtf.TransformerBlock(n_head=4)
    p = transfusion.TransformerBlock(8, 4, generator=gen())
    params, v = carry(j, p, jnp.asarray(tok))
    close(p(torch.from_numpy(tok)), j.apply(v, jnp.asarray(tok)))
    assert set(params) == {"LayerNorm_0", "LayerNorm_1", "Dense_0",
                           "Dense_1", "MultiHeadDotProductAttention_0"}
    assert p.LayerNorm_0.eps == 1e-6


@pytest.mark.parametrize("kind", ["gpt", "cross"])
def test_fusion_modules(kind):
    rng = np.random.default_rng(16)
    ta, tb = nhwc(rng, 2, 4, 4, 8), nhwc(rng, 2, 4, 4, 8)
    if kind == "gpt":
        j = jtf.GPTFusion(n_head=2, n_layer=2, anchors=4)
        p = transfusion.GPTFusion(8, 2, 2, anchors=4, generator=gen())
    else:
        j = jtf.CrossAttentionFusion(n_head=2)
        p = transfusion.CrossAttentionFusion(8, 2, generator=gen())
    _, v = carry(j, p, jnp.asarray(ta), jnp.asarray(tb))
    want = j.apply(v, jnp.asarray(ta), jnp.asarray(tb))
    got = p(t(ta), t(tb))
    for g, w in zip(got, want):
        close(to_nhwc(g), w)


ENC, DEC = (8, 16, 16, 16), (16, 16, 16, 16, 16, 8, 8)


@pytest.mark.parametrize("fuse", ["gpt", "bottleneck", "cross", "none"])
def test_transfusion_unet(fuse):
    """At 64^2 the levels are 32..4: the last pools 4 -> 8 (the general
    bins) and resizes 8 -> 4 (antialiased)."""
    rng = np.random.default_rng(17)
    x, y = nhwc(rng, 2, 64, 64, 1), nhwc(rng, 2, 64, 64, 1)
    j = jtf.TransFusionUnet(ENC, DEC, n_head=4, n_layer=1, fuse=fuse)
    p = transfusion.TransFusionUnet(ENC, DEC, 4, 1, fuse=fuse,
                                    generator=gen())
    _, v = carry(j, p, jnp.asarray(x), jnp.asarray(y))
    close(to_nhwc(p(t(x), t(y))), japply(j, v, jnp.asarray(x),
                                        jnp.asarray(y)))


@pytest.fixture(scope="module")
def vxm_transformer():
    rng = np.random.default_rng(18)
    x, y = (np.tanh(2 * nhwc(rng, 2, 64, 64, 1)) for _ in range(2))
    # 2 integration steps: a cheaper JAX compile, the same code
    j = jtf.VxmDenseTransformer(nb_features=(ENC, DEC), n_layer=1,
                                int_steps=2)
    p = transfusion.VxmDenseTransformer(nb_features=(ENC, DEC), n_layer=1,
                                        int_steps=2, generator=gen())
    shapes = jax.eval_shape(j.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(y))
    params = random_params(shapes["params"])
    params["flow"]["kernel"] *= 3.0     # displacements of a few pixels
    load_strict(p, state_from_flax(p, params))
    return x, y, j, p, {"params": params}


def test_vxm_transformer_forward(vxm_transformer):
    x, y, j, p, v = vxm_transformer
    want = japply(j, v, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = p(t(x), t(y))
    assert float(np.abs(np.asarray(want[2])).max()) > 0.5  # it deforms
    for g, w in zip(got, want):
        close(to_nhwc(g), w, 1e-4)


def test_vxm_transformer_register(vxm_transformer):
    x, y, j, p, v = vxm_transformer
    want = japply(j, v, jnp.asarray(x), jnp.asarray(y), registration=True)
    with torch.no_grad():
        got = p(t(x), t(y), registration=True)
    assert len(got) == 2
    for g, w in zip(got, want):
        close(to_nhwc(g), w, 1e-4)


def test_vxm_dual_and_3d_refusal():
    p = transfusion.VxmDenseDual(nb_features=(ENC, DEC), generator=gen())
    assert p.unet.fuse == "none" and not any(p.unet.fused)
    with pytest.raises(NotImplementedError, match="four dims"):
        transfusion.VxmDenseTransformer(ndims=3, generator=gen())
    with pytest.raises(ValueError, match="fuse"):
        transfusion.TransFusionUnet(fuse="nope", generator=gen())


# ------------------------------------------------------------------ unet

@pytest.mark.parametrize("num_downs", [5, 6])
def test_unet_generator(num_downs):
    x = np.tanh(nhwc(np.random.default_rng(19), 2, 64, 64, 1))
    j = JUnet(num_downs=num_downs, ngf=4)
    p = UnetGenerator(num_downs=num_downs, ngf=4, generator=gen())
    _, v = carry(j, p, jnp.asarray(x))
    layers = tuple(range(0, num_downs, 2))
    out, feats = japply(j, v, jnp.asarray(x), layers=layers, train=False)
    with torch.no_grad():
        pout, pfeats = p(t(x), layers=layers)
        enc = p(t(x), layers=layers, encode_only=True)
    close(to_nhwc(pout), out)
    for f, r, e in zip(pfeats, feats, enc):
        close(to_nhwc(f), r)
        assert torch.equal(f, e)


def test_unet_taps_and_dropout():
    x = torch.zeros(1, 1, 64, 64)
    p = UnetGenerator(num_downs=6, ngf=4, use_dropout=True, generator=gen())
    with pytest.raises(ValueError, match="nce_layers"):
        p(x, layers=(0, 6))
    with pytest.raises(ValueError, match="nce_layers"):
        JUnet(num_downs=6, ngf=4).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 64, 64, 1)),
                                       layers=(0, 6))
    with pytest.raises(ValueError, match="generator"):
        p(x, train=True)
    x = torch.tanh(torch.randn(1, 1, 64, 64, generator=gen(3)))
    with torch.no_grad():
        plain = p(x)
        a = p(x, train=True, generator=gen(4))
        b = p(x, train=True, generator=gen(4))
        c = p(x, train=True, generator=gen(5))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert not torch.equal(a, c)
    assert torch.equal(p(x, train=False, generator=gen(4)), plain)


# ----------------------------------------------------------------- munit

def test_gresnet():
    x = np.tanh(nhwc(np.random.default_rng(20), 2, 32, 32, 1))
    j = jdefine_G(ngf=4, netG="resnet_cat")
    p = factory.define_G(ngf=4, netG="resnet_cat", generator=gen())
    params, v = carry(j, p, jnp.asarray(x))
    assert "LayerNorm_0" in params["dec"]["up_0"]
    out, feats = japply(j, v, jnp.asarray(x), layers=(0, 1, 2, 3))
    with torch.no_grad():
        pout, pfeats = p(t(x), layers=(0, 1, 2, 3))
        enc = p(t(x), layers=(0, 1, 2, 3), encode_only=True)
    close(to_nhwc(pout), out)
    for f, r, e in zip(pfeats, feats, enc):
        close(to_nhwc(f), r)
        assert torch.equal(f, e)
    with pytest.raises(ValueError, match="nce_layers"):
        p(t(x), layers=(0, 7))
    with pytest.raises(ValueError, match="nce_layers"):
        j.apply(v, jnp.asarray(x), layers=(0, 7))


def test_munit_style_paths():
    rng = np.random.default_rng(21)
    x, style = np.tanh(nhwc(rng, 2, 32, 32, 1)), nhwc(rng, 2, 3)
    j = jmunit.GResnet(nz=3, ngf=4)
    p = munit.GResnet(nz=3, ngf=4, generator=gen())
    _, v = carry(j, p, jnp.asarray(x), jnp.asarray(style))
    close(to_nhwc(p(t(x), torch.from_numpy(style))),
          japply(j, v, jnp.asarray(x), jnp.asarray(style)))
    for vae in (False, True):
        je = jmunit.E_adaIN(style_dim=3, nef=4, vae=vae)
        pe = munit.E_adaIN(3, 4, vae=vae, generator=gen())
        _, v = carry(je, pe, jnp.asarray(x))
        want = japply(je, v, jnp.asarray(x))
        got = pe(t(x))
        for g, w in zip(got if vae else [got], want if vae else [want]):
            close(g, w)


# --------------------------------------------------------------- factory

def test_factories():
    g = gen()
    assert isinstance(factory.define_G(netG="unet_128", ngf=4, generator=g),
                      UnetGenerator)
    assert factory.define_G(netG="unet_256", ngf=4,
                            generator=g).num_downs == 8
    assert isinstance(factory.define_G(netG="smallstylegan2", ngf=4, size=32,
                                       generator=g).decoder.up_0.noise,
                      type(None))
    assert isinstance(factory.define_F("global_pool", generator=g),
                      feature_nets.PoolingF)
    assert isinstance(factory.define_F("strided_conv", strided_specs=[(8, 32)],
                                       generator=g), feature_nets.StridedConvF)
    assert isinstance(factory.define_D(netD="tilestylegan2", ndf=4,
                                       generator=g),
                      stylegan2.TileStyleGAN2Discriminator)
    for fn, kw in ((factory.define_G, dict(netG="nope_9blocks")),
                   (factory.define_F, dict(netF="nope")),
                   (factory.define_D, dict(netD="nope"))):
        with pytest.raises(NotImplementedError, match="not recognized"):
            fn(**kw, generator=g)
    for fn, kw in ((jdefine_G, dict(netG="nope_9blocks")),
                   (jdefine_F, dict(netF="nope"))):
        with pytest.raises(NotImplementedError, match="not recognized"):
            fn(**kw)
    assert math.isclose(stylegan2.SQRT2, math.sqrt(2))
