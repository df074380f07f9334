"""The port's affine warps (``ops/affine.py``) and random deformation
(``ops/augment.py``) against the JAX package's, called eagerly.

- ``ops/affine``: 1e-5 max-abs.
- The random deformation: the port cannot reproduce ``jax.random``'s
  streams, so the draws (angles, scalings, translations, the SVF's noise)
  are taken here from JAX's key, split as JAX's functions split it, and
  given to the port's deterministic part (``deformation_from_draws``,
  ``deform``).  Flow and image within 1e-4 max-abs at 64^2 / 24^3 (the
  plain VecInt loop and JAX's XLA ``vecint`` differ by up to 4.6e-5 at
  512^2, ROADMAP C).  A label map warped in nearest mode is equal but
  where a sampled coordinate lies within 1e-4 of a rounding boundary; such
  pixels are at most 0.1%.
- The port's own draws are held by their ranges and statistics.
- Which path a warp takes: a float32 CUDA tensor goes to the chain kernel
  and B1 / B3, a nearest label warp or a float64 / bfloat16 input to the
  plain version (``_kernel_takes``, ``_chain_takes``), checked here with
  the tensors shown to those rules as if they lay on a card and the
  kernels' autograd functions replaced by counting spies.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops import affine as jaffine
from dfmir_tpu.ops.warp import warp as jwarp
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops import affine, augment, integrate, warp, warp_cuda
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

# dfmir_tpu.ops exports the function augment under the module's name
jaugment = importlib.import_module("dfmir_tpu.ops.augment")

TOL_AFFINE = 1e-5
TOL_FLOW = 1e-4
BOUNDARY = 1e-4
SHAPES = {2: (64, 64), 3: (24, 24, 24)}


def t(a):
    return torch.from_numpy(to_nchw(np.asarray(a)))


def smooth_image(rng, batch, spatial, channels=1):
    """A smooth random NHWC image in about [-1, 1]."""
    low = rng.standard_normal((batch,) + tuple(max(s // 8, 2)
                                               for s in spatial)
                              + (channels,)).astype(np.float32)
    from dfmir_tpu.ops.integrate import resize_linear
    return np.tanh(np.asarray(resize_linear(jnp.asarray(low), spatial)))


def label_map(rng, batch, spatial, n=4):
    """Blocky integer labels 0..n-1 as float32, NHWC."""
    img = smooth_image(rng, batch, spatial)
    return np.digitize(img, np.quantile(img, [0.25, 0.5, 0.75])).astype(
        np.float32)


def random_matrix(rng, batch, nd):
    lin = np.eye(nd, dtype=np.float32) + 0.1 * rng.standard_normal(
        (batch, nd, nd)).astype(np.float32)
    off = rng.standard_normal((batch, nd, 1)).astype(np.float32) * 2
    return np.concatenate([lin, off], axis=-1)


@pytest.mark.parametrize("nd", [2, 3])
def test_affine_grid_and_flow(rng, nd):
    spatial = SHAPES[nd]
    m = random_matrix(rng, 2, nd)
    ref = np.asarray(jaffine.affine_grid(jnp.asarray(m), spatial))
    mine = affine.affine_grid(torch.from_numpy(m), spatial)
    np.testing.assert_allclose(to_nhwc(mine), ref, rtol=0, atol=TOL_AFFINE)
    ref = np.asarray(jaffine.affine_to_flow(jnp.asarray(m), spatial))
    mine = affine.affine_to_flow(torch.from_numpy(m), spatial)
    np.testing.assert_allclose(to_nhwc(mine), ref, rtol=0, atol=TOL_AFFINE)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("nd", [2, 3])
def test_affine_warp(rng, nd, mode):
    spatial = SHAPES[nd]
    src = smooth_image(rng, 2, spatial, channels=2)
    m = random_matrix(rng, 2, nd)
    ref = np.asarray(jaffine.affine_warp(jnp.asarray(src), jnp.asarray(m),
                                         mode=mode))
    mine = affine.affine_warp(t(src), torch.from_numpy(m), mode=mode)
    np.testing.assert_allclose(to_nhwc(mine), ref, rtol=0, atol=TOL_AFFINE)


@pytest.mark.parametrize("translate", [False, True])
@pytest.mark.parametrize("nd", [2, 3])
def test_centered_affine(rng, nd, translate):
    spatial = (17, 20, 11)[:nd]
    lin = rng.standard_normal((3, nd, nd)).astype(np.float32)
    tr = rng.standard_normal((3, nd)).astype(np.float32) * 3
    ref = jaffine.centered_affine(spatial, jnp.asarray(lin),
                                  jnp.asarray(tr) if translate else None)
    mine = affine.centered_affine(spatial, torch.from_numpy(lin),
                                  torch.from_numpy(tr) if translate
                                  else None)
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL_AFFINE)


def jax_affine_draws(key, batch, spatial, max_rotation=10.0,
                     max_scaling=0.1, max_translation=5.0):
    """The draws of JAX's ``random_affine_matrix(key, ...)``: angles,
    scalings, translations, as torch tensors."""
    nd = len(spatial)
    k_rot, k_scale, k_trans = jax.random.split(key, 3)
    shapes = ((batch, 1 if nd == 2 else 3), (batch, nd), (batch, nd))
    return [torch.from_numpy(np.array(jax.random.uniform(
        k, shape, minval=-bound, maxval=bound)))
        for k, shape, bound in zip((k_rot, k_scale, k_trans), shapes,
                                   (max_rotation, max_scaling,
                                    max_translation))]


def jax_draws(key, batch, spatial, svf_scale=8, **affine_kw):
    """The draws of JAX's ``random_deformation(key, ...)``, split as it
    splits its key, as the port's ``DeformationDraws``."""
    k_aff, k_svf = jax.random.split(key)
    low = augment.svf_size(spatial, svf_scale)
    noise = jax.random.normal(k_svf, (batch,) + low + (len(spatial),))
    return augment.DeformationDraws(
        *jax_affine_draws(k_aff, batch, spatial, **affine_kw), t(noise))


KW = [dict(), dict(max_rotation=25.0, max_scaling=0.2, max_translation=8.0,
                   svf_std=2.0)]


def affine_kw(i):
    return {k: v for k, v in KW[i].items() if k != "svf_std"}


@pytest.mark.parametrize("kw", range(len(KW)))
@pytest.mark.parametrize("nd", [2, 3])
def test_random_affine_matrix(nd, kw):
    spatial = SHAPES[nd]
    key = jax.random.PRNGKey(11)
    ref = jaugment.random_affine_matrix(key, 4, spatial, **affine_kw(kw))
    mine = augment.affine_from_draws(
        spatial, *jax_affine_draws(key, 4, spatial, **affine_kw(kw)))
    np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL_AFFINE)


@pytest.mark.parametrize("nd", [2, 3])
def test_random_svf_flow(nd):
    spatial = SHAPES[nd]
    key = jax.random.PRNGKey(5)
    ref = jaugment.random_svf_flow(key, 2, spatial, svf_std=1.5)
    noise = jax.random.normal(key, (2,) + augment.svf_size(spatial)
                              + (nd,))
    mine = augment.svf_flow_from_noise(t(noise), spatial, svf_std=1.5)
    np.testing.assert_allclose(to_nhwc(mine), np.asarray(ref), rtol=0,
                               atol=TOL_FLOW)


@pytest.mark.parametrize("kw", range(len(KW)))
@pytest.mark.parametrize("nd", [2, 3])
def test_random_deformation(nd, kw):
    spatial = SHAPES[nd]
    key = jax.random.PRNGKey(7 + kw)
    ref = np.asarray(jaugment.random_deformation(key, 2, spatial, **KW[kw]))
    draws = jax_draws(key, 2, spatial, **affine_kw(kw))
    mine = augment.deformation_from_draws(
        draws, spatial, svf_std=KW[kw].get("svf_std", 1.0))
    assert np.abs(ref).max() > 2.0                    # it deforms
    np.testing.assert_allclose(to_nhwc(mine), ref, rtol=0, atol=TOL_FLOW)


def near_rounding_boundary(flow):
    """(B, *spatial) mask of the pixels whose sampled coordinate (identity
    + flow, NHWC flow) lies within BOUNDARY of a half-integer."""
    spatial = flow.shape[1:-1]
    grid = np.stack(np.meshgrid(*(np.arange(s) for s in spatial),
                                indexing="ij"), -1)
    c = grid[None] + flow
    return (np.abs(c - np.floor(c) - 0.5) < BOUNDARY).any(-1)


@pytest.mark.parametrize("nd", [2, 3])
def test_augment_image_and_labels(rng, nd):
    spatial = SHAPES[nd]
    src = smooth_image(rng, 2, spatial)
    lab = label_map(rng, 2, spatial)
    key = jax.random.PRNGKey(21)
    ref_img, ref_lab, ref_flow = (np.asarray(x) for x in jaugment.augment(
        jnp.asarray(src), key, label=jnp.asarray(lab)))
    flow = augment.deformation_from_draws(jax_draws(key, 2, spatial),
                                          spatial)
    img, lb, flow2 = augment.deform(t(src), flow, label=t(lab))
    assert flow2 is flow
    np.testing.assert_allclose(to_nhwc(flow), ref_flow, rtol=0,
                               atol=TOL_FLOW)
    np.testing.assert_allclose(to_nhwc(img), ref_img, rtol=0, atol=TOL_FLOW)
    lb = to_nhwc(lb)[..., 0]
    assert set(np.unique(lb)) <= set(np.unique(lab))
    differ = lb != ref_lab[..., 0]
    near = near_rounding_boundary(ref_flow)
    assert not (differ & ~near).any()
    assert differ.sum() <= 1e-3 * differ.size


@pytest.mark.parametrize("nd", [2, 3])
def test_own_draws_ranges_and_statistics(nd):
    spatial = (256, 256) if nd == 2 else (40, 48, 56)
    gen = torch.Generator().manual_seed(3)
    d = augment.draw_deformation(gen, 4096, spatial, max_rotation=12.0,
                                 max_scaling=0.2, max_translation=6.0)
    assert d.angles.shape == (4096, 1 if nd == 2 else 3)
    for x, bound in ((d.angles, 12.0), (d.scalings, 0.2),
                     (d.translations, 6.0)):
        assert x.dtype == torch.float32
        assert float(x.abs().max()) <= bound
        assert float(x.abs().max()) > 0.99 * bound
        # U(-b, b): mean 0 and variance b^2 / 3, within 5 sigmas
        n = x.numel()
        assert abs(float(x.mean())) < 5 * bound / (3 * n) ** 0.5
        assert abs(float(x.var()) / (bound ** 2 / 3) - 1) < 5 * (0.8 / n) ** 0.5
    noise = d.svf_noise
    assert noise.shape == (4096, nd, *augment.svf_size(spatial))
    assert abs(float(noise.mean())) < 5 / noise.numel() ** 0.5
    assert abs(float(noise.std()) - 1) < 5 / (2 * noise.numel()) ** 0.5
    again = augment.draw_deformation(torch.Generator().manual_seed(3), 4096,
                                     spatial, max_rotation=12.0,
                                     max_scaling=0.2, max_translation=6.0)
    assert all(torch.equal(a, b) for a, b in zip(d, again))


def test_augment_draws_on_the_generator_and_keeps_labels():
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(2, 1, 64, 64)
    lab = torch.randint(0, 4, (2, 1, 64, 64)).float()
    aug, lb, flow = augment.augment(src, gen, label=lab)
    assert aug.shape == src.shape and flow.shape == (2, 2, 64, 64)
    assert set(lb.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0}
    gen2 = torch.Generator().manual_seed(0)
    aug2, flow2 = augment.augment(src, gen2)
    assert torch.equal(aug, aug2) and torch.equal(flow, flow2)
    vol = torch.randn(1, 2, 24, 24, 24)
    aug3, flow3 = augment.augment(vol, gen)
    assert aug3.shape == vol.shape and flow3.shape == (1, 3, 24, 24, 24)
    assert bool(torch.isfinite(aug3).all())


class OnCard:
    """A tensor as the path rules see one on a card."""

    is_cuda = True

    def __init__(self, x):
        self._x = x

    def __getattr__(self, name):
        return getattr(self._x, name)


def spy(monkeypatch):
    """Count what would launch: the path rules see every tensor as on a
    card; each kernel's autograd function records its call and runs the
    plain version."""
    calls = []
    take = warp._kernel_takes
    chain = integrate._chain_takes
    monkeypatch.setattr(warp, "_kernel_takes",
                        lambda s, f, m: take(OnCard(s), OnCard(f), m))
    monkeypatch.setattr(integrate, "_chain_takes",
                        lambda v: chain(OnCard(v)))

    def plain_warp(name):
        class Fn:
            @staticmethod
            def apply(src, flow):
                calls.append((name, src.dtype))
                return warp.warp(src, flow, impl="torch")
        return Fn

    def plain_chain(name):
        class Fn:
            @staticmethod
            def apply(vec, n):
                calls.append((name, vec.dtype))
                return integrate.vecint(vec, n, impl="torch")
        return Fn

    monkeypatch.setattr(warp_cuda, "Warp2dFunction", plain_warp("B1"))
    monkeypatch.setattr(warp_cuda, "Warp3dFunction", plain_warp("B3"))
    monkeypatch.setattr(warp_cuda, "VecInt2dFunction",
                        plain_chain("vecint2d_fwd"))
    monkeypatch.setattr(warp_cuda, "VecInt3dFunction",
                        plain_chain("vecint3d_fwd"))
    return calls


@pytest.mark.parametrize("nd", [2, 3])
def test_augment_paths_by_dtype_and_mode(monkeypatch, nd):
    calls = spy(monkeypatch)
    spatial = (32, 32) if nd == 2 else (16, 16, 16)
    chain, fwd = ("vecint2d_fwd", "B1") if nd == 2 else ("vecint3d_fwd",
                                                         "B3")
    src = torch.randn(2, 1, *spatial)
    lab = torch.randint(0, 4, (2, 1, *spatial)).float()
    gen = torch.Generator().manual_seed(1)
    out, lb, flow = augment.augment(src, gen, label=lab)
    # float32: the chain at the SVF's size and one warp of the image; the
    # nearest label warp takes the plain gather
    assert calls == [(chain, torch.float32), (fwd, torch.float32)]
    assert set(lb.unique().tolist()) <= set(lab.unique().tolist())
    for dtype in (torch.float64, torch.bfloat16):
        del calls[:]
        gen = torch.Generator().manual_seed(1)
        out2, flow2 = augment.augment(src.to(dtype), gen)
        # the draws are float32: the chain still takes the SVF, the warp
        # of a float64 / bfloat16 image goes to the plain version
        assert calls == [(chain, torch.float32)]
        assert torch.equal(flow2, flow)
        assert bool(torch.isfinite(out2).all())
    del calls[:]
    warp.warp(src.double(), flow.double())
    integrate.vecint(flow.double(), 5)
    assert calls == []
