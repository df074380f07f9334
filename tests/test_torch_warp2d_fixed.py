"""B2's source gradient in its int64 fixed point,
``warp2d_dsrc_fixed_plain`` (what ``warp2d_bwd_cuda`` computes on the card,
bit for bit), and the 2-D VecInt forward at the shapes that take the
forward chain's global-memory and odd-shape paths on the card, on the CPU.

- The model against the dsrc of ``jax.vjp`` of the JAX package's f32 XLA
  warp (``warp(..., impl="xla")``): within 1e-5 * max(1, max|dsrc|), the
  kernels' bar (the model sums each term in an int64 fixed point, in
  another order than XLA's float adds).  C = 1 and 3, an odd shape
  (37x53), and flows whose coordinates pass the edge, so that the clamp to
  [-2, S+1] is taken.
- Each item has its own scale: with item 1's cotangent 2^20 times item 0's,
  each item is within the bar of its own max|dsrc|, and item 0 is the same
  bits as alone.
- A zero cotangent gives exactly 0; a NaN or inf in item 0 makes item 0
  NaN and leaves item 1 the same bits as alone.
- The plain B2 pair, ``warp_bwd_plain``'s dflow with the fixed dsrc,
  against both JAX gradients at 1e-5.
- ``vecint(..., impl="torch")`` against JAX's ``vecint`` at 1e-5 at
  (1, 2, 512, 512) and (3, 2, 67, 45).

Inputs come from a numpy seed; the boundary is NHWC <-> NCHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.integrate import vecint as jax_vecint
from dfmir_tpu.ops.warp import warp as jax_warp
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops.integrate import vecint
from dfmir_tpu_torch.ops.warp import warp2d_dsrc_fixed_plain, warp_bwd_plain

from test_torch_vecint_chain import field
from test_torch_warp import make_flow
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5
KINDS = ("smooth", "outside", "integer", "half", "far")


def bar(ref):
    return TOL * max(1.0, float(np.abs(ref).max()))


def flow_of(rng, kind, batch, spatial):
    """(B, H, W, 2) flows, NHWC: ``make_flow``'s kinds, or ``far``: about
    +-3 image sizes, so nearly every coordinate is clamped to [-2, S+1]."""
    if kind == "far":
        return (rng.standard_normal((batch, *spatial, 2))
                * 3 * max(spatial)).astype(np.float32)
    return make_flow(rng, kind, batch, spatial)


def inputs(rng, kind, B, C, spatial):
    """(src, flow, g) NHWC float32."""
    src = rng.standard_normal((B, *spatial, C)).astype(np.float32)
    g = rng.standard_normal((B, *spatial, C)).astype(np.float32)
    return src, flow_of(rng, kind, B, spatial), g


def jax_vjp(src, flow, g):
    _, vjp = jax.vjp(lambda s, f: jax_warp(s, f, impl="xla"),
                     jnp.asarray(src), jnp.asarray(flow))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(g)))


def model(flow, g):
    """The fixed-point dsrc, NHWC in and out."""
    return to_nhwc(warp2d_dsrc_fixed_plain(torch.from_numpy(to_nchw(flow)),
                                           torch.from_numpy(to_nchw(g))))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_dsrc_matches_jax(rng, kind, C):
    src, flow, g = inputs(rng, kind, 2, C, (24, 20))
    ref, _ = jax_vjp(src, flow, g)
    np.testing.assert_allclose(model(flow, g), ref, rtol=0, atol=bar(ref))
    if kind == "far":
        coords = flow + np.stack(np.meshgrid(np.arange(24), np.arange(20),
                                             indexing="ij"), -1)
        assert (coords < -2).any() and (coords[..., 0] > 25).any()


@pytest.mark.parametrize("C", [1, 3])
def test_dsrc_odd_shape(rng, C):
    src, flow, g = inputs(rng, "smooth", 2, C, (37, 53))
    ref, _ = jax_vjp(src, flow, g)
    np.testing.assert_allclose(model(flow, g), ref, rtol=0, atol=bar(ref))


@pytest.mark.parametrize("C", [1, 3])
def test_items_scale_apart(rng, C):
    """Item 1's cotangent 2^20 times item 0's: each item within the bar of
    its own max|dsrc|, and item 0 the same bits as alone."""
    src, flow, g = inputs(rng, "smooth", 2, C, (24, 20))
    g[1] *= 2.0 ** 20
    ref, _ = jax_vjp(src, flow, g)
    out = model(flow, g)
    for b in range(2):
        np.testing.assert_allclose(out[b], ref[b], rtol=0, atol=bar(ref[b]))
    assert np.array_equal(out[0], model(flow[:1], g[:1])[0])


def test_zero_cotangent_gives_zero(rng):
    _, flow, g = inputs(rng, "smooth", 2, 3, (24, 20))
    out = warp2d_dsrc_fixed_plain(torch.from_numpy(to_nchw(flow)),
                                  torch.zeros(2, 3, 24, 20))
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nonfinite_item(rng, bad):
    """A non-finite cotangent in item 0 makes item 0's dsrc NaN; item 1 is
    the same bits as alone."""
    _, flow, g = inputs(rng, "smooth", 2, 2, (24, 20))
    g[0, 5, 7, 1] = bad
    flow_t, g_t = (torch.from_numpy(to_nchw(a)) for a in (flow, g))
    out = warp2d_dsrc_fixed_plain(flow_t, g_t)
    alone = warp2d_dsrc_fixed_plain(flow_t[1:], g_t[1:])
    assert bool(out[0].isnan().all())
    assert torch.equal(out[1:], alone)


@pytest.mark.parametrize("kind", KINDS)
def test_b2_pair_matches_jax(rng, kind):
    """B2's plain pair as the card computes it (dflow by autograd of the
    plain warp, dsrc in the fixed point) against both JAX gradients."""
    src, flow, g = inputs(rng, kind, 2, 3, (24, 20))
    ref_dsrc, ref_dflow = jax_vjp(src, flow, g)
    src_t, flow_t, g_t = (torch.from_numpy(to_nchw(a))
                          for a in (src, flow, g))
    _, dflow = warp_bwd_plain(src_t, flow_t, g_t, need_dsrc=False)
    dsrc = warp2d_dsrc_fixed_plain(flow_t, g_t)
    np.testing.assert_allclose(to_nhwc(dflow), ref_dflow, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(dsrc), ref_dsrc, rtol=0,
                               atol=bar(ref_dsrc))


@pytest.mark.parametrize("shape,scale", [((1, 512, 512, 2), 0.25),
                                         ((3, 67, 45, 2), 1.0)])
def test_vecint_forward_matches_jax(rng, shape, scale):
    """The plain loop, which the forward chain equals bit for bit on the
    card, at the shapes of its global-memory path (512^2: two buffers of a
    16th of the rows exceed a block's shared memory) and an odd shape.

    At 512^2 the velocity is ``field``'s smooth one at a quarter scale
    (the integrated field moves about 1.8 px): XLA's CPU warp rounds about
    23% of one warp's outputs 1 ulp away from the strict left-to-right
    order that the port and its kernels share, and float32 coordinates
    near 512 px resolve only 3.05e-5 px, so the two 7-step loops part with
    the field's size and the image's: by 2.4e-6 at this scale, 1.2e-5 at
    half of ``field``'s and 4.6e-5 at the whole (1.5e-5 at 256^2, 7.2e-6
    at 128^2), measured on these inputs."""
    vec = field(rng, "smooth", shape) * np.float32(scale)
    ref = np.asarray(jax_vecint(jnp.asarray(vec), 7))
    out = to_nhwc(vecint(torch.from_numpy(to_nchw(vec)), 7, impl="torch"))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    assert np.abs(ref - vec / 128).max() > 1.0      # the field deformed
