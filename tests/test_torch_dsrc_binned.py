"""The binned 3-D source gradient's plain model, ``warp3d_dsrc_binned_plain``
(what B5 and ``vecint3d_bwd`` compute on the card, bit for bit), on the CPU.

- Against ``jax.vjp`` of the JAX package's f32 XLA warp
  (``warp(..., impl="xla")``) and against the port's autograd version
  ``warp_bwd_plain``: within 1e-5 * max(1, max|dsrc|), the kernels' bar
  (the model sums each term in an int64 fixed point, in another order than
  autograd's float adds).
- Fields: smooth, mostly outside, x25 noise, and a collapse (flow 0.95 *
  (centre - p): thousands of targets share a few cells).
- A zero cotangent gives exactly 0; a NaN or inf in it gives a result that
  is not finite where the plain version's is not; a huge one does not
  overflow the fixed point.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.warp import warp as jax_warp
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops.warp import warp3d_dsrc_binned_plain, warp_bwd_plain

from test_torch_warp import make_flow

SPATIAL = (12, 14, 16)
ODD = (9, 13, 7)
FIELDS = ("smooth", "outside", "noise", "collapse")


def flow_of(rng, kind, batch, spatial):
    """(B, *spatial, 3) NHWC flow of the named kind."""
    if kind == "noise":
        return (25.0 * rng.standard_normal((batch, *spatial, 3))).astype(
            np.float32)
    if kind == "collapse":
        grid = np.stack(np.meshgrid(*[np.arange(n) for n in spatial],
                                    indexing="ij"), axis=-1)
        centre = (np.array(spatial) - 1) / 2
        flow = 0.95 * (centre - grid)
        return np.broadcast_to(flow, (batch, *spatial, 3)).astype(np.float32)
    return make_flow(rng, kind, batch, spatial)


def bar(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def jax_dsrc(src, flow, g):
    _, vjp = jax.vjp(lambda s: jax_warp(s, jnp.asarray(flow), impl="xla"),
                     jnp.asarray(src))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", FIELDS)
def test_model_matches_jax_and_autograd(rng, kind, C):
    B, spatial = (2, SPATIAL) if C == 3 else (1, ODD)
    src = rng.standard_normal((B, *spatial, C)).astype(np.float32)
    flow = flow_of(rng, kind, B, spatial)
    g = rng.standard_normal(src.shape).astype(np.float32)
    out = to_nhwc(warp3d_dsrc_binned_plain(torch.from_numpy(to_nchw(flow)),
                                           torch.from_numpy(to_nchw(g))))
    ref = jax_dsrc(src, flow, g)
    np.testing.assert_allclose(out, ref, rtol=0, atol=bar(ref))
    plain, _ = warp_bwd_plain(torch.from_numpy(to_nchw(src)),
                              torch.from_numpy(to_nchw(flow)),
                              torch.from_numpy(to_nchw(g)), need_dflow=False)
    np.testing.assert_allclose(out, to_nhwc(plain), rtol=0, atol=bar(ref))
    if kind == "collapse":     # every term lands in a few voxels
        assert np.count_nonzero(ref) <= 0.05 * ref.size


def inputs(rng, shape=(2, 3, *SPATIAL)):
    flow = torch.from_numpy(to_nchw(flow_of(rng, "smooth", shape[0],
                                            shape[2:])))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), \
        flow, g


def test_zero_cotangent_is_exactly_zero(rng):
    _, flow, g = inputs(rng)
    assert torch.equal(warp3d_dsrc_binned_plain(flow, torch.zeros_like(g)),
                       torch.zeros_like(g))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_nonfinite_cotangent_is_not_finite(rng, bad):
    src, flow, g = inputs(rng)
    g[1, 2, 5, 6, 7] = bad
    ref, _ = warp_bwd_plain(src, flow, g, need_dflow=False)
    out = warp3d_dsrc_binned_plain(flow, g)
    assert not torch.isfinite(ref).all()
    assert not torch.isfinite(out[~torch.isfinite(ref)]).any()


def test_huge_cotangent_does_not_overflow(rng):
    """g of 1e30: the fixed point's exponent goes negative and the sums stay
    below 2^61, so the result keeps the kernels' relative bar."""
    src, flow, g = inputs(rng)
    g = g * 1e30
    ref, _ = warp_bwd_plain(src, flow, g, need_dflow=False)
    out = warp3d_dsrc_binned_plain(flow, g)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
