"""The 2-D chain backward's fixed-point plain model,
``vecint2d_bwd_fixed_plain`` (what ``vecint2d_bwd`` computes on the card,
bit for bit), and its source gradient ``warp2d_dsrc_fixed_plain``, on the
CPU.

- Against ``jax.vjp`` of the JAX package's ``vecint`` (the f32 XLA warp on
  the CPU) and against the port's autograd of the plain loop
  (``vecint_bwd_plain``): within 1e-5 * max(1, max|dvec|), the chain
  kernels' bar (the model sums each step's source terms in an int64 fixed
  point, in another order than autograd's float adds).
- Fields: smooth, mostly outside, a pos/neg stack and x25 noise, at 0, 1
  and 7 steps, and an odd shape.
- A zero cotangent gives exactly 0; a NaN in item 0 makes item 0 NaN and
  leaves item 1 finite; each item's scale is its own, so scaling item 1's
  cotangent by 1e6 leaves item 0's result the same bits.

Inputs come from a numpy seed; the boundary is NHWC <-> NCHW.
"""

import numpy as np
import pytest
import torch

from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops.integrate import (vecint2d_bwd_fixed_plain,
                                           vecint_bwd_plain)
from dfmir_tpu_torch.ops.warp import warp2d_dsrc_fixed_plain, warp_bwd_plain

from test_torch_vecint_chain import field, jax_chain, plain_chain_fwd
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

FIELDS = ("smooth", "outside", "posneg", "noise")


def bar(ref):
    return 1e-5 * max(1.0, float(np.abs(ref).max()))


def velocity(rng, kind, shape=(2, 20, 24, 2)):
    """A (B, H, W, 2) velocity field, NHWC: ``field``'s kinds, or x25
    N(0, 1) noise."""
    if kind == "noise":
        return (25.0 * rng.standard_normal(shape)).astype(np.float32)
    return field(rng, kind, shape)


def model(vec, nsteps, g):
    """The model's dvec (NHWC) for the velocity ``vec`` and cotangent ``g``
    (NHWC), its steps saved by the plain loop, as the forward kernel (bit
    for bit) saves them."""
    _, steps = plain_chain_fwd(torch.from_numpy(to_nchw(vec)), nsteps,
                               save=True)
    return to_nhwc(vecint2d_bwd_fixed_plain(steps,
                                            torch.from_numpy(to_nchw(g))))


@pytest.mark.parametrize("nsteps", [0, 1, 7])
@pytest.mark.parametrize("kind", FIELDS)
def test_model_matches_jax_and_autograd(rng, kind, nsteps):
    vec = velocity(rng, kind)
    g = rng.standard_normal(vec.shape).astype(np.float32)
    out = model(vec, nsteps, g)
    _, ref = jax_chain(vec, nsteps, g)
    np.testing.assert_allclose(out, ref, rtol=0, atol=bar(ref))
    plain = to_nhwc(vecint_bwd_plain(torch.from_numpy(to_nchw(vec)), nsteps,
                                     torch.from_numpy(to_nchw(g))))
    np.testing.assert_allclose(out, plain, rtol=0, atol=bar(ref))
    if nsteps == 0:
        assert np.array_equal(out, g)


def test_model_odd_shape(rng):
    vec = velocity(rng, "smooth", (3, 17, 13, 2))
    g = rng.standard_normal(vec.shape).astype(np.float32)
    _, ref = jax_chain(vec, 7, g)
    np.testing.assert_allclose(model(vec, 7, g), ref, rtol=0, atol=bar(ref))


def test_dsrc_matches_autograd(rng):
    """One warp's source gradient in the fixed point against autograd of
    the plain warp, two channels and one."""
    for C in (2, 1):
        flow = torch.from_numpy(to_nchw(velocity(rng, "smooth") / 2))
        g = torch.from_numpy(rng.standard_normal(
            (2, C, 20, 24)).astype(np.float32))
        ref, _ = warp_bwd_plain(torch.zeros_like(g), flow, g,
                                need_dflow=False)
        out = warp2d_dsrc_fixed_plain(flow, g)
        assert float((out - ref).abs().max()) <= bar(ref.numpy())


def test_zero_and_nonfinite_cotangents(rng):
    vec = velocity(rng, "smooth")
    _, steps = plain_chain_fwd(torch.from_numpy(to_nchw(vec)), 7, save=True)
    zero = vecint2d_bwd_fixed_plain(steps, torch.zeros(steps.shape[1:]))
    assert torch.equal(zero, torch.zeros_like(zero))
    g = torch.from_numpy(to_nchw(rng.standard_normal(vec.shape).astype(
        np.float32)))
    g[0, 1, 3, 4] = float("nan")
    out = vecint2d_bwd_fixed_plain(steps, g)
    assert bool(out[0].isnan().all()) and bool(out[1].isfinite().all())


def test_items_scale_apart(rng):
    """Item 1's cotangent 1e6 times larger leaves item 0's gradient the same
    bits (the scale is per item), and item 1's is still within the bar."""
    vec = velocity(rng, "posneg")
    g = rng.standard_normal(vec.shape).astype(np.float32)
    big = g.copy()
    big[1] *= 1e6
    out, out_big = model(vec, 7, g), model(vec, 7, big)
    assert np.array_equal(out[0], out_big[0])
    _, ref = jax_chain(vec, 7, big)
    np.testing.assert_allclose(out_big[1], ref[1], rtol=0,
                               atol=bar(ref[1]))
