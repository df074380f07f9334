"""The port's resize/integrate, blur filters and Jacobian ops against the
JAX package on the same numpy inputs.  Tolerance 1e-5 max-abs (float32
rounding of the same formulas)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfmir_tpu.ops import filters as jfilters
from dfmir_tpu.ops import integrate as jintegrate
from dfmir_tpu.ops import jacobian as jjacobian
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops import filters, integrate, jacobian
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5


def both(a):
    """The same NHWC numpy array as a JAX array and an NCHW torch tensor."""
    return jnp.asarray(a), torch.from_numpy(to_nchw(a))


@pytest.mark.parametrize("factor", [0.5, 2.0])
@pytest.mark.parametrize("spatial", [(32, 32), (16, 24)])
def test_resize_flow(rng, factor, spatial):
    flow = rng.standard_normal((2,) + spatial + (2,)).astype(np.float32) * 3
    j, t = both(flow)
    ref = np.asarray(jintegrate.resize_flow(j, factor))
    out = to_nhwc(integrate.resize_flow(t, factor))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("scale", [2.0, 8.0])
def test_vecint_seven_steps(rng, scale):
    """Smooth SVF: 7 chained self-warps, the VecInt of the main path."""
    H = W = 32
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, H),
                         np.linspace(0, 2 * np.pi, W), indexing="ij")
    svf = np.stack([np.sin(yy + xx), np.cos(yy - 0.5 * xx)], -1)[None]
    svf = (svf * scale + 0.1 * rng.standard_normal((1, H, W, 2))).astype(
        np.float32)
    j, t = both(svf)
    ref = np.asarray(jintegrate.vecint(j, 7))
    out = to_nhwc(integrate.vecint(t, 7))
    assert np.max(np.abs(ref - svf / 128)) > 0.1     # the chain did deform
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 17, 22, 2)])
def test_blur_downsample(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    j, t = both(x)
    ref = np.asarray(jfilters.blur_downsample(j))
    out = to_nhwc(filters.blur_downsample(t))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 9, 12, 2)])
@pytest.mark.parametrize("filt_size", [3, 4])
def test_blur_upsample(rng, shape, filt_size):
    """Odd and even filters: the asymmetric [1:] / [:-1] crop."""
    x = rng.standard_normal(shape).astype(np.float32)
    j, t = both(x)
    ref = np.asarray(jfilters.blur_upsample(j, filt_size=filt_size))
    out = to_nhwc(filters.blur_upsample(t, filt_size=filt_size))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("nd", [2, 3])
def test_jacobian_det_and_folding(rng, nd):
    spatial = (24, 20) if nd == 2 else (8, 10, 12)
    flow = (rng.standard_normal((2,) + spatial + (nd,)) * 0.6).astype(
        np.float32)
    j, t = both(flow)
    det_ref = np.asarray(jjacobian.jacobian_det(j))
    # no determinant within rounding of 0, so the fold counts are exact
    assert np.min(np.abs(det_ref)) > 1e-4
    det = jacobian.jacobian_det(t).numpy()
    np.testing.assert_allclose(det, det_ref, rtol=0, atol=TOL)
    fold_ref = np.asarray(jjacobian.folding_fraction(j))
    assert 0 < fold_ref.min()                         # the field does fold
    np.testing.assert_allclose(jacobian.folding_fraction(t).numpy(), fold_ref,
                               rtol=0, atol=TOL)
