"""The port's warp (dfmir_tpu_torch.ops.warp, plain version on the CPU)
against the JAX package: the XLA path for 1/2/3-D linear and nearest
forwards and for both gradients, and the Pallas forward kernel
``warp2d_banded`` run in interpret mode.  Tolerance 1e-5 max-abs (float32
rounding of the same formula)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.warp import warp as jax_warp
from dfmir_tpu.ops.warp_pallas import warp2d_banded
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import warp

TOL = 1e-5
SPATIAL = {1: (32,), 2: (24, 20), 3: (8, 10, 12)}
LINEAR = {1: "linear", 2: "bilinear", 3: "trilinear"}


def make_flow(rng, kind, batch, spatial):
    """(B, *spatial, nd) flows of the named kind, NHWC."""
    nd = len(spatial)
    shape = (batch,) + tuple(spatial) + (nd,)
    if kind == "smooth":        # a few pixels, low frequency
        grids = np.meshgrid(*[np.linspace(0, np.pi, s) for s in spatial],
                            indexing="ij")
        phase = rng.uniform(0, np.pi, size=(batch, 1) + (1,) * nd)
        base = sum(np.sin(g + 0.7 * i) for i, g in enumerate(grids))
        flow = 3.0 * np.sin(base[None, None] + phase)
        flow = np.moveaxis(np.broadcast_to(flow, (batch, nd) + tuple(spatial)),
                           1, -1)
        return (flow + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    if kind == "outside":       # most corners leave the image
        scale = max(spatial)
        return (rng.standard_normal(shape) * scale + 0.4 * scale).astype(
            np.float32)
    if kind == "integer":       # floor edges: weights exactly 0 / 1
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    if kind == "half":          # .5 coordinates: round half to even
        return (rng.integers(-3, 4, size=shape) + 0.5).astype(np.float32)
    raise ValueError(kind)


FLOWS = ("smooth", "outside", "integer", "half")


@pytest.mark.parametrize("nd", [1, 2, 3])
@pytest.mark.parametrize("mode", ["linear", "nearest"])
@pytest.mark.parametrize("kind", FLOWS)
def test_forward_matches_xla(rng, nd, mode, kind):
    C = 1 + (nd + FLOWS.index(kind)) % 3           # C in {1, 2, 3}
    spatial = SPATIAL[nd]
    src = rng.standard_normal((2,) + spatial + (C,)).astype(np.float32)
    flow = make_flow(rng, kind, 2, spatial)
    jmode = LINEAR[nd] if mode == "linear" else "nearest"
    ref = np.asarray(jax_warp(jnp.asarray(src), jnp.asarray(flow), mode=jmode,
                              impl="xla"))
    out = warp(torch.from_numpy(to_nchw(src)), torch.from_numpy(to_nchw(flow)),
               mode=jmode)
    assert out.shape == to_nchw(ref).shape
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("C", [1, 2, 3])
def test_forward_matches_pallas_kernel(rng, C):
    """Against warp2d_banded itself (interpret mode).  Its selection matmul
    splits the band into bf16 hi/lo halves; the inputs sit on a grid that
    split represents exactly (src in 1/256 steps, coords in 1/64 steps), so
    the comparison tests the sampling, not the TPU's bf16 emulation."""
    B, H, W = 2, 64, 64
    src = np.clip(np.round(rng.standard_normal((B, H, W, C)) * 256) / 256,
                  -4, 4).astype(np.float32)
    flow = np.round(make_flow(rng, "smooth", B, (H, W)) * 64) / 64
    out_p, ok = warp2d_banded(jnp.asarray(src), jnp.asarray(flow),
                              interpret=True)
    assert bool(ok)
    out = warp(torch.from_numpy(to_nchw(src)), torch.from_numpy(to_nchw(flow)))
    np.testing.assert_allclose(to_nhwc(out), np.asarray(out_p), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("kind", ["smooth", "outside"])
def test_gradients_match_jax_vjp(rng, nd, kind):
    spatial = SPATIAL[nd]
    C = 2
    src = rng.standard_normal((2,) + spatial + (C,)).astype(np.float32)
    flow = make_flow(rng, kind, 2, spatial)
    g = rng.standard_normal((2,) + spatial + (C,)).astype(np.float32)

    _, vjp = jax.vjp(lambda s, f: jax_warp(s, f, impl="xla"),
                     jnp.asarray(src), jnp.asarray(flow))
    dsrc_ref, dflow_ref = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    s = torch.from_numpy(to_nchw(src)).requires_grad_()
    f = torch.from_numpy(to_nchw(flow)).requires_grad_()
    warp(s, f).backward(torch.from_numpy(to_nchw(g)))
    np.testing.assert_allclose(to_nhwc(s.grad), dsrc_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(f.grad), dflow_ref, rtol=0, atol=TOL)


def test_vecint_self_warp_gradient(rng):
    """src and flow the same tensor (VecInt's step): both paths of the
    gradient add up as in jax.vjp."""
    flow = make_flow(rng, "smooth", 1, (16, 16))
    _, vjp = jax.vjp(lambda v: v + jax_warp(v, v, impl="xla"),
                     jnp.asarray(flow))
    g = rng.standard_normal(flow.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(to_nchw(flow)).requires_grad_()
    (v + warp(v, v)).backward(torch.from_numpy(to_nchw(g)))
    np.testing.assert_allclose(to_nhwc(v.grad), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_cpu_dispatch_and_cuda_impl_refusal(rng):
    src = torch.from_numpy(rng.standard_normal((1, 1, 8, 8)).astype(np.float32))
    flow = torch.zeros(1, 2, 8, 8)
    before = dict(warp_cuda.LAUNCHES)
    np.testing.assert_array_equal(warp(src, flow).numpy(), src.numpy())
    assert warp_cuda.LAUNCHES == before       # the CPU never reaches the kernel
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp(src, flow, impl="cuda")
    with pytest.raises(ValueError, match="2-D bilinear"):
        warp(src, flow, mode="nearest", impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        warp(src, flow, impl="xla")
