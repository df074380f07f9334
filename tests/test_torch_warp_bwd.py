"""The 2-D warp backward: its plain version (``warp_bwd_plain``) against
the JAX package, and ``Warp2dFunction``'s wiring on the CPU.

- Against ``jax.vjp`` of ``warp(..., impl="xla")``, 1e-5 max-abs (float32
  rounding of the same formula).
- Against the Pallas kernel ``warp2d_banded_bwd`` run in interpret mode,
  1e-5 max-abs.  Its selection matmuls split operands into bf16 hi/lo
  halves and drop lo*lo; the inputs sit on grids that make every product
  exact under that split (src in 1/256 steps, coordinates in 1/64 steps, g
  in 1/4 steps), so the bar tests the gradient, not the TPU's bf16
  emulation (on N(0, 1) inputs the JAX suite holds it at 2e-4).
- The wiring: the kernel launchers swapped for their plain versions, as on
  the card they are swapped for kernels, so the CPU exercises exactly the
  autograd.Function the card runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.warp import warp as jax_warp
from dfmir_tpu.ops.warp_pallas import warp2d_banded_bwd
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import warp, warp_bwd_plain

from test_torch_warp import FLOWS, make_flow

TOL = 1e-5


def jax_vjp(src, flow, g):
    _, vjp = jax.vjp(lambda s, f: jax_warp(s, f, impl="xla"),
                     jnp.asarray(src), jnp.asarray(flow))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(g)))


def plain(src, flow, g, need_dsrc=True):
    return warp_bwd_plain(*(torch.from_numpy(to_nchw(a))
                              for a in (src, flow, g)), need_dsrc=need_dsrc)


@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("kind", FLOWS)
def test_plain_bwd_matches_jax_vjp(rng, kind, C):
    src = rng.standard_normal((2, 24, 20, C)).astype(np.float32)
    flow = make_flow(rng, kind, 2, (24, 20))
    g = rng.standard_normal((2, 24, 20, C)).astype(np.float32)
    dsrc_ref, dflow_ref = jax_vjp(src, flow, g)
    dsrc, dflow = plain(src, flow, g)
    assert np.abs(dflow_ref).max() > 0.1
    np.testing.assert_allclose(to_nhwc(dsrc), dsrc_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(dflow), dflow_ref, rtol=0, atol=TOL)
    none, dflow_only = plain(src, flow, g, need_dsrc=False)
    assert none is None
    np.testing.assert_array_equal(dflow_only.numpy(), dflow.numpy())


@pytest.mark.parametrize("C", [1, 2, 3])
def test_plain_bwd_matches_pallas_kernel(rng, C):
    B, H, W = 2, 64, 64
    src = np.clip(np.round(rng.standard_normal((B, H, W, C)) * 256) / 256,
                  -4, 4).astype(np.float32)
    flow = (np.round(make_flow(rng, "smooth", B, (H, W)) * 64) / 64).astype(
        np.float32)
    g = np.clip(np.round(rng.standard_normal((B, H, W, C)) * 4) / 4,
                -4, 4).astype(np.float32)
    dsrc_p, dflow_p, ok = warp2d_banded_bwd(
        jnp.asarray(src), jnp.asarray(flow), jnp.asarray(g), interpret=True)
    assert bool(ok)
    dsrc, dflow = plain(src, flow, g)
    np.testing.assert_allclose(to_nhwc(dsrc), np.asarray(dsrc_p), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_nhwc(dflow), np.asarray(dflow_p), rtol=0,
                               atol=TOL)


def test_plain_bwd_vecint_alias(rng):
    """src is flow (VecInt's self-warp): the two gradients come back apart
    and add up to jax.vjp of the self-warp."""
    flow = make_flow(rng, "smooth", 2, (16, 16))
    g = rng.standard_normal(flow.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_warp(v, v, impl="xla"), jnp.asarray(flow))
    (ref,) = vjp(jnp.asarray(g))
    v = torch.from_numpy(to_nchw(flow))
    dsrc, dflow = warp_bwd_plain(v, v, torch.from_numpy(to_nchw(g)))
    np.testing.assert_allclose(to_nhwc(dsrc + dflow), np.asarray(ref),
                               rtol=0, atol=TOL)


# ------------------------------------------------------------------ wiring

@pytest.fixture
def plain_launchers(monkeypatch):
    """Warp2dFunction with its launchers swapped for the plain versions,
    recording each backward call's need_dsrc."""
    calls = []

    def bwd(src, flow, g, need_dsrc=True):
        calls.append(need_dsrc)
        return warp_bwd_plain(src, flow, g, need_dsrc=need_dsrc)

    monkeypatch.setattr(warp_cuda, "warp2d_cuda",
                        lambda s, f: warp(s, f, impl="torch"))
    monkeypatch.setattr(warp_cuda, "warp2d_bwd_cuda", bwd)
    return calls


def tensors(rng, shape=(2, 2, 24, 20), kind="smooth"):
    B, C, H, W = shape
    src = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    flow = torch.from_numpy(to_nchw(make_flow(rng, kind, B, (H, W))))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return src, flow, g


@pytest.mark.parametrize("kind", ["smooth", "outside"])
def test_function_gradients_equal_plain_autograd(rng, plain_launchers, kind):
    src, flow, g = tensors(rng, kind=kind)
    s1, f1 = src.clone().requires_grad_(), flow.clone().requires_grad_()
    warp_cuda.Warp2dFunction.apply(s1, f1).backward(g)
    s2, f2 = src.clone().requires_grad_(), flow.clone().requires_grad_()
    warp(s2, f2, impl="torch").backward(g)
    np.testing.assert_array_equal(s1.grad.numpy(), s2.grad.numpy())
    np.testing.assert_array_equal(f1.grad.numpy(), f2.grad.numpy())
    assert plain_launchers == [True]


def test_function_skips_dsrc_for_data(rng, plain_launchers):
    """The full-resolution warp of the input images: src needs no grad, so
    the backward is asked for dflow alone."""
    src, flow, g = tensors(rng, shape=(2, 1, 24, 20))
    f = flow.clone().requires_grad_()
    out = warp_cuda.Warp2dFunction.apply(src, f)
    out.backward(g)
    assert plain_launchers == [False]
    _, ref = warp_bwd_plain(src, flow, g)
    np.testing.assert_array_equal(f.grad.numpy(), ref.numpy())


def test_function_alias_adds_gradients(rng, plain_launchers):
    """VecInt: one tensor is src and flow; autograd adds the two."""
    _, flow, _ = tensors(rng, shape=(1, 2, 16, 16))
    g = torch.from_numpy(rng.standard_normal((1, 2, 16, 16)).astype(
        np.float32))
    v = flow.clone().requires_grad_()
    warp_cuda.Warp2dFunction.apply(v, v).backward(g)
    dsrc, dflow = warp_bwd_plain(flow, flow, g)
    np.testing.assert_allclose(v.grad.numpy(), (dsrc + dflow).numpy(),
                               rtol=0, atol=1e-6)
    assert plain_launchers == [True]


def test_cpu_tensors_never_reach_the_kernels(rng):
    src, flow, g = tensors(rng)
    before = dict(warp_cuda.LAUNCHES)
    s, f = src.requires_grad_(), flow.requires_grad_()
    warp(s, f).backward(g)
    assert warp_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.warp2d_bwd_cuda(src.detach(), flow.detach(), g)
