"""The 3-D trilinear warp: its plain forward and backward (``warp`` and
``warp_bwd_plain`` at 3-D) against the JAX package, and
``Warp3dFunction``'s wiring on the CPU.

- Against ``warp(..., impl="xla")`` and ``jax.vjp`` of it, 1e-5 max-abs
  (float32 rounding of the same formula).
- Against the Pallas kernels ``warp3d_banded``, ``warp3d_banded_bwd_dflow``
  and ``warp3d_banded_bwd_dsrc`` run in interpret mode at bf16x3, 1e-5
  max-abs.  Their selection matmuls split operands into bf16 hi/lo halves
  and drop lo*lo; the inputs sit on grids that make every product exact
  under that split (src in 1/256 steps, flow in 1/8 steps, g in 1/4
  steps), so the bar tests the gradient, not the TPU's bf16 emulation.
- The wiring: the three kernel launchers swapped for their plain versions,
  as on the card they are the kernels, so the CPU exercises exactly the
  autograd.Function the card runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.warp import warp as jax_warp
from dfmir_tpu.ops.warp_pallas import (warp3d_banded, warp3d_banded_bwd_dflow,
                                       warp3d_banded_bwd_dsrc)
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.integrate import vecint
from dfmir_tpu_torch.ops.warp import warp, warp_bwd_plain

from test_torch_warp import FLOWS, make_flow

TOL = 1e-5
SPATIAL = (8, 10, 12)
KERNELS = (warp_cuda.FWD3D, warp_cuda.DFLOW3D, warp_cuda.DSRC3D)


def t(a):
    return torch.from_numpy(to_nchw(a))


def jax_vjp(src, flow, g):
    _, vjp = jax.vjp(lambda s, f: jax_warp(s, f, impl="xla"),
                     jnp.asarray(src), jnp.asarray(flow))
    return tuple(np.asarray(a) for a in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("kind", FLOWS)
def test_plain_matches_jax(rng, kind, C):
    src = rng.standard_normal((2,) + SPATIAL + (C,)).astype(np.float32)
    flow = make_flow(rng, kind, 2, SPATIAL)
    g = rng.standard_normal(src.shape).astype(np.float32)
    out = warp(t(src), t(flow), mode="trilinear")
    ref = np.asarray(jax_warp(jnp.asarray(src), jnp.asarray(flow),
                              mode="trilinear", impl="xla"))
    np.testing.assert_allclose(to_nhwc(out), ref, rtol=0, atol=TOL)
    dsrc_ref, dflow_ref = jax_vjp(src, flow, g)
    dsrc, dflow = warp_bwd_plain(t(src), t(flow), t(g))
    assert np.abs(dflow_ref).max() > 0.1
    np.testing.assert_allclose(to_nhwc(dsrc), dsrc_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(dflow), dflow_ref, rtol=0, atol=TOL)
    # each gradient alone is the same as both together
    none, dflow_only = warp_bwd_plain(t(src), t(flow), t(g), need_dsrc=False)
    dsrc_only, none2 = warp_bwd_plain(t(src), t(flow), t(g), need_dflow=False)
    assert none is None and none2 is None
    np.testing.assert_array_equal(dflow_only.numpy(), dflow.numpy())
    np.testing.assert_array_equal(dsrc_only.numpy(), dsrc.numpy())


def test_plain_vecint_alias(rng):
    """src is flow (VecInt's self-warp): the two gradients come back apart
    and add up to jax.vjp of the self-warp."""
    flow = make_flow(rng, "smooth", 1, SPATIAL)
    g = rng.standard_normal(flow.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_warp(v, v, impl="xla"), jnp.asarray(flow))
    (ref,) = vjp(jnp.asarray(g))
    v = t(flow)
    dsrc, dflow = warp_bwd_plain(v, v, t(g))
    np.testing.assert_allclose(to_nhwc(dsrc + dflow), np.asarray(ref),
                               rtol=0, atol=TOL)


def exact_inputs(rng, shape):
    """src in 1/256 steps (<= 11 significant bits), a smooth flow in 1/8
    steps, g in 1/4 steps: every product of the bf16x3 selection matmuls is
    exact, so the Pallas kernels compute the f32 formula."""
    B, D, H, W, C = shape
    src = np.clip(np.round(rng.standard_normal(shape) * 256) / 256,
                  -4, 4).astype(np.float32)
    flow = (np.round(make_flow(rng, "smooth", B, (D, H, W)) * 8) / 8).astype(
        np.float32)
    g = np.clip(np.round(rng.standard_normal(shape) * 4) / 4,
                -4, 4).astype(np.float32)
    return src, flow, g


@pytest.mark.parametrize("C", [1, 3])
def test_plain_matches_pallas_kernels(rng, C):
    """B3, B4 and B5's TPU kernels in interpret mode against the port's
    plain versions."""
    src, flow, g = exact_inputs(rng, (1, 16, 16, 24, C))
    out_p, ok = warp3d_banded(jnp.asarray(src), jnp.asarray(flow),
                              interpret=True, precision="bf16x3")
    assert bool(ok)
    dflow_p, ok_f = warp3d_banded_bwd_dflow(
        jnp.asarray(src), jnp.asarray(flow), jnp.asarray(g), fold=2,
        interpret=True, precision="bf16x3")
    dsrc_p, ok_s = warp3d_banded_bwd_dsrc(
        jnp.asarray(flow), jnp.asarray(g), fold=2, interpret=True,
        precision="bf16x3")
    assert bool(ok_f) and bool(ok_s)
    out = warp(t(src), t(flow), mode="trilinear")
    dsrc, dflow = warp_bwd_plain(t(src), t(flow), t(g))
    assert np.abs(np.asarray(dflow_p)).max() > 0.1
    for mine, ref in ((out, out_p), (dflow, dflow_p), (dsrc, dsrc_p)):
        np.testing.assert_allclose(to_nhwc(mine), np.asarray(ref), rtol=0,
                                   atol=TOL)


# ------------------------------------------------------------------ wiring

@pytest.fixture
def plain_launchers(monkeypatch):
    """Warp3dFunction with its three launchers swapped for the plain
    versions, recording which backward halves ran."""
    calls = []

    def dflow(src, flow, g):
        calls.append("dflow")
        return warp_bwd_plain(src, flow, g, need_dsrc=False)[1]

    def dsrc(flow, g):
        calls.append("dsrc")
        # the source values do not enter dsrc: any source of g's shape
        return warp_bwd_plain(torch.zeros_like(g), flow, g,
                              need_dflow=False)[0]

    monkeypatch.setattr(warp_cuda, "warp3d_cuda",
                        lambda s, f: warp(s, f, impl="torch"))
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dflow_cuda", dflow)
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dsrc_cuda", dsrc)
    return calls


def tensors(rng, C=2, kind="smooth"):
    src = torch.from_numpy(rng.standard_normal((2, C) + SPATIAL).astype(
        np.float32))
    flow = t(make_flow(rng, kind, 2, SPATIAL))
    g = torch.from_numpy(rng.standard_normal((2, C) + SPATIAL).astype(
        np.float32))
    return src, flow, g


@pytest.mark.parametrize("kind", ["smooth", "outside"])
def test_function_gradients_equal_plain_autograd(rng, plain_launchers, kind):
    src, flow, g = tensors(rng, kind=kind)
    s1, f1 = src.clone().requires_grad_(), flow.clone().requires_grad_()
    warp_cuda.Warp3dFunction.apply(s1, f1).backward(g)
    s2, f2 = src.clone().requires_grad_(), flow.clone().requires_grad_()
    warp(s2, f2, impl="torch").backward(g)
    np.testing.assert_array_equal(s1.grad.numpy(), s2.grad.numpy())
    np.testing.assert_array_equal(f1.grad.numpy(), f2.grad.numpy())
    assert sorted(plain_launchers) == ["dflow", "dsrc"]


def test_function_skips_dsrc_for_data(rng, plain_launchers):
    """The data warp: src needs no grad, so only the dflow half runs."""
    src, flow, g = tensors(rng, C=1)
    f = flow.clone().requires_grad_()
    warp_cuda.Warp3dFunction.apply(src, f).backward(g)
    assert plain_launchers == ["dflow"]
    _, ref = warp_bwd_plain(src, flow, g)
    np.testing.assert_array_equal(f.grad.numpy(), ref.numpy())


def test_function_skips_dflow_for_a_fixed_flow(rng, plain_launchers):
    src, flow, g = tensors(rng, C=1)
    s = src.clone().requires_grad_()
    warp_cuda.Warp3dFunction.apply(s, flow).backward(g)
    assert plain_launchers == ["dsrc"]
    ref, _ = warp_bwd_plain(src, flow, g)
    np.testing.assert_array_equal(s.grad.numpy(), ref.numpy())


def test_function_alias_adds_gradients(rng, plain_launchers):
    """VecInt: one tensor is src and flow; both halves run and autograd
    adds them."""
    _, flow, _ = tensors(rng)
    g = torch.from_numpy(rng.standard_normal(flow.shape).astype(np.float32))
    v = flow.clone().requires_grad_()
    warp_cuda.Warp3dFunction.apply(v, v).backward(g)
    dsrc, dflow = warp_bwd_plain(flow, flow, g)
    np.testing.assert_allclose(v.grad.numpy(), (dsrc + dflow).numpy(),
                               rtol=0, atol=1e-6)
    assert sorted(plain_launchers) == ["dflow", "dsrc"]


def test_vecint_runs_the_function_each_step(rng, plain_launchers,
                                            monkeypatch):
    """With the kernels' dispatch open to CPU tensors, vecint's 7 steps go
    through Warp3dFunction: 7 forward calls, 7 of each backward half."""
    from dfmir_tpu_torch.ops import warp as warp_mod

    fwd_calls = []
    plain_fwd = warp_cuda.warp3d_cuda
    monkeypatch.setattr(warp_cuda, "warp3d_cuda",
                        lambda s, f: fwd_calls.append(1) or plain_fwd(s, f))
    monkeypatch.setattr(warp_mod, "_kernel_takes",
                        lambda src, flow, mode: flow.shape[1] == 3)
    _, flow, _ = tensors(rng)
    v = flow.clone().requires_grad_()
    out = vecint(v, 7)
    ref = vecint(flow.clone().requires_grad_(), 7, impl="torch")
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    out.sum().backward()
    assert len(fwd_calls) == 7
    assert sorted(plain_launchers) == ["dflow"] * 7 + ["dsrc"] * 7


def test_cpu_tensors_never_reach_the_kernels(rng):
    src, flow, g = tensors(rng)
    before = dict(warp_cuda.LAUNCHES)
    s, f = src.requires_grad_(), flow.requires_grad_()
    warp(s, f, mode="trilinear").backward(g)
    assert warp_cuda.LAUNCHES == before
    s, f, g = src.detach(), flow.detach(), g
    for call in (lambda: warp_cuda.warp3d_cuda(s, f),
                 lambda: warp_cuda.warp3d_bwd_dflow_cuda(s, f, g),
                 lambda: warp_cuda.warp3d_bwd_dsrc_cuda(f, g),
                 lambda: warp(s, f, mode="trilinear", impl="cuda")):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    for mode, fl in (("nearest", f), ("linear", f[:, :1, 0, 0])):
        with pytest.raises(ValueError, match="3-D trilinear"):
            warp(s if fl is f else s[:, :, 0, 0], fl, mode=mode, impl="cuda")
    assert set(KERNELS) <= set(warp_cuda.LAUNCHES)
