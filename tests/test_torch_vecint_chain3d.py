"""VecInt's 3-D chain kernels on the CPU: ``VecInt3dFunction`` (one launch
forward, one backward) against the JAX package's ``vecint`` and ``jax.vjp``
of it at 3-D, with the two chain launchers swapped for counted plain
stand-ins, as on the card they are kernels; the chains' plain backward at
3-D; the dispatch; and the launches the 3-D engine's entry points make,
every kernel counted.

Bars: 1e-5 max-abs on the field and its input gradient (float32 rounding of
the same formulas).  Inputs come from a numpy seed; the boundary is
NDHWC <-> NCDHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.integrate import vecint as jax_vecint
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.ops import integrate, warp_cuda
from dfmir_tpu_torch.ops.integrate import vecint, vecint_bwd_plain

from test_torch_vecint_chain import (_counted, counted_kernels,  # noqa: F401
                                     plain_chain_bwd, plain_chain_fwd)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5
VF3, VB3 = warp_cuda.VECINT3D_FWD, warp_cuda.VECINT3D_BWD
F3, D3 = warp_cuda.FWD3D, warp_cuda.DFLOW3D
SHAPE = (2, 12, 14, 16, 3)     # (B, D, H, W, 3), NDHWC


@pytest.fixture
def chain3d(monkeypatch):
    """Only the 3-D chain's launchers swapped (counted, each forward's
    ``save`` recorded) and the chains' dispatch opened to CPU float32
    fields; the single warps stay on the CPU's own path."""
    monkeypatch.setattr(warp_cuda, "LAUNCHES",
                        dict.fromkeys(warp_cuda.LAUNCHES, 0))
    saves = []
    monkeypatch.setattr(warp_cuda, "vecint3d_fwd_cuda",
                        _counted(warp_cuda.LAUNCHES, VF3, plain_chain_fwd,
                                 saves))
    monkeypatch.setattr(warp_cuda, "vecint3d_bwd_cuda",
                        _counted(warp_cuda.LAUNCHES, VB3, plain_chain_bwd))
    monkeypatch.setattr(integrate, "_chain_takes",
                        lambda vec: vec.dtype == torch.float32)
    return warp_cuda.LAUNCHES, saves


def field3d(rng, kind, shape=SHAPE):
    """A (B, D, H, W, 3) velocity field, NDHWC: ``smooth`` (a few voxels
    once integrated), ``outside`` (most voxels sample outside the volume
    from the first step on) or ``posneg`` (a smooth field and its negation
    stacked on the batch, as the bidirectional model integrates them)."""
    B, D, H, W, _ = shape
    if kind == "outside":
        v = rng.standard_normal(shape) * 128 * 2 * max(D, H, W)
        return (v + 128 * 1.5 * D).astype(np.float32)
    zz, yy, xx = np.meshgrid(*(np.linspace(0, 2 * np.pi, n)
                               for n in (D, H, W)), indexing="ij")
    base = np.stack([np.sin(zz + yy), np.cos(yy - 0.5 * xx),
                     np.sin(xx + 0.7 * zz)], -1)
    half = B // 2 if kind == "posneg" else B
    v = (4.0 * base[None] * rng.uniform(0.5, 1.5, (half, 1, 1, 1, 1))
         + 0.3 * rng.standard_normal((half, D, H, W, 3))).astype(np.float32)
    return np.concatenate([v, -v]) if kind == "posneg" else v


def jax_chain(vec, nsteps, g):
    out, vjp = jax.vjp(lambda v: jax_vecint(v, nsteps), jnp.asarray(vec))
    (dvec,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dvec)


@pytest.mark.parametrize("nsteps", [0, 1, 7])
@pytest.mark.parametrize("kind", ["smooth", "outside", "posneg"])
def test_chain3d_function_matches_jax(rng, chain3d, nsteps, kind):
    """The field and its input gradient through VecInt3dFunction: one
    forward and one backward launch, the forward asked to save its steps."""
    launches, saves = chain3d
    vec = field3d(rng, kind)
    g = rng.standard_normal(vec.shape).astype(np.float32)
    ref, ref_dvec = jax_chain(vec, nsteps, g)
    v = torch.from_numpy(to_nchw(vec)).requires_grad_()
    out = vecint(v, nsteps)
    out.backward(torch.from_numpy(to_nchw(g)))
    assert launches == dict(dict.fromkeys(launches, 0), **{VF3: 1, VB3: 1})
    assert saves == [True]
    np.testing.assert_allclose(to_nhwc(out.detach()), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(v.grad), ref_dvec, rtol=0, atol=TOL)
    if kind == "outside" and nsteps:
        # most voxels leave the volume: their steps add nothing
        assert np.mean(ref == vec / 2 ** nsteps) > 0.5
    if nsteps == 7 and kind != "outside":
        assert np.abs(ref - vec / 128).max() > 0.1   # the chain did deform


def test_chain3d_without_grad_saves_no_stack(rng, chain3d):
    """Inference: an input that needs no gradient gets an output without a
    graph, and the forward is asked for no saved stack."""
    launches, saves = chain3d
    vec = torch.from_numpy(to_nchw(field3d(rng, "smooth")))
    out = vecint(vec, 7)
    with torch.no_grad():
        out_ng = vecint(vec.clone().requires_grad_(False), 7)
    assert out.grad_fn is None and out_ng.grad_fn is None
    assert saves == [False, False]
    assert launches[VF3] == 2 and launches[VB3] == 0
    assert launches[warp_cuda.VECINT_FWD] == 0
    torch.testing.assert_close(out, vecint(vec, 7, impl="torch"), rtol=0,
                               atol=0)


def test_vecint_bwd_plain_matches_jax_vjp_3d(rng):
    """The chain backward's plain version at 3-D, which the card compares
    the kernel with."""
    vec = field3d(rng, "posneg")
    g = rng.standard_normal(vec.shape).astype(np.float32)
    _, ref = jax_chain(vec, 7, g)
    dvec = vecint_bwd_plain(torch.from_numpy(to_nchw(vec)), 7,
                            torch.from_numpy(to_nchw(g)))
    np.testing.assert_allclose(to_nhwc(dvec), ref, rtol=0, atol=TOL)


def test_cpu_dispatch_never_counts_a_3d_launch(rng):
    """Without the stand-ins: a CPU 3-D field takes the plain loop, no
    kernel is counted, and impl="cuda" on a CPU 3-D field raises."""
    before = dict(warp_cuda.LAUNCHES)
    vec = torch.from_numpy(to_nchw(field3d(rng, "smooth"))).requires_grad_()
    out = vecint(vec, 7)
    out.sum().backward()
    assert warp_cuda.LAUNCHES == before
    torch.testing.assert_close(out, vecint(vec, 7, impl="torch"), rtol=0,
                               atol=0)
    assert not integrate._chain_takes(vec.detach())
    for n in (0, 7):
        with pytest.raises(ValueError, match="CUDA tensors"):
            vecint(vec.detach(), n, impl="cuda")


def test_chain3d_launchers_refuse_cpu_tensors():
    v = torch.zeros(1, 3, 4, 5, 6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.vecint3d_fwd_cuda(v, 7, save=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.vecint3d_bwd_cuda(torch.zeros(7, 1, 3, 4, 5, 6), v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.VecInt3dFunction.apply(v, 7)


@pytest.mark.parametrize("shape", [(2, 3, 17, 33, 45), (1, 3, 4, 4, 2),
                                   (1, 3, 1, 1, 1)])
@pytest.mark.parametrize("nsteps", [0, 1, 7])
def test_stack3d_pads_each_slot_to_whole_lines(shape, nsteps):
    """The 3-D chain's stack: (nsteps, *shape) fields, each contiguous, a
    whole number of 32-float lines apart, none overlapping the next; the
    backward's check takes it and a contiguous stack, and refuses a stack
    whose fields are not contiguous."""
    vec = torch.zeros(shape)
    steps = warp_cuda.stack3d(vec, nsteps)
    assert steps.shape == (nsteps, *shape)
    assert steps.stride()[1:] == vec.stride()
    assert steps.stride(0) % 32 == 0
    assert vec.numel() <= steps.stride(0) < vec.numel() + 32
    warp_cuda._check_steps(steps, vec, -1)
    warp_cuda._check_steps(torch.zeros(nsteps, *shape), vec, -1)
    with pytest.raises(ValueError, match="steps"):
        warp_cuda._check_steps(
            torch.zeros(nsteps, *shape[:-1], 2 * shape[-1])[..., ::2], vec,
            -1)


SMALL3D = dict(ndims=3, vol_size=24, enc=(8, 16), dec=(16, 16, 8),
               int_steps=7, lambda_smooth=0.01, lr=1e-3)


def test_vxm_engine_3d_entry_points_launch_the_chain(counted_kernels,
                                                     monkeypatch):
    """The 3-D engine on the CPU, every kernel counted: register, eval_step
    and flow_stats launch 1 chain forward (no saved stack) + 1 data warp; a
    train step 1 chain forward (saving its steps) + 1 data warp, 1 chain
    backward + 1 dflow, and no dsrc (the data warp's source needs no
    gradient)."""
    L = counted_kernels
    saves, counted_fwd = [], warp_cuda.vecint3d_fwd_cuda

    def fwd(vec, nsteps, save):
        saves.append(save)
        return counted_fwd(vec, nsteps, save)

    monkeypatch.setattr(warp_cuda, "vecint3d_fwd_cuda", fwd)
    zero = dict.fromkeys(L, 0)
    eng = VxmEngine(VxmConfig(**SMALL3D), device="cpu", seed=3)
    with torch.no_grad():
        eng.netR.flow.weight.mul_(1e5)
    src, tgt = (torch.rand((1, 1, 24, 24, 24),
                           generator=torch.Generator().manual_seed(i))
                for i in range(2))
    _, flow = eng.register(src, tgt)
    assert float(flow.abs().max()) > 0.5
    eng.eval_step(src, tgt)
    eng.flow_stats(src, tgt)
    assert L == dict(zero, **{VF3: 3, F3: 3})
    assert saves == [False] * 3
    L.update(zero)
    metrics = eng.train_step(src, tgt)
    assert L == dict(zero, **{VF3: 1, F3: 1, VB3: 1, D3: 1})
    assert saves == [False] * 3 + [True]
    assert all(np.isfinite(float(v)) for v in metrics.values())
