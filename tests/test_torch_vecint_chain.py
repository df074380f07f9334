"""VecInt's 2-D chain kernels on the CPU: ``VecInt2dFunction`` (one launch
forward, one backward) against the JAX package's ``vecint`` and ``jax.vjp``
of it, with the two chain launchers swapped for counted plain stand-ins, as
on the card they are kernels; the chain's plain backward
(``vecint_bwd_plain``); the dispatch; and the launches a register call and
a train step make, every kernel counted.

Bars: 1e-5 max-abs on the field and its input gradient (float32 rounding of
the same formulas).  Inputs come from a numpy seed; the boundary is
NHWC <-> NCHW.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.ops.integrate import vecint as jax_vecint
from dfmir_tpu_torch import infer
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.ops import integrate, warp_cuda
from dfmir_tpu_torch.ops import warp as warp_mod
from dfmir_tpu_torch.ops.integrate import vecint, vecint_bwd_plain
from dfmir_tpu_torch.ops.warp import warp, warp_bwd_plain
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5
VF, VB = warp_cuda.VECINT_FWD, warp_cuda.VECINT_BWD
F2, B2 = warp_cuda.FWD, warp_cuda.BWD


# -------------------------------------------------- the plain stand-ins

def plain_chain_fwd(vec, nsteps, save):
    """``vecint2d_fwd_cuda``'s and ``vecint3d_fwd_cuda``'s plain version:
    the loop, keeping the field before each step when ``save``."""
    v = vec * (1.0 / (2 ** nsteps))
    steps = []
    for _ in range(nsteps):
        steps.append(v)
        v = v + warp(v, v, impl="torch")
    if not save:
        return v, None
    return v, torch.stack(steps) if steps else vec.new_empty((0, *vec.shape))


def plain_chain_bwd(steps, g):
    """``vecint2d_bwd_cuda``'s and ``vecint3d_bwd_cuda``'s plain version:
    G_k = G_{k+1} + dflow + dsrc of the self-warp of each saved field, last
    step first, then 2^-n."""
    n = steps.shape[0]
    for k in range(n - 1, -1, -1):
        dsrc, dflow = warp_bwd_plain(steps[k], steps[k], g)
        g = g + dflow + dsrc
    return g * (1.0 / (2 ** n))


def _counted(launches, name, fn, calls=None):
    def call(*args, **kwargs):
        launches[name] += 1
        if calls is not None:
            calls.append(kwargs.get("save", args[2] if len(args) > 2
                                    else None))
        return fn(*args, **kwargs)
    return call


@pytest.fixture
def counted_kernels(monkeypatch):
    """Every kernel launcher swapped for its plain version, counted in
    warp_cuda.LAUNCHES, and the dispatch opened to CPU tensors (warps that
    are not nearest, 2-D and 3-D float32 fields for the chains): a model
    then runs on the CPU exactly the launches it makes on the card."""
    monkeypatch.setattr(warp_cuda, "LAUNCHES",
                        dict.fromkeys(warp_cuda.LAUNCHES, 0))
    L = warp_cuda.LAUNCHES
    plain = lambda s, f: warp(s, f, impl="torch")  # noqa: E731
    for attr, name, fn in (
        ("warp2d_cuda", F2, plain),
        ("warp2d_bwd_cuda", B2,
         lambda s, f, g, need_dsrc=True: warp_bwd_plain(s, f, g, need_dsrc)),
        ("vecint2d_fwd_cuda", VF, plain_chain_fwd),
        ("vecint2d_bwd_cuda", VB, plain_chain_bwd),
        ("warp3d_cuda", warp_cuda.FWD3D, plain),
        ("warp3d_bwd_dflow_cuda", warp_cuda.DFLOW3D,
         lambda s, f, g: warp_bwd_plain(s, f, g, need_dsrc=False)[1]),
        ("warp3d_bwd_dsrc_cuda", warp_cuda.DSRC3D,
         lambda f, g: warp_bwd_plain(torch.zeros_like(g), f, g,
                                     need_dflow=False)[0]),
        ("vecint3d_fwd_cuda", warp_cuda.VECINT3D_FWD, plain_chain_fwd),
        ("vecint3d_bwd_cuda", warp_cuda.VECINT3D_BWD, plain_chain_bwd),
    ):
        monkeypatch.setattr(warp_cuda, attr, _counted(L, name, fn))
    monkeypatch.setattr(warp_mod, "_kernel_takes",
                        lambda src, flow, mode: mode != "nearest")
    monkeypatch.setattr(integrate, "_chain_takes",
                        lambda vec: vec.dtype == torch.float32)
    return L


@pytest.fixture
def chain(monkeypatch):
    """Only the chain's launchers swapped (counted, each forward's ``save``
    recorded) and the chain's dispatch opened to CPU float32 fields; the
    single warps stay on the CPU's own path."""
    monkeypatch.setattr(warp_cuda, "LAUNCHES",
                        dict.fromkeys(warp_cuda.LAUNCHES, 0))
    saves = []
    monkeypatch.setattr(warp_cuda, "vecint2d_fwd_cuda",
                        _counted(warp_cuda.LAUNCHES, VF, plain_chain_fwd,
                                 saves))
    monkeypatch.setattr(warp_cuda, "vecint2d_bwd_cuda",
                        _counted(warp_cuda.LAUNCHES, VB, plain_chain_bwd))
    monkeypatch.setattr(integrate, "_chain_takes",
                        lambda vec: vec.dtype == torch.float32)
    return warp_cuda.LAUNCHES, saves


# ------------------------------------------------------------- the fields

def field(rng, kind, shape=(2, 20, 24, 2)):
    """A (B, H, W, 2) velocity field, NHWC: ``smooth`` (a few pixels once
    integrated), ``outside`` (most pixels sample outside the image from the
    first step on) or ``posneg`` (a smooth field and its negation stacked on
    the batch, as the bidirectional model integrates them)."""
    B, H, W, _ = shape
    if kind == "outside":
        v = rng.standard_normal(shape) * 128 * 2 * max(H, W)
        return (v + 128 * 1.5 * H).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 2 * np.pi, H),
                         np.linspace(0, 2 * np.pi, W), indexing="ij")
    base = np.stack([np.sin(yy + xx), np.cos(yy - 0.5 * xx)], -1)
    half = B // 2 if kind == "posneg" else B
    v = (6.0 * base[None] * rng.uniform(0.5, 1.5, (half, 1, 1, 1))
         + 0.3 * rng.standard_normal((half, H, W, 2))).astype(np.float32)
    return np.concatenate([v, -v]) if kind == "posneg" else v


def jax_chain(vec, nsteps, g):
    out, vjp = jax.vjp(lambda v: jax_vecint(v, nsteps), jnp.asarray(vec))
    (dvec,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dvec)


@pytest.mark.parametrize("nsteps", [0, 1, 7])
@pytest.mark.parametrize("kind", ["smooth", "outside", "posneg"])
def test_chain_function_matches_jax(rng, chain, nsteps, kind):
    """The field and its input gradient through VecInt2dFunction: one
    forward and one backward launch, the forward asked to save its steps."""
    launches, saves = chain
    vec = field(rng, kind)
    g = rng.standard_normal(vec.shape).astype(np.float32)
    ref, ref_dvec = jax_chain(vec, nsteps, g)
    v = torch.from_numpy(to_nchw(vec)).requires_grad_()
    out = vecint(v, nsteps)
    out.backward(torch.from_numpy(to_nchw(g)))
    assert launches == dict(dict.fromkeys(launches, 0), **{VF: 1, VB: 1})
    assert saves == [True]
    np.testing.assert_allclose(to_nhwc(out.detach()), ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(to_nhwc(v.grad), ref_dvec, rtol=0, atol=TOL)
    if kind == "outside" and nsteps:
        # most pixels leave the image: their steps add nothing
        assert np.mean(ref == vec / 2 ** nsteps) > 0.5
    if nsteps == 7 and kind != "outside":
        assert np.abs(ref - vec / 128).max() > 0.1   # the chain did deform


def test_chain_without_grad_saves_no_stack(rng, chain):
    """Inference: an input that needs no gradient gets an output without a
    graph, and the forward is asked for no saved stack."""
    launches, saves = chain
    vec = torch.from_numpy(to_nchw(field(rng, "smooth")))
    out = vecint(vec, 7)
    with torch.no_grad():
        out_ng = vecint(vec.clone().requires_grad_(False), 7)
    assert out.grad_fn is None and out_ng.grad_fn is None
    assert saves == [False, False]
    assert launches[VF] == 2 and launches[VB] == 0
    torch.testing.assert_close(out, vecint(vec, 7, impl="torch"), rtol=0,
                               atol=0)


def test_vecint_bwd_plain_matches_jax_vjp(rng):
    """The chain backward's plain version, which the card compares the
    kernel with."""
    vec = field(rng, "posneg")
    g = rng.standard_normal(vec.shape).astype(np.float32)
    _, ref = jax_chain(vec, 7, g)
    dvec = vecint_bwd_plain(torch.from_numpy(to_nchw(vec)), 7,
                            torch.from_numpy(to_nchw(g)))
    np.testing.assert_allclose(to_nhwc(dvec), ref, rtol=0, atol=TOL)


def test_cpu_dispatch_never_counts_a_launch(rng):
    """Without the stand-ins: a CPU field takes the plain loop (2-D and
    3-D), no kernel is counted, and impl="cuda" on a CPU field raises."""
    before = dict(warp_cuda.LAUNCHES)
    vec = torch.from_numpy(to_nchw(field(rng, "smooth"))).requires_grad_()
    out = vecint(vec, 7)
    out.sum().backward()
    vol = torch.randn(1, 3, 6, 7, 8,
                      generator=torch.Generator().manual_seed(0))
    vecint(vol, 7)
    assert warp_cuda.LAUNCHES == before
    torch.testing.assert_close(out, vecint(vec, 7, impl="torch"), rtol=0,
                               atol=0)
    for n in (0, 7):
        with pytest.raises(ValueError, match="CUDA tensors"):
            vecint(vec.detach(), n, impl="cuda")
    with pytest.raises(ValueError, match="nsteps"):
        vecint(vec, -1)


def test_chain_launchers_refuse_cpu_tensors():
    v = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.vecint2d_fwd_cuda(v, 7, save=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        warp_cuda.vecint2d_bwd_cuda(torch.zeros(7, 1, 2, 8, 8), v)


# ------------------------------------------------------- the launch counts

SMALL = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
             vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
             netF_nc=16, num_patches=16)


def test_registration_model_launches(counted_kernels):
    """The 2-D main path on the CPU, every kernel counted: a register call
    launches 1 chain forward + 1 single warp (y_source); a train step 1
    chain forward + 2 single warps (the stacked data warp, `registered`)
    and 1 chain backward + 2 single-warp backwards."""
    L = counted_kernels
    zero = dict.fromkeys(L, 0)
    model = RegistrationModel(RegistrationConfig(**SMALL), device="cpu",
                              generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.netR.flow.weight.mul_(1e5)
    g = torch.Generator().manual_seed(3)
    a, b = torch.tanh(2 * torch.randn(2, 2, 1, 64, 64, generator=g))
    out = infer.register_pair_outputs(model, a, b)
    assert L == dict(zero, **{VF: 1, F2: 1})
    assert float(out["pos_flow"].abs().max()) > 0.5
    L.update(zero)
    metrics = model.train_step(a, b, 2e-4,
                               generator=torch.Generator().manual_seed(4))
    assert L == dict(zero, **{VF: 1, F2: 2, VB: 1, B2: 2})
    assert all(np.isfinite(float(v)) for v in metrics.values())
