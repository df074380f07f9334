"""The 3-D slice against the JAX package: VxmDense at ndims=3, the resizes,
windowed NCC (both local-sum paths, 2-D and 3-D), ``grad_loss`` and the
VoxelMorph engine (``VxmEngine``), with the JAX engine's init_state
weights carried over by ``load_jax_vxm_params``.

Sizes are the JAX suite's (24^3, ``tests/test_vxm3d.py``'s SMALL config);
inputs come from a numpy seed.  Bars:
- VxmDense outputs: 1e-4 max-abs (float32 convs summed in another order);
- resizes, NCC, grad_loss: 1e-5 (relative for the losses; the NCC map
  max-abs against 1e-5 of its largest value);
- the engine's metrics: 1e-4 relative; gradients: within 1e-3 of each
  tensor's max |g|; one train_step: the 2-D step's rule for first-step
  Adam sign artefacts (tests/test_torch_train.py).
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.engine.vxm_engine import VxmEngine as JaxVxmEngine
from dfmir_tpu.losses import grad_loss as jax_grad_loss
from dfmir_tpu.losses import ncc_loss as jax_ncc_loss
from dfmir_tpu.losses.similarity import ncc_map as jax_ncc_map
from dfmir_tpu.nets import VxmDense as JaxVxmDense
from dfmir_tpu.nets.layers import upsample_nearest as jax_upsample_nearest
from dfmir_tpu.ops.integrate import resize_flow as jax_resize_flow
from dfmir_tpu_torch.compat.convert import (load_jax_vxm_params,
                                            netR_state_from_jax, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.losses import grad_loss, ncc_loss, ncc_map
from dfmir_tpu_torch.nets.layers import upsample_nearest
from dfmir_tpu_torch.nets.vxm import VxmDense
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.integrate import resize_flow
from dfmir_tpu_torch.ops.warp import warp

# every kernel swapped for its counted plain version
from test_torch_vecint_chain import counted_kernels  # noqa: F401

S = 24
SMALL = dict(ndims=3, vol_size=S, enc=(8, 16), dec=(16, 16, 8), int_steps=4,
             lambda_smooth=0.01, lr=1e-3)
NB = (SMALL["enc"], SMALL["dec"])
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform
GRAD_ENV = 1e-3
LR = 1e-3


def t(a):
    return torch.from_numpy(to_nchw(a))


def numpy_tree(params):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), params)


def volumes(seed, n=2, size=S):
    """Textured volumes (B=1, NDHWC): smooth waves with a little noise."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.linspace(0, 2 * np.pi, size)] * 3,
                             indexing="ij"))
    out = []
    for _ in range(n):
        a, b, c = rng.uniform(0.5, 2.0, 3)
        ph = rng.uniform(0, np.pi, 3)
        v = (np.sin(a * g[0] + ph[0]) * np.cos(b * g[1] + ph[1])
             * np.sin(c * g[2] + ph[2])
             + 0.1 * rng.standard_normal((size,) * 3))
        out.append(v.astype(np.float32)[None, ..., None])
    return out


@pytest.fixture(scope="module")
def jax_params():
    """The JAX engine's init_state weights, flow head scaled to deform."""
    eng = JaxVxmEngine(JaxVxmConfig(**SMALL))
    params = numpy_tree(eng.init_state(jax.random.PRNGKey(0)).params)
    params["flow"]["kernel"] *= FLOW_GAIN
    return params


# ------------------------------------------------------------ nets and ops

@pytest.mark.parametrize("bidir,registration", [
    (False, True), (False, False), (True, False)])
def test_vxm_dense_3d(jax_params, bidir, registration):
    """The registration branch, the unidir and the batch-stacked bidir
    training branches, each with return_preint."""
    jr = JaxVxmDense(ndims=3, nb_features=NB, int_steps=4, int_downsize=2,
                     bidir=bidir)
    tr = VxmDense(3, NB, 4, 2, bidir,
                  generator=torch.Generator().manual_seed(0)).eval()
    tr.load_state_dict(netR_state_from_jax(jax_params, *NB), strict=True)
    src, tgt = volumes(1)
    ref = jr.apply({"params": jax_params}, jnp.asarray(src),
                   jnp.asarray(tgt), registration=registration,
                   return_preint=True)
    with torch.no_grad():
        out = tr(t(src), t(tgt), registration=registration,
                 return_preint=True)
    assert len(out) == len(ref) == (3 if registration or not bidir else 4)
    assert out[-1].shape == (1, 3, S // 2, S // 2, S // 2)
    assert np.max(np.abs(np.asarray(ref[1 if registration else -2]))) > 0.5
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0,
                                   atol=1e-4)


def test_upsample_and_resize_3d(rng):
    x = rng.standard_normal((2, 5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        to_nhwc(upsample_nearest(t(x))),
        np.asarray(jax_upsample_nearest(jnp.asarray(x))))
    flow = (rng.standard_normal((1, 12, 10, 8, 3)) * 3).astype(np.float32)
    for factor in (0.5, 2.0):
        ref = np.asarray(jax_resize_flow(jnp.asarray(flow), factor))
        np.testing.assert_allclose(to_nhwc(resize_flow(t(flow), factor)),
                                   ref, rtol=0, atol=1e-5)


NCC_CASES = [
    # ndims, kernel_type, kernel_var, method, masked
    (3, "mean", [5, 5, 5], "integral", False),
    (3, "mean", [5, 5, 5], "conv", False),
    (3, "mean", None, "auto", True),         # 9^3, integral, masked
    (3, "mean", [4, 4, 4], "auto", False),   # even: conv, n+1 outputs
    (3, "gaussian", [1, 1, 1], "auto", False),
    (2, "mean", [9, 9], "integral", True),
    (2, "mean", [9, 9], "conv", False),
    (2, "mean", [6, 6], "auto", False),
    (2, "gaussian", [3, 3], "conv", False),
]


@pytest.mark.parametrize("nd,kernel_type,kernel_var,method,masked",
                         NCC_CASES)
def test_ncc_matches_jax(rng, nd, kernel_type, kernel_var, method, masked):
    spatial = (14, 16, 12) if nd == 3 else (40, 36)
    I = rng.random((2,) + spatial + (1,)).astype(np.float32)
    J = (0.6 * I + 0.4 * rng.random(I.shape)).astype(np.float32)
    kw = dict(kernel_var=kernel_var, kernel_type=kernel_type, method=method)
    ref = np.asarray(jax_ncc_map(jnp.asarray(I), jnp.asarray(J), **kw))
    cc = to_nhwc(ncc_map(t(I), t(J), **kw))
    assert cc.shape == ref.shape
    np.testing.assert_allclose(cc, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    mask = (rng.random(I.shape) > 0.3) if masked else None
    ref_loss = float(jax_ncc_loss(
        jnp.asarray(I), jnp.asarray(J),
        mask=None if mask is None else jnp.asarray(mask), **kw))
    loss = float(ncc_loss(t(I), t(J),
                          mask=None if mask is None else t(mask), **kw))
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    if masked:
        empty = float(ncc_loss(t(I), t(J), mask=t(np.zeros_like(mask)),
                               **kw))
        assert empty == 0.0


def test_ncc_integral_needs_a_mean_window(rng):
    I = t(rng.random((1, 8, 8, 8, 1)).astype(np.float32))
    with pytest.raises(ValueError, match="mean kernel"):
        ncc_map(I, I, kernel_type="gaussian", method="integral")


@pytest.mark.parametrize("penalty", ["l1", "l2"])
def test_grad_loss_3d(rng, penalty):
    flow = (rng.standard_normal((2, 10, 12, 8, 3)) * 2).astype(np.float32)
    ref = float(jax_grad_loss(jnp.asarray(flow), penalty=penalty))
    assert abs(float(grad_loss(t(flow), penalty)) - ref) <= 1e-5 * ref


# ------------------------------------------------------------------ engine

def port_engine(params, **overrides):
    eng = VxmEngine(VxmConfig(**dict(SMALL, **overrides)), device="cpu")
    load_jax_vxm_params(eng, params)
    return eng


@pytest.fixture(scope="module")
def jax_run(jax_params):
    """The JAX engine on one pair: its gradients and metrics, its state
    after one train_step at LR, and flow_stats."""
    eng = JaxVxmEngine(JaxVxmConfig(**SMALL))
    src, tgt = volumes(2)
    jp = jax.tree.map(jnp.asarray, jax_params)
    grads, metrics = jax.grad(eng._loss_fn, has_aux=True)(
        jp, jnp.asarray(src), jnp.asarray(tgt))
    stats = eng.flow_stats(jp, jnp.asarray(src), jnp.asarray(tgt))
    state = eng.init_state(jax.random.PRNGKey(0))
    state = state.replace(params=jp)
    new_state, step_metrics = eng.train_step(state, jnp.asarray(src),
                                             jnp.asarray(tgt), LR)
    return dict(src=src, tgt=tgt, grads=numpy_tree(grads),
                metrics={k: float(v) for k, v in metrics.items()},
                stats={k: float(v) for k, v in stats.items()},
                new_params=numpy_tree(new_state.params),
                step_total=float(step_metrics["total"]))


def test_loss_fn_and_gradients_match_jax(jax_params, jax_run):
    r = jax_run
    eng = port_engine(jax_params)
    total, metrics = eng.loss_fn(t(r["src"]), t(r["tgt"]))
    assert set(metrics) == set(r["metrics"]) == {"sim", "smooth", "total"}
    for k, v in metrics.items():
        v = float(v.detach())
        assert abs(v - r["metrics"][k]) <= 1e-4 * abs(r["metrics"][k]), (
            k, v, r["metrics"][k])
    total.backward()
    ref = netR_state_from_jax(r["grads"], *NB)
    for name, p in eng.netR.named_parameters():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        err = float((p.grad - ref[name]).abs().max())
        assert err <= GRAD_ENV * scale, (name, err, scale)


def test_train_step_matches_jax(jax_params, jax_run):
    r = jax_run
    eng = port_engine(jax_params)
    before = {k: p.detach().clone() for k, p in eng.netR.named_parameters()}
    metrics = eng.train_step(t(r["src"]), t(r["tgt"]), LR)
    assert eng.step == 1
    assert abs(float(metrics["total"]) - r["step_total"]) <= 1e-4 * abs(
        r["step_total"])
    ref = netR_state_from_jax(r["new_params"], *NB)
    grads = netR_state_from_jax(r["grads"], *NB)
    noise = GRAD_ENV * max(float(g.abs().max()) for g in grads.values())
    total = mismatched = 0
    for name, p in eng.netR.named_parameters():
        p, q = p.detach(), ref[name]
        assert not torch.equal(p, before[name]), name
        mism = ~torch.isclose(p, q, atol=1e-5, rtol=1e-4)
        total += p.numel()
        mismatched += int(mism.sum())
        if mism.any():
            assert float((p - q)[mism].abs().max()) <= 2.05 * LR, name
            assert float(grads[name][mism].abs().max()) <= noise, name
    assert mismatched < 0.01 * total, (mismatched, total)


def test_register_and_flow_stats_match_jax(jax_params, jax_run):
    r = jax_run
    eng = port_engine(jax_params)
    y, flow = eng.register(t(r["src"]), t(r["tgt"]))
    assert y.shape == (1, 1, S, S, S) and flow.shape == (1, 3, S, S, S)
    stats = eng.flow_stats(t(r["src"]), t(r["tgt"]))
    assert set(stats) == set(r["stats"]) == {"fold", "jac_min", "jac_max",
                                             "jac_mean", "flow_max"}
    assert r["stats"]["flow_max"] > 0.5
    for k, v in stats.items():
        assert v.ndim == 0
        assert abs(float(v) - r["stats"][k]) <= 1e-4 * max(
            1.0, abs(r["stats"][k])), k
    metrics = eng.eval_step(t(r["src"]), t(r["tgt"]))
    for k, v in metrics.items():
        assert abs(float(v) - r["metrics"][k]) <= 1e-4 * abs(r["metrics"][k])
    assert all(p.grad is None for p in eng.netR.parameters())


def test_bidir_mse_eval_matches_jax(jax_params):
    cfg = dict(SMALL, bidir=True, image_loss="mse")
    src, tgt = volumes(3)
    ref = JaxVxmEngine(JaxVxmConfig(**cfg)).eval_step(
        jax.tree.map(jnp.asarray, jax_params), jnp.asarray(src),
        jnp.asarray(tgt))
    eng = port_engine(jax_params, bidir=True, image_loss="mse")
    metrics = eng.eval_step(t(src), t(tgt))
    for k, v in metrics.items():
        assert abs(float(v) - float(ref[k])) <= 1e-4 * abs(float(ref[k])), k


def test_remat_equals_no_remat(jax_params):
    src, tgt = (t(v) for v in volumes(4))
    out = {}
    for remat in (False, True):
        eng = port_engine(jax_params, remat=remat)
        total, metrics = eng.loss_fn(src, tgt)
        total.backward()
        out[remat] = ({k: float(v.detach()) for k, v in metrics.items()},
                      [p.grad for p in eng.netR.parameters()])
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_training_reduces_loss():
    """As the JAX suite's test_training_reduces_loss: 20 steps of the SMALL
    config (mse, lr 1e-3) on one pair of spheres halve the loss."""
    g = np.stack(np.meshgrid(*[np.arange(S)] * 3, indexing="ij"))

    def sphere(center):
        d = np.sqrt(((g - np.asarray(center)[:, None, None, None]) ** 2
                     ).sum(0))
        return torch.from_numpy(
            (np.clip(6 - d, 0, 3) / 3.0).astype(np.float32))[None, None]

    eng = VxmEngine(VxmConfig(**dict(SMALL, image_loss="mse")),
                    device="cpu", seed=0)
    x, y = sphere((12, 12, 12)), sphere((14, 10, 12))
    totals = [float(eng.train_step(x, y)["total"]) for _ in range(20)]
    assert np.isfinite(totals[-1])
    assert totals[-1] < totals[0] * 0.5, totals


# ------------------------------------------------- the path, kernel by kernel

@pytest.mark.parametrize("ndims", [3, 2])
def test_engine_launches_per_call(jax_params, counted_kernels, ndims):
    """register: 1 chain forward + 1 data warp, at 2-D and 3-D; a train
    step: 1 + 1 forward and 1 + 1 backward (chain, data warp; no dsrc: the
    data warp's source needs no gradient); remat runs the forward
    twice."""
    L = counted_kernels
    cfg = dict(SMALL, ndims=ndims, int_steps=7)
    spatial = (1, 1) + (S,) * ndims
    src, tgt = (torch.rand(spatial, generator=torch.Generator().manual_seed(i))
                for i in range(2))
    eng = VxmEngine(VxmConfig(**cfg), device="cpu")
    f3, d3, s3 = warp_cuda.FWD3D, warp_cuda.DFLOW3D, warp_cuda.DSRC3D
    f2, b2 = warp_cuda.FWD, warp_cuda.BWD
    vf, vb = ((warp_cuda.VECINT3D_FWD, warp_cuda.VECINT3D_BWD) if ndims == 3
              else (warp_cuda.VECINT_FWD, warp_cuda.VECINT_BWD))
    fwd, bwd = (f3, d3) if ndims == 3 else (f2, b2)
    zero = dict.fromkeys(L, 0)
    reg = {vf: 1, fwd: 1}
    step = {vf: 1, fwd: 1, vb: 1, bwd: 1}
    eng.register(src, tgt)
    assert L == dict(zero, **reg)
    L.update(zero)
    metrics = eng.train_step(src, tgt)
    assert L == dict(zero, **step)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if ndims == 3:
        L.update(zero)
        VxmEngine(VxmConfig(**dict(cfg, remat=True)),
                  device="cpu").train_step(src, tgt)
        assert L == dict(zero, **dict(step, **{vf: 2, f3: 2}))
        assert L[s3] == 0


def test_bfloat16_config_computes_what_jax_computes(jax_params, jax_run):
    """--compute_dtype bfloat16 on the 3-D engine: JAX's VxmEngine never
    hands the field to its VxmDense (the same module as at float32), so
    it computes in float32, and so does the port's."""
    cfg = dict(SMALL, compute_dtype="bfloat16")
    assert JaxVxmEngine(JaxVxmConfig(**cfg)).netR == \
        JaxVxmEngine(JaxVxmConfig(**SMALL)).netR
    eng = port_engine(jax_params, compute_dtype="bfloat16")
    assert eng.cfg.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in eng.netR.parameters())
    r = jax_run
    _, metrics = eng.loss_fn(t(r["src"]), t(r["tgt"]))
    for k, v in metrics.items():
        assert v.dtype == torch.float32
        assert abs(float(v.detach()) - r["metrics"][k]) <= 1e-4 * abs(
            r["metrics"][k]), k


def test_config_and_refusals(jax_params):
    opt = argparse.Namespace(ndims=3, vol_size=32, enc="4,8", dec="8,4,4",
                             lr=2e-4, name="not a field")
    cfg = VxmConfig.from_opt(opt)
    assert (cfg.enc, cfg.dec, cfg.vol_size, cfg.lr) == ((4, 8), (8, 4, 4), 32,
                                                         2e-4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxVxmConfig.from_opt(opt))
    eng = VxmEngine(VxmConfig(enc=(), dec=()), device="cpu")
    assert eng.cfg.enc == (16, 32, 32, 32)
    assert eng.cfg.dec == (32, 32, 32, 32, 32, 16, 16)
    eng = VxmEngine(VxmConfig(**SMALL), device="cpu")
    short = dict(jax_params)
    short.pop("flow")
    with pytest.raises(KeyError):
        load_jax_vxm_params(eng, short)
    deeper = VxmEngine(VxmConfig(**dict(SMALL, enc=(8, 16, 16))),
                       device="cpu")
    with pytest.raises(KeyError):
        load_jax_vxm_params(deeper, jax_params)
