"""The 3-D slice's ops against the JAX package: the nearest upsample and
flow resize at 3-D, windowed NCC (both local-sum paths, 2-D and 3-D, mean
and gaussian windows, masked), ``grad_loss`` at 3-D, the 5-D padding of
the joint model's netG, and 20 training steps of the small engine (the
network and the engine against JAX: ``test_torch_vxm3d.py``).

Bars: resizes, NCC, grad_loss 1e-5 (relative for the losses; the NCC map
max-abs against 1e-5 of its largest value); the padding equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfmir_tpu.losses import grad_loss as jax_grad_loss
from dfmir_tpu.losses import ncc_loss as jax_ncc_loss
from dfmir_tpu.losses.similarity import ncc_map as jax_ncc_map
from dfmir_tpu.nets.layers import pad_nd as jax_pad_nd
from dfmir_tpu.nets.layers import upsample_nearest as jax_upsample_nearest
from dfmir_tpu.ops.integrate import resize_flow as jax_resize_flow
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.losses import grad_loss, ncc_loss, ncc_map
from dfmir_tpu_torch.nets.layers import pad_nd, upsample_nearest
from dfmir_tpu_torch.ops.integrate import resize_flow
from test_torch_joint3d import volumes
from test_torch_vxm3d import S, SMALL, t
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


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



@pytest.mark.parametrize("mode", ["reflect", "replicate", "zero"])
def test_pad_nd_5d_matches_jax(mode):
    x = volumes(4, batch=2)[0][..., :5, :6, :7, :]
    x = np.concatenate([x, -x], axis=-1)
    got = pad_nd(torch.from_numpy(to_nchw(x)), 3, mode)
    ref = jax_pad_nd(jnp.asarray(x), 3, mode)
    assert np.array_equal(to_nhwc(got), np.asarray(ref))
