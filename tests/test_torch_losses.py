"""The port's 2-D step losses and netF against the JAX package on the same
numpy inputs: patch_nce_loss, masked_l1 / masked_l2 / mse_loss,
smoothness_loss, grad_loss, l2_normalize and PatchSampleF (weights carried
over by netF_state_from_jax, the same patch ids).  Tolerance 1e-5 max-abs
(float32 rounding of the same formulas)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu import losses as jlosses
from dfmir_tpu.nets.patch_sample import PatchSampleF as JaxPatchSampleF
from dfmir_tpu.nets.patch_sample import l2_normalize as jax_l2_normalize
from dfmir_tpu_torch import losses
from dfmir_tpu_torch.compat.convert import netF_state_from_jax, to_nchw
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF, l2_normalize

TOL = 1e-5


def close(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=tol)


def unit_rows(rng, n, dim):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("all_negatives", [False, True])
def test_patch_nce_loss(rng, batch, all_negatives):
    P, dim = 16, 32
    q = unit_rows(rng, batch * P, dim)
    k = unit_rows(rng, batch * P, dim)
    ref = jlosses.patch_nce_loss(jnp.asarray(q), jnp.asarray(k), nce_T=0.07,
                                 batch_size=batch,
                                 all_negatives_from_minibatch=all_negatives)
    out = losses.patch_nce_loss(torch.from_numpy(q), torch.from_numpy(k),
                                nce_T=0.07, batch_size=batch,
                                all_negatives_from_minibatch=all_negatives)
    assert out.shape == (batch * P,)
    close(out, ref)


def test_patch_nce_loss_detaches_keys(rng):
    q = torch.from_numpy(unit_rows(rng, 8, 4)).requires_grad_()
    k = torch.from_numpy(unit_rows(rng, 8, 4)).requires_grad_()
    losses.patch_nce_loss(q, k).sum().backward()
    assert q.grad is not None and k.grad is None


@pytest.mark.parametrize("mask_kind", ["none", "random", "empty"])
@pytest.mark.parametrize("name", ["masked_l1", "masked_l2"])
def test_masked_losses(rng, name, mask_kind):
    a = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    b = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    mask = {"none": None, "random": rng.random((2, 16, 16, 1)) > 0.5,
            "empty": np.zeros((2, 16, 16, 1), bool)}[mask_kind]
    ref = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b),
                                 None if mask is None else jnp.asarray(mask))
    out = getattr(losses, name)(
        torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b)),
        None if mask is None else torch.from_numpy(to_nchw(mask)))
    close(out, ref)
    if mask_kind == "empty":
        assert float(out) == 0.0


def test_mse_loss(rng):
    a, b = rng.standard_normal((2, 2, 8, 8, 1)).astype(np.float32)
    close(losses.mse_loss(torch.from_numpy(to_nchw(a)),
                          torch.from_numpy(to_nchw(b))),
          jlosses.mse_loss(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("spatial", [(16, 12), (6, 8, 10)])
def test_smoothness_loss(rng, spatial):
    flow = (rng.standard_normal((2,) + spatial + (len(spatial),)) * 2).astype(
        np.float32)
    close(losses.smoothness_loss(torch.from_numpy(to_nchw(flow))),
          jlosses.smoothness_loss(jnp.asarray(flow)))


@pytest.mark.parametrize("penalty", ["l1", "l2"])
@pytest.mark.parametrize("spatial", [(16, 12), (6, 8, 10)])
def test_grad_loss(rng, penalty, spatial):
    flow = (rng.standard_normal((2,) + spatial + (len(spatial),)) * 2).astype(
        np.float32)
    close(losses.grad_loss(torch.from_numpy(to_nchw(flow)), penalty),
          jlosses.grad_loss(jnp.asarray(flow), penalty))


def test_l2_normalize(rng):
    x = rng.standard_normal((10, 7)).astype(np.float32)
    x[3] = 0.0                                   # the eps keeps it finite
    close(l2_normalize(torch.from_numpy(x)), jax_l2_normalize(jnp.asarray(x)))


@pytest.mark.parametrize("use_mlp", [True, False])
def test_patch_sample_f(rng, use_mlp):
    """Same weights, same patch ids: the same (B*P, nc) embeddings; the
    reference's parameter names."""
    dims, nc, P = (3, 8, 16), 16, 12
    feats = [rng.standard_normal((2, 10 + i, 9, c)).astype(np.float32)
             for i, c in enumerate(dims)]
    ids = [rng.permutation(f.shape[1] * f.shape[2])[:P] for f in feats]
    jf = JaxPatchSampleF(feature_dims=dims, nc=nc, use_mlp=use_mlp)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = jf.init(jax.random.PRNGKey(0), jfeats, P,
                        [jnp.asarray(i) for i in ids])
    ref, _ = jf.apply(variables, jfeats, P, [jnp.asarray(i) for i in ids])

    tf = PatchSampleF(dims, nc=nc, use_mlp=use_mlp,
                      generator=torch.Generator().manual_seed(0))
    params = jax.tree.map(np.asarray, variables.get("params", {}))
    sd = netF_state_from_jax(params)
    assert set(sd) == set(tf.state_dict())
    if use_mlp:
        assert "mlp_1.0.weight" in sd and "mlp_1.2.bias" in sd
    tf.load_state_dict(sd, strict=True)
    out, out_ids = tf([torch.from_numpy(to_nchw(f)) for f in feats], P,
                      [torch.from_numpy(i) for i in ids])
    for o, r, i, want in zip(out, ref, out_ids, ids):
        assert o.shape == (2 * P, nc if use_mlp else r.shape[-1])
        close(o, r)
        np.testing.assert_array_equal(i.numpy(), want)


def test_patch_sample_f_draws_ids_from_generator(rng):
    tf = PatchSampleF((4,), nc=8, generator=torch.Generator().manual_seed(0))
    feat = [torch.from_numpy(rng.standard_normal((1, 4, 6, 6)).astype(
        np.float32))]
    _, ids1 = tf(feat, 5, generator=torch.Generator().manual_seed(7))
    _, ids2 = tf(feat, 5, generator=torch.Generator().manual_seed(7))
    assert ids1[0].shape == (5,) and len(set(ids1[0].tolist())) == 5
    assert torch.equal(ids1[0], ids2[0])
    with pytest.raises(ValueError, match="generator"):
        tf(feat, 5)
    all_out, all_ids = tf(feat, 0)
    assert all_out[0].shape == (36, 8) and all_ids == [None]
