"""The port's loss tail (``losses/similarity.py``: Tukey's biweight, cross
entropy, NLL, Dice, NMI; ``losses/contrastive.py``; the registry
``losses/registry.py``) and ``metrics/image.py::deepsim`` against the JAX
package's functions on the same numpy inputs, called eagerly.  Tolerance
1e-5 relative in float32.  The class axis is dim 1 in the port and last
in JAX: the inputs are transposed at the boundary."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.losses import contrastive as jcontrastive
from dfmir_tpu.losses import registry as jregistry
from dfmir_tpu.losses import similarity as jsimilarity
from dfmir_tpu.metrics import image as jimage
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.losses import contrastive, registry, similarity
from dfmir_tpu_torch.metrics import image
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

RTOL = 1e-5


def close(mine, ref, rtol=RTOL):
    mine, ref = float(torch.as_tensor(mine).detach()), float(ref)
    assert abs(mine - ref) <= rtol * max(abs(ref), 1e-6), (mine, ref)


def images(rng, shape=(2, 16, 16, 1)):
    """Two NHWC images in [-1, 1] and a binary mask of one channel."""
    a = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    b = np.tanh(a + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape[:-1] + (1,)) > 0.4).astype(np.float32)
    return a, b, mask


def t(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(to_nchw(a))


def onehot(rng, shape, n):
    lab = rng.integers(0, n, shape)
    return np.eye(n, dtype=np.float32)[lab]


@pytest.mark.parametrize("masked", ["none", "mask", "empty"])
def test_tukey_biweight(rng, masked):
    a, b, mask = images(rng)
    b = b * 2.0                   # some errors past c, clamped
    if masked == "empty":
        mask = np.zeros_like(mask)
    m = None if masked == "none" else mask
    ref = jsimilarity.tukey_biweight(a, b, 0.8, None if m is None else m)
    mine = similarity.tukey_biweight(t(a), t(b), 0.8,
                                     None if m is None else t(m))
    close(mine, ref)


@pytest.mark.parametrize("fn", ["cross_entropy_loss", "nll_loss"])
@pytest.mark.parametrize("ndims,masked", [(2, False), (2, True),
                                          (3, True)])
def test_class_losses(rng, fn, ndims, masked):
    spatial = (12, 10) if ndims == 2 else (6, 8, 5)
    logits = (rng.standard_normal((2,) + spatial + (4,)) * 2).astype(
        np.float32)
    target = onehot(rng, (2,) + spatial, 4)
    if fn == "nll_loss":
        logits = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    mask = (rng.random((2,) + spatial + (1,)) > 0.5).astype(np.float32)
    ref = getattr(jsimilarity, fn)(logits, target,
                                   mask if masked else None)
    mine = getattr(similarity, fn)(t(logits), t(target),
                                   t(mask) if masked else None)
    close(mine, ref)


@pytest.mark.parametrize("ndims", [2, 3])
def test_dice_loss(rng, ndims):
    spatial = (16, 12) if ndims == 2 else (6, 8, 10)
    logits = rng.standard_normal((2,) + spatial + (3,)).astype(np.float32)
    pred = np.asarray(jax.nn.softmax(logits, axis=-1))
    target = onehot(rng, (2,) + spatial, 3)
    close(similarity.dice_loss(t(pred), t(target)),
          jsimilarity.dice_loss(pred, target))


@pytest.mark.parametrize("shape", [(2, 16, 16, 1), (1, 8, 10, 12, 1),
                                   (2, 12, 12, 3)])
def test_nmi_loss(rng, shape):
    a, b, _ = images(rng, shape)
    close(similarity.nmi_loss(t(a), t(b)), jsimilarity.nmi_loss(a, b))


@pytest.mark.parametrize("cosine", [True, False])
def test_nt_xent_loss(rng, cosine):
    zi, zj = (rng.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2))
    if not cosine:
        zi, zj = zi * 0.2, zj * 0.2
    ref = jcontrastive.nt_xent_loss(zi, zj, 0.5, cosine)
    mine = contrastive.nt_xent_loss(torch.from_numpy(zi),
                                    torch.from_numpy(zj), 0.5, cosine)
    close(mine, ref)


@pytest.mark.parametrize("penalty", ["l1", "l2"])
def test_smooth_loss_3d(rng, penalty):
    flow = (rng.standard_normal((2, 6, 7, 8, 3)) * 2).astype(np.float32)
    close(contrastive.smooth_loss_3d(t(flow), penalty),
          jcontrastive.smooth_loss_3d(flow, penalty))


def test_registry_names_and_refusal():
    assert list(registry.DICT_LOSSES) == list(jregistry.DICT_LOSSES)
    assert len(registry.DICT_LOSSES) == 13
    with pytest.raises(KeyError) as mine:
        registry.get_loss("SSIM")
    with pytest.raises(KeyError) as ref:
        jregistry.get_loss("SSIM")
    assert str(mine.value) == str(ref.value)


def _disc_weights(rng, shape):
    return rng.standard_normal(shape[1:]).astype(np.float32)


def registry_args(name, rng):
    """(JAX args, port args, kwargs) of one registry entry; a mask as the
    last element of args is passed by keyword."""
    a, b, mask = images(rng)
    if name in ("L1", "L2", "TukeyBiweight"):
        return (a, b, mask), (t(a), t(b), t(mask)), {}
    if name == "NCC":
        a, b, mask = images(rng, (2, 24, 24, 1))
        return (a, b, mask), (t(a), t(b), t(mask)), {}
    if name == "NMI":
        return (a, b), (t(a), t(b)), {}
    if name == "PatchNCE":
        q, k = (rng.standard_normal((2 * 16, 8)).astype(np.float32)
                for _ in range(2))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        k /= np.linalg.norm(k, axis=1, keepdims=True)
        return ((q, k), (torch.from_numpy(q), torch.from_numpy(k)),
                {"batch_size": 2})
    if name == "Grad":
        flow = (rng.standard_normal((2, 12, 12, 2)) * 2).astype(np.float32)
        return (flow,), (t(flow),), {"penalty": "l1"}
    if name in ("CrossEntropy", "NLL", "Dice"):
        logits = rng.standard_normal((2, 10, 10, 4)).astype(np.float32)
        prob = np.asarray({"CrossEntropy": lambda x: x,
                           "NLL": lambda x: jax.nn.log_softmax(x, -1),
                           "Dice": lambda x: jax.nn.softmax(x, -1)}[name](
                               logits))
        target = onehot(rng, (2, 10, 10), 4)
        return (prob, target), (t(prob), t(target)), {}
    if name in ("WGAN", "LSGAN"):
        pred = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
        return (pred, True), (t(pred), True), {}
    raise KeyError(name)


@pytest.mark.parametrize("name", list(jregistry.DICT_LOSSES))
def test_registry_dispatch(rng, name):
    """Every name of DICT_LOSSES gives the port's counterpart of JAX's
    function: the same value on the same inputs (PatchNCE: each patch's)."""
    if name == "GradPenGAN":
        real, fake, _ = images(rng, (2, 8, 8, 2))
        w = _disc_weights(rng, real.shape)
        alpha = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(3), (2, 1, 1, 1)))
        ref = jregistry.get_loss(name)(
            lambda x: jnp.tanh(x * w).sum(axis=(1, 2, 3)), real, fake,
            jax.random.PRNGKey(3))
        wt = t(w[None])
        mine = registry.get_loss(name)(
            lambda x: torch.tanh(x * wt).sum(dim=(1, 2, 3)), t(real),
            t(fake), alpha=torch.from_numpy(np.array(alpha)))
        close(mine, ref)
        return
    jargs, targs, kw = registry_args(name, rng)
    jkw, tkw = dict(kw), dict(kw)
    if name in ("L1", "L2", "TukeyBiweight", "NCC"):
        (*jargs, jkw["mask"]), (*targs, tkw["mask"]) = jargs, targs
    ref = np.asarray(jregistry.get_loss(name)(*jargs, **jkw))
    mine = registry.get_loss(name)(*targs, **tkw).detach().numpy()
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()))


def test_deepsim_with_a_small_random_extractor(rng):
    """deepsim through a small randomly initialised conv extractor of three
    taps, the same weights in both: the port's NCHW maps' cosine over dim
    1 against JAX's over the last axis; a Python float, as JAX's."""
    widths = (1, 4, 8, 8)
    ws = [(rng.standard_normal((3, 3, ci, co)) * 0.5).astype(np.float32)
          for ci, co in zip(widths, widths[1:])]

    def jax_extractor(x):
        feats = []
        for w in ws:
            x = jnp.tanh(jax.lax.conv_general_dilated(
                x, w, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")))
            feats.append(x)
        return feats

    tws = [torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
           for w in ws]

    def port_extractor(x):
        feats = []
        for w in tws:
            x = torch.tanh(torch.nn.functional.conv2d(x, w, padding=1))
            feats.append(x)
        return feats

    a, b, _ = images(rng, (2, 16, 16, 1))
    ref = jimage.deepsim(a, b, jax_extractor)
    mine = image.deepsim(t(a), t(b), port_extractor)
    assert isinstance(mine, float)
    close(mine, ref)
    assert image.deepsim(t(a), t(a), port_extractor) == pytest.approx(1.0)
