"""The port's ResnetGenerator and VxmDense against the JAX modules, with
weights from a JAX ``init`` carried over by the weight bridge
(dfmir_tpu_torch.compat.convert).  Tolerance 1e-3 max-abs, the end-to-end
parity bar (PARITY.json)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.nets import ResnetGenerator as JaxResnetGenerator
from dfmir_tpu.nets import VxmDense as JaxVxmDense
from dfmir_tpu_torch.compat.convert import (netG_state_from_jax,
                                            netR_state_from_jax, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from dfmir_tpu_torch.nets.vxm import VxmDense
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-3
H = W = 64
NB = ((8, 16, 16, 16), (16, 16, 16, 16, 16, 8, 8))
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform


def numpy_tree(params):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), params)


def load(net, sd):
    full = net.state_dict()
    assert set(sd) <= set(full)
    full.update(sd)
    net.load_state_dict(full, strict=True)


@pytest.fixture(scope="module")
def generators():
    jg = JaxResnetGenerator(input_nc=1, output_nc=1, ngf=8, n_blocks=4)
    params = numpy_tree(jg.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, H, W, 1)))["params"])
    tg = ResnetGenerator(1, 1, ngf=8, n_blocks=4,
                         generator=torch.Generator().manual_seed(0)).eval()
    load(tg, netG_state_from_jax(params, tg.specs))
    return jg, {"params": params}, tg


def test_netG_forward(rng, generators):
    jg, variables, tg = generators
    x = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    ref = np.asarray(jg.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = to_nhwc(tg(torch.from_numpy(to_nchw(x))))
    assert np.std(ref) > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_netG_encode_only_taps(rng, generators):
    jg, variables, tg = generators
    x = rng.standard_normal((1, H, W, 1)).astype(np.float32)
    layers = (0, 4, 8, 12, 14)
    ref = jg.apply(variables, jnp.asarray(x), layers=layers, encode_only=True)
    with torch.no_grad():
        out = tg(torch.from_numpy(to_nchw(x)), layers=layers, encode_only=True)
    assert len(out) == len(ref) == len(layers)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def vxms():
    jr = JaxVxmDense(ndims=2, nb_features=NB, int_steps=7, int_downsize=2,
                     bidir=True)
    z = jnp.zeros((1, H, W, 1))
    params = numpy_tree(jr.init(jax.random.PRNGKey(1), z, z)["params"])
    params["flow"]["kernel"] *= FLOW_GAIN
    tr = VxmDense(2, NB, 7, 2, True,
                  generator=torch.Generator().manual_seed(0)).eval()
    load(tr, netR_state_from_jax(params, *NB))
    return jr, {"params": params}, tr


@pytest.mark.parametrize("registration", [True, False])
def test_vxm_dense(rng, vxms, registration):
    """registration=True (the pos chain) and the batch-stacked bidir
    training branch (y_source, y_target, pos_flow)."""
    jr, variables, tr = vxms
    src = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    tgt = rng.standard_normal((2, H, W, 1)).astype(np.float32)
    ref = jr.apply(variables, jnp.asarray(src), jnp.asarray(tgt),
                   registration=registration)
    with torch.no_grad():
        out = tr(torch.from_numpy(to_nchw(src)), torch.from_numpy(to_nchw(tgt)),
                 registration=registration)
    assert len(out) == len(ref) == (2 if registration else 3)
    assert np.max(np.abs(np.asarray(ref[-1]))) > 0.5   # pos_flow deforms
    for o, r in zip(out, ref):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0, atol=TOL)

