"""The port's learned affine registration (``nets/affine_net.py``) against
the JAX package's ``AffineRegistration``, through the weight bridge
(``compat/convert.py::affine_state_from_jax``), at 64^2 and 24^3, called
eagerly (nothing is compiled as a whole).  ``fc_theta`` is set to random
weights (JAX's init is zero: the identity) so that the matrix and every
gradient is non-trivial.  Bars: warped, matrix and flow 1e-5 max-abs; the
gradients of an L2 loss 1e-4 of each leaf's max |g|."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.nets.affine_net import AffineRegistration as JaxAffine
from dfmir_tpu_torch.compat.convert import (affine_state_from_jax,
                                            load_strict, to_nchw, to_nhwc)
from dfmir_tpu_torch.nets.affine_net import AffineRegistration
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

TOL = 1e-5
GRAD_TOL = 1e-4
CASES = {"2d": ((2, 64, 64, 1), (16, 32, 32)),
         "3d": ((1, 24, 24, 24, 1), (8, 16, 16))}


def pair(rng, shape):
    a = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    return a, np.roll(a, 2, axis=1)


def jax_params(case, rng):
    shape, enc = CASES[case]
    nd = len(shape) - 2
    net = JaxAffine(ndims=nd, enc_features=enc)
    x = jnp.zeros(shape, jnp.float32)
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(0), x,
                                               x)["params"])
    fc = params["loc"]["fc_theta"]
    fc["kernel"] = (rng.standard_normal(fc["kernel"].shape) * 0.05).astype(
        np.float32)
    fc["bias"] = (rng.standard_normal(fc["bias"].shape) * 0.02).astype(
        np.float32)
    return net, params


def port_net(case, params=None):
    shape, enc = CASES[case]
    net = AffineRegistration(shape[1:-1], ndims=len(shape) - 2,
                             enc_features=enc,
                             generator=torch.Generator().manual_seed(0))
    if params is not None:
        load_strict(net, affine_state_from_jax(net, params))
    return net


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    rng = np.random.default_rng(4)
    net, params = jax_params(request.param, rng)
    moving, fixed = pair(rng, CASES[request.param][0])

    def l2(p):
        warped, _, _ = net.apply({"params": p}, moving, fixed)
        return jnp.mean(jnp.square(warped - fixed))

    outs = net.apply({"params": params}, moving, fixed)
    grads = jax.tree.map(np.asarray, jax.grad(l2)(params))
    return (request.param, params, moving, fixed,
            [np.asarray(o) for o in outs], grads)


def test_forward_matches_jax(case):
    name, params, moving, fixed, (warped, matrix, flow), _ = case
    net = port_net(name, params)
    out = net(torch.from_numpy(to_nchw(moving)),
              torch.from_numpy(to_nchw(fixed)))
    assert np.abs(matrix - np.eye(*matrix.shape[1:])).max() > 1e-2
    np.testing.assert_allclose(to_nhwc(out[0]), warped, rtol=0, atol=TOL)
    np.testing.assert_allclose(out[1].detach().numpy(), matrix, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(to_nhwc(out[2]), flow, rtol=0, atol=TOL)


def test_l2_gradients_match_jax(case):
    name, params, moving, fixed, _, grads = case
    net = port_net(name, params)
    fixed_t = torch.from_numpy(to_nchw(fixed))
    warped, _, _ = net(torch.from_numpy(to_nchw(moving)), fixed_t)
    (warped - fixed_t).square().mean().backward()
    ref = affine_state_from_jax(net, grads)        # the same layout maps
    mine = dict(net.named_parameters())
    assert set(ref) == set(mine)
    for k, g in ref.items():
        bar = GRAD_TOL * max(float(g.abs().max()), 1e-12)
        err = float((mine[k].grad - g).abs().max())
        assert err <= bar, (k, err, bar)
    assert float(ref["loc.loc_0.weight"].abs().max()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_fresh_net_starts_at_the_identity(rng, name):
    """fc_theta is zero at initialisation, in both: the matrix is the
    identity and the warp returns the moving image."""
    shape, _ = CASES[name]
    moving, fixed = (torch.from_numpy(to_nchw(x)) for x in pair(rng, shape))
    warped, matrix, flow = port_net(name)(moving, fixed)
    nd = len(shape) - 2
    eye = torch.eye(nd, nd + 1).expand(shape[0], nd, nd + 1)
    assert torch.equal(matrix, eye)
    assert torch.equal(warped, moving) and not flow.any()


def test_fc0_permutes_once_at_the_bridge(rng):
    """fc_0 maps flax's channels-last flatten to the port's NCHW flatten:
    the same map, flattened each way, meets the same weights."""
    net = port_net("2d")
    fc = net.loc.fc_0
    c, (h, w) = fc.channels, fc.spatial
    kernel = rng.standard_normal((h * w * c, 32)).astype(np.float32)
    node = {"kernel": kernel, "bias": np.zeros(32, np.float32)}
    sd = fc.flax_state(node)
    fmap = rng.standard_normal((1, c, h, w)).astype(np.float32)
    jax_out = fmap.transpose(0, 2, 3, 1).reshape(1, -1) @ kernel
    port_out = fmap.reshape(1, -1) @ sd["weight"].numpy().T
    np.testing.assert_allclose(port_out, jax_out, rtol=1e-5, atol=1e-5)
