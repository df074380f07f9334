"""FastCUT's flip equivariance (``--CUT_mode FastCUT``: flip_equivariance,
nce_idt off, lambda_NCE 10): the port's RegistrationModel.loss_fn /
train_step against the JAX RegistrationModel._loss_fn / train_step at
each value of the coin, with the JAX model's init_state weights carried
over by load_jax_params, the coin the JAX key draws passed as ``flip``,
and the patch ids of JAX's re-encode branch (its keys by pair index).

Bars (test_torch_train.py's):
- metrics of one loss_fn: 1e-4 relative;
- gradients of G, F and R: max-abs difference <= GRAD_ENV (1e-3) times
  the network's max |g|;
- one whole train_step: the first-step Adam sign-artefact rule (a
  component whose gradient lies inside the noise band may move by up to
  2.05 lr the other way; > 99% of components within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from test_torch_train import (CFG, FLOW_GAIN, GRAD_ENV, LR, jax_flip_coin,
                              jax_pair_patch_ids, named_params, port_tree,
                              tap_locations)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

FASTCUT = dict(CFG, flip_equivariance=True, nce_idt=False, lambda_NCE=10.0)


def key_with_coin(coin: bool):
    """The first PRNGKey(n), n >= 11, whose step draws ``coin``."""
    for n in range(11, 100):
        key = jax.random.PRNGKey(n)
        if jax_flip_coin(key) == coin:
            return key
    raise AssertionError("no key draws the coin")


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(JaxConfig(**FASTCUT))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**FASTCUT), device="cpu")
        load_jax_params(tm, params)
        return tm

    n_locs = tap_locations(port_model(), A)
    jp = jax.tree.map(jnp.asarray, params)
    grad_fn = jax.jit(jax.grad(
        lambda p, k: jm._loss_fn(p, jnp.asarray(a), jnp.asarray(b), k),
        has_aux=True))
    cases = {}
    for coin in (False, True):
        key = key_with_coin(coin)
        grads, (metrics, aux) = grad_fn(jp, key)
        cases[coin] = dict(
            key=key, ids=jax_pair_patch_ids(key, n_locs,
                                            FASTCUT["num_patches"], 2),
            grads=jax.tree.map(np.asarray, grads), metrics=metrics,
            aux=aux)
    return dict(jm=jm, params=params, a=a, b=b, A=A, B=Bt, cases=cases,
                port_model=port_model)


@pytest.mark.parametrize("coin", [False, True])
def test_loss_fn_matches_jax(setup, coin):
    s = setup
    case = s["cases"][coin]
    tm = s["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(s["A"], s["B"], patch_ids=case["ids"],
                                     flip=coin)
    ref = case["metrics"]
    assert set(metrics) == set(ref) == {"G", "NCE", "R", "smooth", "local",
                                        "total"}
    assert float(aux["pos_flow"].abs().max()) > 0.5      # the warps deform
    for k, v in metrics.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r), (k, float(v), r)
    # the flipped fake_B is what `registered` warps, as in JAX
    np.testing.assert_allclose(
        aux["fake_B"].numpy(), to_nchw(case["aux"]["fake_B"]), rtol=0,
        atol=1e-4)


def test_the_coins_differ(setup):
    """The two coins give different losses, so each case tests its own
    branch; with the coin unset, it is drawn from the step's generator."""
    s = setup
    t = {c: float(s["cases"][c]["metrics"]["total"]) for c in (False, True)}
    assert t[False] != t[True]
    tm = s["port_model"]()
    seen = set()
    with torch.no_grad():
        for seed in range(8):
            _, m, aux = tm.loss_fn(
                s["A"], s["B"], patch_ids=s["cases"][True]["ids"],
                generator=torch.Generator().manual_seed(seed))
            seen.add(round(float(m["total"]), 4))
    assert len(seen) == 2


@pytest.mark.parametrize("coin", [False, True])
def test_gradients_match_jax(setup, coin):
    s = setup
    case = s["cases"][coin]
    ref = port_tree(s["port_model"](), case["grads"])
    tm = s["port_model"]()
    total, _, _ = tm.loss_fn(s["A"], s["B"], patch_ids=case["ids"],
                             flip=coin)
    total.backward()
    for net, params in named_params(tm).items():
        assert set(params) == set(ref[net]), net
        scale = max(float(g.abs().max()) for g in ref[net].values())
        assert scale > 0, net
        for name, p in params.items():
            err = float((p.grad - ref[net][name]).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)


@pytest.mark.parametrize("coin", [False, True])
def test_train_step_matches_jax(setup, coin):
    s = setup
    jm, case = s["jm"], s["cases"][coin]
    grads = port_tree(s["port_model"](), case["grads"])
    jp = jax.tree.map(jnp.asarray, s["params"])
    state = TrainState(params=jp, opt_state=jm.tx.init(jp),
                       step=jnp.zeros((), jnp.int32))
    new_state, jmetrics = jm.train_step(state, jnp.asarray(s["a"]),
                                        jnp.asarray(s["b"]), case["key"],
                                        jnp.float32(LR))
    ref = port_tree(s["port_model"](), jax.tree.map(np.asarray,
                                                    new_state.params))

    tm = s["port_model"]()
    before = {net: {k: p.detach().clone() for k, p in ps.items()}
              for net, ps in named_params(tm).items()}
    metrics = tm.train_step(s["A"], s["B"], LR, patch_ids=case["ids"],
                            flip=coin)
    assert abs(float(metrics["total"]) - float(jmetrics["total"])) <= (
        1e-4 * abs(float(jmetrics["total"])))

    total = mismatched = 0
    for net, params in named_params(tm).items():
        noise = GRAD_ENV * max(float(g.abs().max())
                               for g in grads[net].values())
        moved = False
        for name, p in params.items():
            p, r = p.detach(), ref[net][name]
            moved |= not torch.equal(p, before[net][name])
            mism = ~torch.isclose(p, r, atol=1e-5, rtol=1e-4)
            total += p.numel()
            mismatched += int(mism.sum())
            if mism.any():
                assert float((p - r)[mism].abs().max()) <= 2.05 * LR, name
                assert float(grads[net][name][mism].abs().max()) <= noise, (
                    f"{name}: sign flip at a resolvable gradient")
        assert moved, net
    assert mismatched < 0.01 * total, (mismatched, total)


def test_eval_paths_take_the_coin(setup):
    """eval_step and compute_visuals run the same flipped loss (without an
    update), and register never flips."""
    s = setup
    case = s["cases"][True]
    tm = s["port_model"]()
    metrics, aux = tm.eval_step(s["A"], s["B"], patch_ids=case["ids"],
                                flip=True)
    for k, v in metrics.items():
        r = float(case["metrics"][k])
        assert abs(float(v) - r) <= 1e-4 * abs(r), k
    visuals, _ = tm.compute_visuals(s["A"], s["B"], patch_ids=case["ids"],
                                    flip=True)
    assert torch.equal(visuals["fake_B"], aux["fake_B"])
    _, unflipped = tm.eval_step(s["A"], s["B"], patch_ids=case["ids"],
                                flip=False)
    fake_B = tm.register(s["A"], s["B"])[0]
    assert torch.equal(fake_B, unflipped["fake_B"])
    assert not torch.allclose(fake_B, aux["fake_B"], atol=1e-3)
