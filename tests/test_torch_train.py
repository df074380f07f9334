"""The training slice as a whole: the port's RegistrationModel.loss_fn /
train_step against the JAX RegistrationModel._loss_fn / train_step, with
the JAX model's init_state weights carried over by load_jax_params and the
patch ids the JAX step draws (derived here from its step key exactly as
_step_keys -> _nce_from_feats -> PatchSampleF derive them).

Bars:
- metrics of one loss_fn: 1e-4 relative;
- gradients of G, F and R: max-abs difference <= GRAD_ENV (1e-3) times
  the network's max |g| (the JAX suite's own cross-program bar is 1e-2;
  measured on this config: 1.7e-4 G, 2.5e-5 F, 6.9e-6 R, the NCE's
  T = 0.07 softmax and netF's L2 normalisation of near-zero projections
  amplifying float32 rounding into netG's gradient);
- Adam alone over 3 steps against optax: 1e-6 max-abs on the parameters;
- one whole train_step: the JAX suite's rule for first-step Adam sign
  artefacts (a component whose gradient lies inside the noise band may
  move by up to 2.05 lr the other way; > 99% of components within 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dfmir_tpu.engine import LRSchedule as JaxLRSchedule
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine import grid_image as jax_grid_image
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.ops import warp as jax_warp
from dfmir_tpu_torch.compat.convert import (load_jax_params,
                                            netF_state_from_jax,
                                            netG_state_from_jax,
                                            netR_state_from_jax, to_nchw,
                                            to_nhwc)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.schedules import LRSchedule

CFG = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
           vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
           netF_nc=16, num_patches=16)
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform
GRAD_ENV = 1e-3
LR = 2e-4
KEY = jax.random.PRNGKey(11)


def tap_locations(tm, x):
    """Spatial size of every tapped layer of the port's generator."""
    with torch.no_grad():
        feats = tm.netG(x, layers=tuple(tm.cfg.nce_layers), encode_only=True)
    return [f.shape[2] * f.shape[3] for f in feats]


def _jax_ids(k, n_locs, num_patches):
    """The ids JAX's PatchSampleF draws from key ``k``, one (P,) tensor a
    tapped layer."""
    return [torch.from_numpy(np.asarray(jax.random.permutation(
                jax.random.fold_in(k, layer), n)[:min(num_patches, n)]
            ).astype(np.int64)) for layer, n in enumerate(n_locs)]


def jax_patch_ids(key, n_locs, num_patches):
    """The ids the JAX step draws for its NCE calls (kF1, kF2, kF3)."""
    kF = jax.random.split(key, 5)[:3]
    return [_jax_ids(k, n_locs, num_patches) for k in kF]


def jax_pair_patch_ids(key, n_locs, num_patches, n_calls):
    """The ids of the JAX step's re-encode branch (flip equivariance),
    whose keys go by pair index: kF1, kF2[, kF3].  Without ``nce_idt``
    (FastCUT) its two NCE calls draw with kF1 and kF2, so the local NCE
    takes kF2's ids, where the tap-reusing branch takes kF3's."""
    kF = jax.random.split(key, 5)[:n_calls]
    return [_jax_ids(k, n_locs, num_patches) for k in kF]


def jax_flip_coin(key) -> bool:
    """The FastCUT coin the JAX step draws from its key (kFlip)."""
    return bool(jax.random.bernoulli(jax.random.split(key, 5)[3]))


def port_tree(tm, tree):
    """A JAX {"G", "F", "R"} tree (params or gradients) in the port's
    names and layouts."""
    cfg = tm.cfg
    return {"G": netG_state_from_jax(tree["G"], tm.netG.specs),
            "F": netF_state_from_jax(tree["F"]),
            "R": netR_state_from_jax(tree["R"], cfg.vxm_enc, cfg.vxm_dec)}


def named_params(tm):
    return {"G": dict(tm.netG.named_parameters()),
            "F": dict(tm.netF.named_parameters()),
            "R": dict(tm.netR.named_parameters())}


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(JaxConfig(**CFG))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**CFG), device="cpu")
        load_jax_params(tm, params)
        return tm

    tm = port_model()
    ids = jax_patch_ids(KEY, tap_locations(tm, A), CFG["num_patches"])
    return dict(jm=jm, params=params, a=a, b=b, A=A, B=Bt, ids=ids,
                port_model=port_model)


@pytest.fixture(scope="module")
def jax_grads(setup):
    s = setup
    jp = jax.tree.map(jnp.asarray, s["params"])
    grads, (metrics, aux) = jax.jit(jax.grad(
        lambda p: s["jm"]._loss_fn(p, jnp.asarray(s["a"]),
                                   jnp.asarray(s["b"]), KEY),
        has_aux=True))(jp)
    return jax.tree.map(np.asarray, grads), metrics, aux


def test_loss_fn_matches_jax(setup, jax_grads):
    s = setup
    _, ref, _ = jax_grads
    tm = s["port_model"]()
    with torch.no_grad():
        _, metrics, aux = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    assert set(metrics) == set(ref) == {"G", "NCE", "NCE_Y", "R", "smooth",
                                        "local", "total"}
    assert float(aux["pos_flow"].abs().max()) > 0.5      # the warps deform
    for k, v in metrics.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r), (k, float(v), r)


def test_gradients_match_jax(setup, jax_grads):
    s = setup
    ref = port_tree(s["port_model"](), jax_grads[0])
    tm = s["port_model"]()
    total, _, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    total.backward()
    for net, params in named_params(tm).items():
        assert set(params) == set(ref[net]), net
        scale = max(float(g.abs().max()) for g in ref[net].values())
        assert scale > 0, net
        for name, p in params.items():
            err = float((p.grad - ref[net][name]).abs().max())
            assert err <= GRAD_ENV * scale, (net, name, err, scale)


def test_adam_matches_optax(setup):
    """The model's Adam alone, fed the same gradients for 3 steps, against
    optax.scale_by_adam followed by -lr * u (the JAX step's update)."""
    tm = setup["port_model"]()
    rng = np.random.default_rng(1)
    params = tm.parameters()
    p0 = [p.detach().numpy().copy() for p in params]
    tx = optax.scale_by_adam(b1=tm.cfg.beta1, b2=tm.cfg.beta2, eps=1e-8)
    jparams = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jparams)
    for step, lr in enumerate((2e-4, 1e-4, 3e-4)):
        grads = [(rng.standard_normal(p.shape) * 10.0 ** -step).astype(
            np.float32) for p in p0]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        tm.apply_gradients(lr)
        upd, opt_state = tx.update([jnp.asarray(g) for g in grads],
                                   opt_state, jparams)
        jparams = optax.apply_updates(
            jparams, jax.tree.map(lambda u: -lr * u, upd))
        for p, r in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                       rtol=0, atol=1e-6)
    assert any(not np.array_equal(p.detach().numpy(), q)
               for p, q in zip(params, p0))


def test_train_step_matches_jax(setup, jax_grads):
    s = setup
    jm = s["jm"]
    grads = port_tree(s["port_model"](), jax_grads[0])
    jp = jax.tree.map(jnp.asarray, s["params"])
    state = TrainState(params=jp, opt_state=jm.tx.init(jp),
                       step=jnp.zeros((), jnp.int32))
    new_state, jmetrics = jm.train_step(state, jnp.asarray(s["a"]),
                                        jnp.asarray(s["b"]), KEY,
                                        jnp.float32(LR))
    ref = port_tree(s["port_model"](), jax.tree.map(np.asarray,
                                                    new_state.params))

    tm = s["port_model"]()
    before = {net: {k: p.detach().clone() for k, p in ps.items()}
              for net, ps in named_params(tm).items()}
    metrics = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
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


def test_eval_step_and_visuals(setup, jax_grads):
    s = setup
    tm = s["port_model"]()
    before = [p.detach().clone() for p in tm.parameters()]
    metrics, aux = tm.eval_step(s["A"], s["B"], patch_ids=s["ids"])
    with torch.no_grad():
        _, ref, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    for k in ref:
        assert float(metrics[k]) == float(ref[k]), k
    visuals, vmetrics = tm.compute_visuals(s["A"], s["B"],
                                           patch_ids=s["ids"])
    assert set(visuals) == {"real_A", "fake_B", "real_B", "dvf",
                            "registered", "regA", "idt_B"}
    for v in visuals.values():
        assert v.shape == s["A"].shape
    assert float(vmetrics["total"]) == float(ref["total"])
    assert all(torch.equal(p, q) for p, q in zip(tm.parameters(), before))

    # the JAX compute_visuals' dvf: its grid image warped by pos_flow
    jaux = jax_grads[2]
    grid = np.tile(jax_grid_image(CFG["crop_size"]), (2, 1, 1, 1))
    dvf = jax_warp(jnp.asarray(grid), jaux["pos_flow"])
    np.testing.assert_allclose(to_nhwc(visuals["dvf"]), np.asarray(dvf),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(to_nhwc(visuals["registered"]),
                               np.asarray(jaux["registered"]), rtol=0,
                               atol=1e-3)


def test_patch_ids_from_generators(setup):
    s = setup
    tm = s["port_model"]()
    m1, _ = tm.eval_step(s["A"], s["B"],
                         generator=torch.Generator().manual_seed(5))
    m2, _ = tm.eval_step(s["A"], s["B"],
                         generator=torch.Generator().manual_seed(5))
    assert float(m1["total"]) == float(m2["total"])
    metrics = tm.train_step(s["A"], s["B"], LR)      # the model's own
    assert all(np.isfinite(float(v)) for v in metrics.values())
    with pytest.raises(ValueError, match="NCE calls"):
        tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"][:2])


class _Opt:
    lr = 2e-4
    epoch_count = 1
    n_epochs = 10
    n_epochs_decay = 10
    lr_decay_iters = 3


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau"])
def test_lr_schedule_matches_jax(policy):
    opt = _Opt()
    opt.lr_policy = policy
    mine, ref = LRSchedule(opt), JaxLRSchedule(opt)
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.5] * 2
    for m in metrics:
        assert mine.current_lr() == ref.current_lr()
        assert mine.step(m) == ref.step(m)
    if policy == "plateau":
        assert mine.current_lr() < opt.lr           # it did reduce


def test_load_jax_params_is_strict_about_F(setup):
    s = setup
    tm = s["port_model"]()
    with pytest.raises(KeyError):
        load_jax_params(tm, {k: v for k, v in s["params"].items()
                             if k != "F"})
    short_F = dict(s["params"]["F"])
    short_F.pop("mlp_4_1")
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(tm, dict(s["params"], F=short_F))


@pytest.mark.parametrize("netF", ["nope"])
def test_unported_netF_raises(netF):
    """Every JAX netF is ported: only an unknown name is refused."""
    with pytest.raises(NotImplementedError, match="not recognized"):
        RegistrationModel(RegistrationConfig(**dict(CFG, netF=netF)),
                          device="cpu")
