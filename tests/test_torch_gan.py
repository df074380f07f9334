"""The discriminator phase (``lambda_GAN > 0``) and what it needs:
losses/gan.py, nets/discriminators.py with nets/factory.py::define_D, the
netD weight bridge, the two-phase train_step, and utils/image_pool.py,
each against the JAX package.

Bars:
- gan_loss in its four modes: 1e-6 relative;
- gradient_penalty (real, fake, mixed with JAX's alpha given): 1e-5
  relative;
- the three discriminators (basic / n_layers / pixel / patch, antialiased
  and not) against their JAX modules on converted weights: 1e-5 of
  max(1, max |D|); ``basic`` against RefNLayerDiscriminator holding the
  port's own state_dict: 1e-6;
- the two-phase step: metrics 1e-4 relative; netD after phase 1 and
  G/F/R after the step under test_torch_train.py's first-step Adam
  sign-artefact rule (a component whose gradient is inside the noise band,
  GRAD_ENV of the network's max |g|, may move by up to 2.05 lr the other
  way; > 99% of components within 1e-5);
- ImagePool: equal to JAX's, element for element.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat.torch_ref import RefNLayerDiscriminator
from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.losses import gan as jax_gan
from dfmir_tpu.nets import define_D as jax_define_D
from dfmir_tpu.utils.image_pool import ImagePool as JaxImagePool
from dfmir_tpu_torch.compat.convert import (load_jax_params,
                                            netD_state_from_jax, to_nchw)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.losses.gan import GAN_MODES, gan_loss, gradient_penalty
from dfmir_tpu_torch.nets.factory import define_D
from dfmir_tpu_torch.utils.image_pool import ImagePool
from test_torch_train import (CFG, FLOW_GAIN, GRAD_ENV, KEY, LR,
                              jax_flip_coin, jax_pair_patch_ids,
                              jax_patch_ids, named_params, port_tree,
                              tap_locations)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)

GAN = dict(CFG, lambda_GAN=1.0, ndf=8)


def np_rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("mode", GAN_MODES)
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(mode, real):
    pred = (np_rng().standard_normal((3, 7, 7, 1)) * 2).astype(np.float32)
    ref = np.asarray(jax_gan.gan_loss(jnp.asarray(pred), real, mode))
    out = gan_loss(torch.from_numpy(to_nchw(pred)), real, mode).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_gan_loss_unknown_mode_raises():
    with pytest.raises(NotImplementedError):
        gan_loss(torch.zeros(2, 1, 3, 3), True, "hinge")


def jax_and_port_D(netD, seed=0, size=64, **kw):
    """A JAX discriminator's init params and the port's module holding
    them (converted)."""
    jd = jax_define_D(input_nc=1, ndf=8, netD=netD, **kw)
    x0 = jnp.zeros((1, size, size, 1), jnp.float32)
    params = jax.tree.map(np.asarray,
                          jd.init(jax.random.PRNGKey(seed), x0)["params"])
    td = define_D(input_nc=1, ndf=8, netD=netD, **kw,
                  generator=torch.Generator().manual_seed(0))
    sd = dict(td.state_dict())
    sd.update(netD_state_from_jax(params, td))
    td.load_state_dict(sd)
    return jd, params, td


D_CASES = [("basic", {}), ("basic", {"no_antialias": True}),
           ("n_layers", {"n_layers_D": 4}),
           ("n_layers", {"n_layers_D": 2, "no_antialias": True}),
           ("pixel", {}), ("patch", {}), ("patch", {"no_antialias": True}),
           ("basic", {"norm": "none"})]


@pytest.mark.parametrize("netD,kw", D_CASES)
def test_discriminators_match_jax(netD, kw):
    jd, params, td = jax_and_port_D(netD, **kw)
    x = np.tanh(np_rng(1).standard_normal((2, 64, 64, 1))).astype(
        np.float32)
    ref = np.asarray(jd.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = td(torch.from_numpy(to_nchw(x)))
    assert out.shape == to_nchw(ref).shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.numpy(), to_nchw(ref), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("no_antialias", [False, True])
def test_basic_matches_the_torch_reference(no_antialias):
    td = define_D(input_nc=1, ndf=8, netD="basic", no_antialias=no_antialias,
                  generator=torch.Generator().manual_seed(3))
    ref = RefNLayerDiscriminator(input_nc=1, ndf=8, n_layers=3,
                                 no_antialias=no_antialias)
    ref.load_state_dict(td.state_dict(), strict=True)
    x = torch.tanh(torch.randn((2, 1, 64, 64),
                               generator=torch.Generator().manual_seed(4)))
    with torch.no_grad():
        torch.testing.assert_close(td(x), ref(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("netD", ["nope"])
def test_stylegan2_discriminators_raise(netD):
    """The StyleGAN2 discriminators are ported (test_torch_zoo_nets.py):
    only an unknown name is refused."""
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_D(netD=netD, generator=torch.Generator())
    with pytest.raises(NotImplementedError, match="not recognized"):
        RegistrationModel(RegistrationConfig(**dict(GAN, netD=netD)),
                          device="cpu")


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(kind):
    jd, params, td = jax_and_port_D("basic", size=32)
    rng = np_rng(2)
    real, fake = (np.tanh(rng.standard_normal((3, 32, 32, 1))).astype(
        np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    ref = float(jax_gan.gradient_penalty(
        lambda x: jd.apply({"params": params}, x), jnp.asarray(real),
        jnp.asarray(fake), key, kind))
    alpha = np.array(jax.random.uniform(key, (3, 1, 1, 1)))
    out = gradient_penalty(td, torch.from_numpy(to_nchw(real)),
                           torch.from_numpy(to_nchw(fake)), kind,
                           alpha=torch.from_numpy(alpha))
    got = float(out.detach())
    assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
    # differentiable in D's weights, as a penalty on D must be (no bias
    # moves grad_x D)
    out.backward()
    assert all(p.grad is not None for p in td.parameters() if p.ndim > 1)


def test_gradient_penalty_alpha_from_a_generator():
    td = define_D(input_nc=1, ndf=8, generator=torch.Generator().manual_seed(0))
    real, fake = torch.rand((2, 2, 1, 32, 32),
                            generator=torch.Generator().manual_seed(1))
    a, b = (gradient_penalty(td, real, fake,
                             generator=torch.Generator().manual_seed(6))
            for _ in range(2))
    assert float(a) == float(b) > 0
    assert gradient_penalty(td, real, fake, lambda_gp=0.0) == 0.0


# ------------------------------------------------------- the two-phase step

@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(JaxConfig(**GAN))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**GAN), device="cpu")
        load_jax_params(tm, params)
        return tm

    tm = port_model()
    ids = jax_patch_ids(KEY, tap_locations(tm, A), CFG["num_patches"])
    jp = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=jp, opt_state=(
        jm.tx.init({k: jp[k] for k in "GFR"}), jm.tx_d.init(jp["D"])),
        step=jnp.zeros((), jnp.int32))
    new_state, jmetrics = jm.train_step(state, jnp.asarray(a),
                                        jnp.asarray(b), KEY, jnp.float32(LR))
    return dict(params=params, A=A, B=Bt, ids=ids, port_model=port_model,
                new=jax.tree.map(np.asarray, new_state.params),
                jmetrics={k: float(v) for k, v in jmetrics.items()})


def check_moved(nets, ref, before, grads):
    """The first-step Adam rule over ``nets`` ({net: {name: param}})."""
    total = mismatched = 0
    for net, params in nets.items():
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


def named_with_D(tm):
    return dict(named_params(tm), D=dict(tm.netD.named_parameters()))


def test_two_phase_step_matches_jax(setup):
    s = setup
    tm = s["port_model"]()
    before = {net: {k: p.detach().clone() for k, p in ps.items()}
              for net, ps in named_with_D(tm).items()}
    grads_D = {}

    d_step = tm.d_step

    def spy(fake_B, real_B, lr):
        out = d_step(fake_B, real_B, lr)
        grads_D.update({k: p.grad.clone()
                        for k, p in tm.netD.named_parameters()})
        return out

    tm.d_step = spy
    metrics = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    assert set(metrics) == set(s["jmetrics"]) >= {"G_GAN", "D", "D_fake",
                                                  "D_real"}
    for k, v in metrics.items():
        r = s["jmetrics"][k]
        assert abs(float(v) - r) <= 1e-4 * abs(r), (k, float(v), r)
    # netD after phase 1 (its one update)
    ref_D = {"D": netD_state_from_jax(s["new"]["D"], tm.netD)}
    check_moved({"D": dict(tm.netD.named_parameters())}, ref_D, before,
                {"D": grads_D})
    # G/F/R after the step
    ref = port_tree(tm, s["new"])
    grads = {net: {k: p.grad for k, p in ps.items()}
             for net, ps in named_params(tm).items()}
    check_moved(named_params(tm), ref, before, grads)


def test_phase_two_leaves_D_without_gradient(setup):
    """After a step netD's gradients are phase 1's alone (phase 2 adds
    none, as JAX does not differentiate d_params there); outside the step
    G_GAN is 0, as JAX's _loss_fn without d_params gives."""
    s = setup
    tm = s["port_model"]()
    after_d = {}
    d_step = tm.d_step

    def spy(fake_B, real_B, lr):
        out = d_step(fake_B, real_B, lr)
        after_d.update({k: p.grad.clone()
                        for k, p in tm.netD.named_parameters()})
        return out

    tm.d_step = spy
    metrics = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"])
    assert float(metrics["G_GAN"]) > 0
    for k, p in tm.netD.named_parameters():
        assert torch.equal(p.grad, after_d[k]), k
    m, _ = tm.eval_step(s["A"], s["B"], patch_ids=s["ids"])
    assert float(m["G_GAN"]) == 0.0


def test_D_is_built_and_seeded(setup):
    tm = setup["port_model"]()
    assert tm.optimizer_D is not None
    assert set(map(id, tm.parameters())).isdisjoint(
        map(id, tm.netD.parameters()))
    a, b = (RegistrationModel(RegistrationConfig(**GAN), device="cpu",
                              generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    assert all(torch.equal(p, q) for p, q in zip(a.netD.parameters(),
                                                 b.netD.parameters()))
    plain = RegistrationModel(RegistrationConfig(**CFG), device="cpu",
                              generator=torch.Generator().manual_seed(9))
    assert plain.netD is None and plain.optimizer_D is None
    # netD is drawn after every other network: theirs are unchanged
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 plain.parameters()))


OPTIONS = {"fastcut": dict(flip_equivariance=True, nce_idt=False,
                           lambda_NCE=10.0),
           "dropout": dict(no_dropout=False),
           "bf16": dict(compute_dtype="bfloat16"),
           "gan": dict(lambda_GAN=1.0, ndf=8)}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_steps_launch_the_cut_steps_kernels(option, counted_kernels):
    """Each option's step launches what the CUT step does (1 vecint2d_fwd
    + 2 B1 + 1 vecint2d_bwd + 2 B2): the flip moves no warp, and the D
    phase runs netG once and warps nothing."""
    tm = RegistrationModel(RegistrationConfig(**CFG, **OPTIONS[option]),
                           device="cpu")
    a, b = torch.tanh(torch.randn((2, 1, 1, 64, 64),
                                  generator=torch.Generator().manual_seed(0)))
    for flip in (False, True):
        counted_kernels.update(dict.fromkeys(counted_kernels, 0))
        tm.train_step(a, b, LR, generator=torch.Generator().manual_seed(1),
                      flip=flip if option == "fastcut" else None)
        assert counted_kernels == dict(
            counted_kernels, vecint2d_fwd=1, warp2d_bilinear_fwd=2,
            vecint2d_bwd=1, warp2d_bilinear_bwd=2), (option, flip)


def test_fastcut_gan_step_runs_the_coin_once(setup):
    """With flip equivariance and the D phase, D scores the flipped fake_B
    that G's loss uses (one coin, one generator pass), as JAX's phase 1
    derives the same coin as its phase 2."""
    cfg = dict(GAN, flip_equivariance=True, nce_idt=False, lambda_NCE=10.0)
    tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    seen = []
    d_step = tm.d_step
    tm.d_step = lambda f, r, lr: (seen.append(f.clone()), d_step(f, r, lr))[1]
    key = next(jax.random.PRNGKey(n) for n in range(11, 99)
               if jax_flip_coin(jax.random.PRNGKey(n)))
    ids = jax_pair_patch_ids(key, tap_locations(tm, setup["A"]),
                             CFG["num_patches"], 2)
    tm.train_step(setup["A"], setup["B"], LR, patch_ids=ids, flip=True)
    with torch.no_grad():
        fake = tm.netG(torch.cat([setup["A"], setup["B"]]).flip(3))
    assert len(seen) == 1
    assert seen[0].shape == setup["A"].shape
    assert not torch.allclose(seen[0], fake[:2])    # G moved since


def test_image_pool_matches_jax():
    rng = np_rng(3)
    for size, seed in ((0, 0), (3, 1), (5, 7)):
        mine, ref = ImagePool(size, seed), JaxImagePool(size, seed)
        for _ in range(12):
            batch = rng.standard_normal((2, 1, 4, 4)).astype(np.float32)
            np.testing.assert_array_equal(mine.query(batch),
                                          ref.query(batch))
        assert mine.num_imgs == ref.num_imgs
