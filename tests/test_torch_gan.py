"""The discriminator phase (``lambda_GAN > 0``): the netD weight bridge,
the two-phase train_step and utils/image_pool.py, each against the JAX
package (losses/gan.py: ``test_torch_gan_losses.py``; the discriminators:
``test_torch_gan_nets.py``).

Bars:
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

from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu.utils.image_pool import ImagePool as JaxImagePool
from dfmir_tpu_torch.compat.convert import (load_jax_params,
                                            netD_state_from_jax, to_nchw)
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.utils.image_pool import ImagePool
from test_torch_train import (CFG, FLOW_GAIN, GRAD_ENV, KEY, LR,
                              jax_flip_coin, jax_pair_patch_ids,
                              jax_patch_ids, named_params, port_tree,
                              tap_locations)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

GAN = dict(CFG, lambda_GAN=1.0, ndf=8)


def np_rng(seed=0):
    return np.random.default_rng(seed)


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
