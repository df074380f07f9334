"""Dropout in training (``--no_dropout false``): Dropout(0.5) after the
first conv-norm-relu of each ResnetBlock, its masks from an explicit
generator, active only in the steps' generator passes.

torch cannot draw ``jax.random``'s masks, so the masks are held to their
statistics and to their seed, and every path with dropout inactive to the
JAX package with ``no_dropout=False`` weights (carried over by
load_jax_params, whose netG keys shift past the dropout slot):
- keep rate 0.5 within 5 binomial standard deviations; kept values scaled
  by exactly 2, dropped ones exactly 0;
- one generator seed, the same masks and losses; another seed, others;
- register against JAX's register (which runs its netG with
  ``train=False``): 1e-3 max-abs (test_torch_register.py's bar);
- loss_fn with ``train=False`` against JAX's _loss_fn of the same weights
  with dropout off: 1e-4 relative (test_torch_train.py's bar);
- ``eval_step`` and ``compute_visuals`` draw masks, as JAX's do (its
  ``_loss_fn`` runs netG in training mode): keep rate and seed as above,
  and with ``no_dropout=True`` bit-equal to the dropout-free loss and to
  ``register``'s netG outputs.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.nets.resnet_gen import Dropout, ResnetGenerator
from test_torch_train import (CFG, FLOW_GAIN, KEY, LR, jax_patch_ids,
                              tap_locations)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

DROPOUT = dict(CFG, no_dropout=False)
SIGMAS = 5.0


def keep_bound(n):
    """|keep rate - 0.5| allowed over n Bernoulli(0.5) draws."""
    return SIGMAS * math.sqrt(0.25 / n)


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(JaxConfig(**DROPOUT))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    rng = np.random.default_rng(0)
    a, b = (np.tanh(2 * rng.standard_normal((2, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))

    def port_model():
        tm = RegistrationModel(RegistrationConfig(**DROPOUT), device="cpu")
        load_jax_params(tm, params)
        return tm

    ids = jax_patch_ids(KEY, tap_locations(port_model(), A),
                        CFG["num_patches"])
    return dict(jm=jm, params=params, a=a, b=b, A=A, B=Bt, ids=ids,
                port_model=port_model)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_statistics(dtype):
    x = torch.rand((4, 8, 128, 128), generator=torch.Generator().manual_seed(
        1)).to(dtype) + 0.5
    y = Dropout(0.5)(x, torch.Generator().manual_seed(2))
    kept = y != 0
    rate = float(kept.float().mean())
    assert abs(rate - 0.5) <= keep_bound(x.numel()), rate
    assert torch.equal(y[kept], x[kept] * 2)
    assert y.dtype == dtype
    assert torch.equal(Dropout(0.5)(x), x)          # no generator: inactive


def test_masks_follow_their_seed():
    net = ResnetGenerator(ngf=8, n_blocks=4, use_dropout=True,
                          generator=torch.Generator().manual_seed(0))
    x = torch.tanh(torch.randn((2, 1, 32, 32),
                               generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        runs = [net(x, train=True, generator=torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
        off = net(x)
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    assert not torch.allclose(runs[0], off)
    assert torch.equal(net(x, train=False,
                           generator=torch.Generator().manual_seed(5)), off)
    with pytest.raises(ValueError, match="generator"):
        net(x, train=True)


def test_step_masks_keep_half(setup):
    """Every mask a training loss_fn draws: keep rate 0.5 within the
    binomial bound, over the forward pass and the query encode."""
    s = setup
    tm = s["port_model"]()
    masks = []

    def hook(module, args, out):
        # the ReLU before it zeroes about half: read the mask where the
        # input is not 0
        live = args[0] != 0
        assert torch.equal(out[live & (out != 0)],
                           2 * args[0][live & (out != 0)])
        masks.append(out[live] != 0)

    handles = [m.register_forward_hook(hook) for m in tm.netG.modules()
               if isinstance(m, Dropout)]
    with torch.no_grad():
        tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"],
                   dropout_generator=torch.Generator().manual_seed(3))
    for h in handles:
        h.remove()
    n_blocks = tm.netG.specs.count({"kind": "resblock", "channels": 32})
    assert len(masks) == 2 * n_blocks        # the forward and the queries
    n = sum(m.numel() for m in masks)
    rate = sum(int(m.sum()) for m in masks) / n
    assert abs(rate - 0.5) <= keep_bound(n), rate


def test_step_is_seeded_and_trains(setup):
    s = setup
    runs = []
    for seed in (7, 7, 8):
        tm = s["port_model"]()
        before = [p.detach().clone() for p in tm.parameters()]
        m = tm.train_step(s["A"], s["B"], LR, patch_ids=s["ids"],
                          dropout_generator=torch.Generator().manual_seed(
                              seed))
        assert all(math.isfinite(float(v)) for v in m.values())
        assert any(not torch.equal(p, q)
                   for p, q in zip(tm.parameters(), before))
        runs.append((float(m["total"]), [p.detach() for p in
                                         tm.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(p, q) for p, q in zip(runs[0][1], runs[1][1]))
    assert runs[0][0] != runs[2][0]
    # the forward pass's fake_B is netG's under the step's first masks
    tm = s["port_model"]()
    with torch.no_grad():
        _, _, aux = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"],
                               dropout_generator=torch.Generator()
                               .manual_seed(7))
        fake = tm.netG(torch.cat([s["A"], s["B"]]), train=True,
                       generator=torch.Generator().manual_seed(7))
    assert torch.equal(aux["fake_B"], fake[:2])


def test_model_generator_draws_on_the_model_device(setup):
    tm = setup["port_model"]()
    assert tm.dropout_generator.device == tm.device
    m1 = tm.eval_step(setup["A"], setup["B"], patch_ids=setup["ids"])[0]
    g0 = tm.dropout_generator.get_state()
    with torch.no_grad():
        m2 = tm.loss_fn(setup["A"], setup["B"], patch_ids=setup["ids"])[1]
    assert not torch.equal(tm.dropout_generator.get_state(), g0)
    assert float(m1["total"]) != float(m2["total"])


def test_register_matches_jax(setup):
    s = setup
    jp = jax.tree.map(jnp.asarray, s["params"])
    ref = s["jm"].register(jp, jnp.asarray(s["a"]), jnp.asarray(s["b"]))
    tm = s["port_model"]()
    g0 = tm.dropout_generator.get_state()
    out = tm.register(s["A"], s["B"])
    assert torch.equal(tm.dropout_generator.get_state(), g0)
    for name, o, r in zip(("fake_B", "idt_B", "y_source", "pos_flow"), out,
                          ref):
        np.testing.assert_allclose(to_nhwc(o), np.asarray(r), rtol=0,
                                   atol=1e-3, err_msg=name)


def test_inactive_loss_matches_jax(setup):
    """loss_fn with dropout inactive (``train=False``) against JAX's
    _loss_fn on the same weights with no_dropout=True (JAX's own steps,
    eval_step and visuals always draw masks); eval_step draws them."""
    s = setup
    jm = JaxModel(JaxConfig(**CFG))
    jp = jax.tree.map(jnp.asarray, s["params"])
    _, (ref, _) = jax.jit(lambda p: jm._loss_fn(
        p, jnp.asarray(s["a"]), jnp.asarray(s["b"]), KEY))(jp)
    tm = s["port_model"]()
    metrics, _ = tm.eval_step(s["A"], s["B"], patch_ids=s["ids"])
    with torch.no_grad():
        _, m_inactive, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"],
                                      train=False)
        _, m_active, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"])
    for k, v in m_inactive.items():
        r = float(ref[k])
        assert abs(float(v) - r) <= 1e-4 * abs(r), (k, float(v), r)
    assert float(m_active["total"]) != float(metrics["total"])
    assert float(m_inactive["total"]) != float(metrics["total"])


def dropout_hook_masks(tm):
    """Hooks on netG's Dropout layers collecting each drawn mask (where
    the input is not 0); returns (masks, handles)."""
    masks = []

    def hook(module, args, out):
        live = args[0] != 0
        masks.append(out[live] != 0)

    return masks, [m.register_forward_hook(hook) for m in tm.netG.modules()
                   if isinstance(m, Dropout)]


@pytest.mark.parametrize("path", ["eval_step", "compute_visuals"])
def test_eval_paths_draw_dropout(setup, path):
    """C-7: eval_step and compute_visuals with ``no_dropout=False`` draw
    masks in both generator passes, keep rate 0.5 within the binomial
    bound; one generator seed gives the same masks and outputs twice,
    another seed others."""
    s = setup
    tm = s["port_model"]()
    fn = getattr(tm, path)
    masks, handles = dropout_hook_masks(tm)
    runs = [fn(s["A"], s["B"], patch_ids=s["ids"],
               dropout_generator=torch.Generator().manual_seed(seed))
            for seed in (3, 3, 4)]
    for h in handles:
        h.remove()
    n_layers = sum(isinstance(m, Dropout) for m in tm.netG.modules())
    assert len(masks) == 3 * 2 * n_layers     # 3 calls: forward + queries
    first = masks[:2 * n_layers]
    n = sum(m.numel() for m in first)
    rate = sum(int(m.sum()) for m in first) / n
    assert abs(rate - 0.5) <= keep_bound(n), rate
    again = masks[2 * n_layers:4 * n_layers]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    other = masks[4 * n_layers:]
    assert not all(torch.equal(x, y) for x, y in zip(first, other))
    fake = {"eval_step": lambda r: r[1]["fake_B"],
            "compute_visuals": lambda r: r[0]["fake_B"]}[path]
    assert torch.equal(fake(runs[0]), fake(runs[1]))
    assert not torch.equal(fake(runs[0]), fake(runs[2]))
    # the model's own generator when none is given: it advances
    g0 = tm.dropout_generator.get_state()
    fn(s["A"], s["B"], patch_ids=s["ids"])
    assert not torch.equal(tm.dropout_generator.get_state(), g0)


def test_eval_paths_without_dropout_unchanged(setup):
    """C-7 at ``no_dropout=True``: eval_step's and compute_visuals'
    metrics bit-equal to the dropout-free loss_fn (what both ran before),
    their fake_B / idt_B bit-equal to register's netG outputs, and the
    dropout generator untouched."""
    s = setup
    tm = RegistrationModel(RegistrationConfig(**CFG), device="cpu")
    load_jax_params(tm, s["params"])
    g0 = tm.dropout_generator.get_state()
    metrics, aux = tm.eval_step(s["A"], s["B"], patch_ids=s["ids"])
    visuals, v_metrics = tm.compute_visuals(s["A"], s["B"],
                                            patch_ids=s["ids"])
    with torch.no_grad():
        _, ref, _ = tm.loss_fn(s["A"], s["B"], patch_ids=s["ids"],
                               train=False)
    fake_B, idt_B, _, _ = tm.register(s["A"], s["B"])
    assert torch.equal(tm.dropout_generator.get_state(), g0)
    for m in (metrics, v_metrics):
        assert set(m) == set(ref)
        assert all(float(m[k]) == float(ref[k]) for k in ref)
    for got in (aux, visuals):
        assert torch.equal(got["fake_B"], fake_B)
        assert torch.equal(got["idt_B"], idt_B)
