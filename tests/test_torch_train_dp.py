"""The 2-D training step data parallel (parallel/, the JAX package's
sharded step) over 2 ``gloo`` ranks on the CPU, global B=4, 2 a rank, all
cases in one launch that runs beside the JAX compiles:

- against JAX: the CUT step against JAX's single-device ``train_step`` on
  the same 4 pairs and patch ids, under tests/test_torch_train.py's bars
  (metrics 1e-4 relative; parameters: first-step Adam sign flips only, at
  gradients inside GRAD_ENV of the network's max |g|, > 99% of components
  within 1e-5); with ``nce_includes_all_negatives_from_minibatch`` the
  step's metrics against JAX's single-device loss at B=4 (1e-4);
- the reduction in float64: the 2-rank gradients against one process's
  within 1e-5 of each network's max |g|, JAX's own reduction-bug bar
  (tests/test_train_step.py), for CUT, FastCUT at both coins (then a coin
  drawn from the model's generator) and lambda_GAN 1 (netD's gradients
  too); the ranks' patch generators agree with each other and with one
  process's;
- bf16: 2 ranks against one process at tests/test_torch_bf16.py's bars
  (metrics 1e-2 relative; register after the step: fake_B 0.1, pos_flow
  1e-3, y_source 1e-2);
- dropout: each rank's keep rate 0.5 within 5 binomial sigmas, the ranks'
  masks differ, the replicas stay equal.
After every step the ranks hold their parameters and Adam state bit for
bit alike (a checksum of each tensor)."""

import concurrent.futures
import math

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
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_bf16 import BF16_GAIN, METRIC_BAR, REGISTER_BARS
from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_train import (CFG, FLOW_GAIN, GRAD_ENV, KEY, LR,
                              jax_patch_ids, port_tree, tap_locations)

B = 4
LIMIT = 300.0            # seconds the launch may take
F64_BAR = 1e-5
KEEP_SIGMAS = 5.0
SEED, PATCH_SEED = 3, 5
FASTCUT = dict(flip_equivariance=True, nce_idt=False, lambda_NCE=10.0)
GAN = dict(lambda_GAN=1.0, netD="basic", gan_mode="lsgan")
ALLNEG = dict(nce_includes_all_negatives_from_minibatch=True)
BF16 = dict(compute_dtype="bfloat16")
DROPOUT = dict(no_dropout=False)
# the float64 cases: (config fields, [coin of each step])
F64_CASES = {"cut": ({}, [None]), "fastcut_0": (FASTCUT, [False, None]),
             "fastcut_1": (FASTCUT, [True, None]), "gan": (GAN, [None])}


def pairs(seed):
    rng = np.random.default_rng(seed)
    return [np.tanh(2 * rng.standard_normal((B, 64, 64, 1))).astype(
        np.float32) for _ in range(2)]


def seeded_model(fields, dtype=torch.float32, gain=FLOW_GAIN):
    """One process's model from SEED, as a rank builds it."""
    model = RegistrationModel(RegistrationConfig(**CFG, **fields),
                              device="cpu",
                              generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.netR.flow.weight.mul_(gain)
    for net in nets_of(model).values():
        net.to(dtype)
    return model


def nets_of(model):
    nets = {"G": model.netG, "F": model.netF, "R": model.netR}
    if model.netD is not None:
        nets["D"] = model.netD
    return nets


@pytest.fixture(scope="module")
def setup():
    """JAX's weights in the port, the data and patch ids, and the launch
    of every case, started in a thread (the ranks run while the tests
    compile JAX's steps)."""
    jm = JaxModel(JaxConfig(**CFG))
    params = jax.tree.map(lambda a: np.array(a, dtype=np.float32),
                          jm.init_state(jax.random.PRNGKey(0)).params)
    params["R"]["flow"]["kernel"] *= FLOW_GAIN
    a, b = pairs(0)
    A, Bt = torch.from_numpy(to_nchw(a)), torch.from_numpy(to_nchw(b))
    tm = RegistrationModel(RegistrationConfig(**CFG), device="cpu")
    load_jax_params(tm, params)
    state = {k: net.state_dict() for k, net in nets_of(tm).items()}
    ids = jax_patch_ids(KEY, tap_locations(tm, A), CFG["num_patches"])
    A64, B64 = A.double(), Bt.double()

    jobs = {
        "cut": dict(cfg=CFG, state=state, batches=[(A, Bt)], lr=LR,
                    patch_ids=[ids]),
        "allneg": dict(cfg=dict(CFG, **ALLNEG), state=state,
                       batches=[(A, Bt)], lr=LR, patch_ids=[ids]),
        "bf16": dict(cfg=dict(CFG, **BF16), seed=SEED, flow_gain=BF16_GAIN,
                     batches=[(A, Bt)], lr=LR, patch_seed=PATCH_SEED,
                     register=True),
        "dropout": dict(cfg=dict(CFG, **DROPOUT), seed=SEED,
                        flow_gain=FLOW_GAIN, batches=[(A, Bt)] * 2, lr=LR,
                        patch_seed=PATCH_SEED, record_dropout=True),
    }
    for name, (fields, flips) in F64_CASES.items():
        jobs[f"f64_{name}"] = dict(
            cfg=dict(CFG, **fields), seed=SEED, flow_gain=FLOW_GAIN,
            dtype="float64", batches=[(A64, B64)] * len(flips), lr=0.0,
            flip=flips)
    cases = [(name, "registration_steps", {"job": job})
             for name, job in jobs.items()]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu", "cpu"], (cases,),
                         LIMIT)
    yield dict(jm=jm, params=params, a=a, b=b, A=A, B=Bt, A64=A64, B64=B64,
               ids=ids, tm=tm, future=future)
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(setup):
    """{case: [rank 0's report, rank 1's]}."""
    out = setup["future"].result(timeout=LIMIT + 60)
    return {name: [r[name] for r in out] for name in out[0]}


def assert_replicas(reports):
    for i, sums in enumerate(reports[0]["checksums"]):
        for r in reports[1:]:
            assert torch.equal(r["checksums"][i], sums), f"step {i}"


def rel(x, ref):
    return abs(x - ref) / max(abs(ref), 1e-12)


def test_cut_step_matches_jax(setup, ranks):
    s = setup
    jm = s["jm"]
    jp = jax.tree.map(jnp.asarray, s["params"])
    st = TrainState(params=jp, opt_state=jm.tx.init(jp),
                    step=jnp.zeros((), jnp.int32))
    new, jmetrics = jm.train_step(st, jnp.asarray(s["a"]),
                                  jnp.asarray(s["b"]), KEY, jnp.float32(LR))
    ref = port_tree(s["tm"], jax.tree.map(np.asarray, new.params))
    rep = ranks["cut"]
    assert_replicas(rep)
    metrics = rep[0]["metrics"][0]
    assert rep[1]["metrics"][0] == metrics
    for k, v in jmetrics.items():
        assert rel(metrics[k], float(v)) <= 1e-4, (k, metrics[k], float(v))

    grads, params = rep[0]["grads"], rep[0]["params"]
    total = mismatched = 0
    for net in ("G", "F", "R"):
        noise = GRAD_ENV * max(float(g.abs().max())
                               for g in grads[net].values())
        for name, p in params[net].items():
            r = ref[net][name]
            mism = ~torch.isclose(p, r, atol=1e-5, rtol=1e-4)
            total += p.numel()
            mismatched += int(mism.sum())
            if mism.any():
                assert float((p - r)[mism].abs().max()) <= 2.05 * LR, name
                assert float(grads[net][name][mism].abs().max()) <= noise, (
                    f"{name}: sign flip at a resolvable gradient")
    assert mismatched < 0.01 * total, (mismatched, total)


def test_all_negatives_step_matches_jax(setup, ranks):
    s = setup
    jm = JaxModel(JaxConfig(**CFG, **ALLNEG))
    _, (jmetrics, _) = jax.jit(lambda p, a, b: jm._loss_fn(p, a, b, KEY))(
        jax.tree.map(jnp.asarray, s["params"]), jnp.asarray(s["a"]),
        jnp.asarray(s["b"]))
    rep = ranks["allneg"]
    assert_replicas(rep)
    metrics = rep[0]["metrics"][0]
    for k, v in jmetrics.items():
        assert rel(metrics[k], float(v)) <= 1e-4, (k, metrics[k], float(v))
    # all negatives is another loss than the per-image one
    assert rel(metrics["NCE"], ranks["cut"][0]["metrics"][0]["NCE"]) > 1e-3


@pytest.mark.parametrize("case", sorted(F64_CASES))
def test_float64_gradients_equal_one_process(setup, ranks, case):
    fields, flips = F64_CASES[case]
    model = seeded_model(fields, torch.float64)
    A, Bt = setup["A64"], setup["B64"]
    for i, flip in enumerate(flips):
        model.train_step(A, Bt, 0.0, flip=flip)
        if i == 0:
            ref = {net: {k: p.grad.clone() for k, p in m.named_parameters()
                         if p.grad is not None}
                   for net, m in nets_of(model).items()}
    rep = ranks[f"f64_{case}"]
    assert_replicas(rep)
    grads = rep[0]["grads"]
    assert set(grads) == set(ref)
    for net, g_ref in ref.items():
        assert set(grads[net]) == set(g_ref), net
        scale = max(float(g.abs().max()) for g in g_ref.values())
        assert scale > 0, net
        diff = max(float((grads[net][k] - g).abs().max())
                   for k, g in g_ref.items())
        assert diff <= F64_BAR * scale, (net, diff, scale)
    # one patch-id stream (and FastCUT coin) on every rank, the one
    # process's
    for r in rep:
        assert torch.equal(r["patch_state"],
                           model.patch_generator.get_state())


def test_bf16_matches_one_process(setup, ranks):
    model = seeded_model(BF16, gain=BF16_GAIN)
    metrics = model.train_step(setup["A"], setup["B"], LR,
                               generator=torch.Generator().manual_seed(
                                   PATCH_SEED))
    rep = ranks["bf16"]
    assert_replicas(rep)
    mine = rep[0]["metrics"][0]
    for k, v in metrics.items():
        assert rel(mine[k], float(v)) <= METRIC_BAR, (k, mine[k], float(v))
    with torch.no_grad():
        ref = model.register(setup["A"], setup["B"])
    names = ("fake_B", "idt_B", "y_source", "pos_flow")
    for name, x, y in zip(names, rep[0]["register"], ref):
        err = float((x - y).abs().max())
        assert err <= REGISTER_BARS[name], (name, err)


def test_dropout_masks_are_each_ranks_own(ranks):
    rep = ranks["dropout"]
    assert_replicas(rep)
    for r in rep:
        d = r["dropout"]
        bound = KEEP_SIGMAS * math.sqrt(0.25 / d["draws"])
        assert abs(d["kept"] / d["draws"] - 0.5) <= bound, d
        assert all(math.isfinite(v) for m in r["metrics"]
                   for v in m.values())
    assert not torch.equal(rep[0]["dropout"]["head"],
                           rep[1]["dropout"]["head"])
