"""The joint model's training options on slabs at 2-D (images split along
H over ``gloo`` ranks on the CPU), against the JAX RegistrationModel's
whole-image ``train_step`` with the same option, from the same weights
(JAX's ``init_state``, loaded into the port by ``load_jax_params``; the
flow head times ``FLOW_GAIN``, ``BF16_GAIN`` in bfloat16), on JAX's patch
ids and FastCUT coin:

- on 1 x 2: bfloat16 (``register`` too), FastCUT at each coin, and the
  GAN phase with netD ``pixel`` and ``no_antialias_up``;
- on 2 x 2 (global B=2, one item a data rank): the GAN phase with netD
  ``basic`` and all-negatives PatchNCE (netD's gradient counted once a
  data rank, the keys gathered over the data ranks alone);
- on 1 x 4: FastCUT + the GAN phase (``lambda_GAN`` 1e4, so that the G
  phase's gradient through the gathered netD is most of netG's: at 1 it is
  about 5e-5 of netG's max |g|, under any gradient bar) +
  ``no_antialias_up`` + all negatives.

Each: one ``loss_fn`` (metrics, and the gradients averaged over the ranks;
with the GAN phase, whose loss_fn has no netD term, the metrics that do
not read netD) and one ``train_step`` (its metrics, D, D_fake, D_real and
G_GAN among them, its gradients, netD's too, against JAX's, g = 2 mu at
beta1 0.5).  Options share a JAX config where they touch different parts
of the step, so that the file compiles five JAX steps.  Dropout
(``no_dropout=False``; 1 x 2, and 1 x 4 with FastCUT and the GAN phase):
JAX's masks cannot be drawn by the port, so the ranks are held against the
port's one process seeded alike (``dropout_seed``).

Bars: float32 metrics 1e-4 relative, gradients within 1e-3 of each
network's max |g|; bfloat16 at the JAX suite's bfloat16 bars
(``tests/test_perf_paths.py``, ``tests/test_torch_bf16.py``): metrics 1e-2
relative, ``register``'s fake_B / idt_B 0.1, y_source 1e-2, pos_flow 1e-3
max-abs on a field of about 0.1 px, against JAX and against the port's
one process in bfloat16; its gradients, which no JAX bar holds (JAX's
own bfloat16 NCE gradients are a fifth of netF's max |g| off the
port's), against the port's one process in bfloat16, within 0.1 of each
network's max |g|;
dropout against one process: metrics 1e-5 relative, gradients 1e-3 of each
network's max |g|; after ``train_step`` every rank's parameters and Adam
states bit-equal.  One launch of 4 ranks, in a thread beside the JAX
compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine import TrainState
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import load_jax_params, to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_fastcut import key_with_coin
from test_torch_joint3d import tap_locations3d
from test_torch_train import (GRAD_ENV, KEY, LR, jax_pair_patch_ids,
                              jax_patch_ids)
from test_torch_zoo_train import port_tree
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 400.0
FLOW_GAIN = 1e5      # the flow head N(0, 1e-5) -> about a pixel
# a field of about 0.1 px at this config (0.2 at 1e4), the premise of the
# bfloat16 pos_flow bar: one bf16 ulp of the flow head's output there is
# under 1e-3 (tests/test_torch_bf16.py)
BF16_GAIN = 5e3
METRIC_TOL = 1e-4
BF16_METRIC_TOL = 1e-2
BF16_GRAD_ENV = 1e-1
DROPOUT_METRIC_TOL = 1e-5
REGISTER_BARS = {"fake_B": 0.1, "idt_B": 0.1, "y_source": 1e-2,
                 "pos_flow": 1e-3}
CFG32 = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
             vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
FASTCUT = dict(flip_equivariance=True, nce_idt=False, lambda_NCE=10.0)
GAN = dict(lambda_GAN=1.0, ndf=8)
ALL_NEG = dict(nce_includes_all_negatives_from_minibatch=True)
# case: (the options, (n_data, n_spatial), FastCUT's coin or None)
CASES = {
    "bf16_1x2": (dict(compute_dtype="bfloat16"), (1, 2), None),
    "fastcut_heads_1x2": (FASTCUT, (1, 2), False),
    "fastcut_tails_1x2": (FASTCUT, (1, 2), True),
    "gan_pixel_up_1x2": (dict(GAN, netD="pixel", no_antialias_up=True),
                         (1, 2), None),
    "gan_basic_all_negatives_2x2": (dict(GAN, **ALL_NEG), (2, 2), None),
    "mixed_1x4": (dict(FASTCUT, **ALL_NEG, ndf=8, lambda_GAN=1e4,
                       no_antialias_up=True), (1, 4), True)}
DROPOUT = {
    "dropout_1x2": (dict(no_dropout=False), (1, 2), None),
    "dropout_mixed_1x4": (dict(FASTCUT, **GAN, no_dropout=False), (1, 4),
                          True)}
DROPOUT_SEED = 7


def is_gan(setup, case):
    return setup["jobs"][case]["cfg"].get("lambda_GAN", 0) > 0


_JAX = {}


def cached(key, make):
    if key not in _JAX:
        _JAX[key] = make()
    return _JAX[key]


def jax_and_port(cfg, gain):
    """JAX's model and its init_state weights (numpy, the flow head times
    ``gain``), and the port's state dicts of the same weights.  One JAX
    model a config (its jitted step compiles once) and one init a set of
    networks."""
    jm = cached(repr(sorted(cfg.items())), lambda: JaxModel(JaxConfig(**cfg)))
    nets = (cfg["ndims"] if "ndims" in cfg else 2,
            cfg.get("no_antialias_up", False),
            cfg.get("netD", "basic") if cfg.get("lambda_GAN", 0) > 0
            else None)
    params = jax.tree.map(np.copy, cached(nets, lambda: jax.tree.map(
        lambda a: np.array(a, dtype=np.float32),
        jm.init_state(jax.random.PRNGKey(0)).params)))
    params["R"]["flow"]["kernel"] *= gain
    tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    load_jax_params(tm, params)
    nets = {"G": tm.netG, "F": tm.netF, "R": tm.netR, "D": tm.netD}
    # copies: a launch moves the tensors it sends into shared memory
    state = {k: {n: v.clone() for n, v in net.state_dict().items()}
             for k, net in nets.items() if net is not None}
    return jm, tm, params, state


def jax_train_step(jm, params, a, b, key):
    """JAX's train_step: its metrics and gradients ({net: tree}, g = 2 mu:
    G, F and R's from the main update, D's from netD's)."""
    assert jm.cfg.beta1 == 0.5
    jp = jax.tree.map(jnp.asarray, params)
    if "D" in jp:
        opt = (jm.tx.init({k: jp[k] for k in "GFR"}), jm.tx_d.init(jp["D"]))
    else:
        opt = jm.tx.init(jp)
    new, metrics = jm.train_step(
        TrainState(params=jp, opt_state=opt, step=jnp.zeros((), jnp.int32)),
        jnp.asarray(a), jnp.asarray(b), key, jnp.float32(LR))
    mu = (dict(new.opt_state[0].mu, D=new.opt_state[1].mu) if "D" in jp
          else dict(new.opt_state.mu))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda m: 2.0 * np.asarray(m), mu))


def patch_ids(tm, A, coin, key):
    """JAX's patch ids for the step: the re-encode branch's with FastCUT."""
    n_locs = tap_locations3d(tm, A)
    if coin is None:
        return jax_patch_ids(key, n_locs, tm.cfg.num_patches)
    return jax_pair_patch_ids(key, n_locs, tm.cfg.num_patches, 2)


def images(seed, shape):
    rng = np.random.default_rng(seed)
    return [np.tanh(2 * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(2)]


def step_job(cfg, state, A, Bt, ids, coin, mesh_shape, register=False):
    n_data, n_spatial = mesh_shape
    return dict(cfg=cfg, state=state, loss=(A, Bt),
                loss_ids=ids, loss_flip=coin, batches=[(A, Bt)], lr=LR,
                patch_ids=[ids], flip=[coin], n_data=n_data,
                n_spatial=n_spatial, register=(A, Bt) if register else None)


def build(cases, base, seed, bf16_gain=BF16_GAIN, x64=False):
    """The ranks' jobs and the JAX models' inputs for ``cases`` (the
    options added to ``base``), images (2-D) or volumes (``base``'s
    ``ndims`` 3) of ``seed``."""
    side = (base["crop_size"],) * base.get("ndims", 2)
    a, b = images(seed, (2,) + side + (1,))
    A, Bt = (torch.from_numpy(to_nchw(x)) for x in (a, b))
    jobs, jax_in = {}, {}
    for name, (opts, mesh_shape, coin) in cases.items():
        cfg = dict(base, **opts)
        bf16 = cfg.get("compute_dtype") == "bfloat16"
        jm, tm, params, state = jax_and_port(cfg, bf16_gain if bf16
                                             else FLOW_GAIN)
        # the coin and the ids as JAX's step draws them: under x64 its
        # uniform draws differ
        with jax.enable_x64(x64 and not bf16):
            key = KEY if coin is None else key_with_coin(coin)
            ids = patch_ids(tm, A, coin, key)
        jobs[name] = step_job(cfg, state, A, Bt, ids, coin, mesh_shape,
                              register=bf16)
        jax_in[name] = dict(jm=jm, params=params, key=key, a=a, b=b)
    return jobs, jax_in


def start(cases, dropout, base, seed, bf16_gain=BF16_GAIN, x64=False,
          n_ranks=4):
    """Launch the ranks on ``cases`` and ``dropout`` (in a thread), then
    compute JAX's steps (and bfloat16 register) and the one-process
    references of the dropout and bfloat16 cases beside them.  ``x64``:
    JAX's float32 steps run in float64 (``jax.enable_x64``), and each
    float32 case has a float64 twin on the ranks (``<case>_float64``), the
    gradients' reference.  ``n_ranks``: the launch's, the largest mesh's.
    Returns (the setup dict, the thread pool)."""
    jobs, jax_in = build(cases, base, seed, bf16_gain, x64)
    drop, _ = build(dropout, base, seed + 1, bf16_gain)
    for job in drop.values():
        job["dropout_seed"] = DROPOUT_SEED
    twins = {f"{name}_float64": dict(job, dtype="float64", register=None)
             for name, job in jobs.items() if x64 and not bf16(name)}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * n_ranks, ([
        (name, "joint_spatial_steps", {"job": job})
        for name, job in (jobs | drop | twins).items()],), LIMIT)
    out = {"future": future, "jax": {}, "single": {}, "jobs": jobs | drop,
           "x64": x64}
    for name, j in jax_in.items():
        wide = x64 and not bf16(name)
        with jax.enable_x64(wide):
            params, a, b = j["params"], j["a"], j["b"]
            if wide:
                params, a, b = jax.tree.map(
                    lambda x: np.asarray(x, np.float64), (params, a, b))
            out["jax"][name] = jax_train_step(j["jm"], params, a, b,
                                              j["key"])
        if bf16(name):
            out["jax_register"] = [np.asarray(o) for o in j["jm"].register(
                jax.tree.map(jnp.asarray, j["params"]), jnp.asarray(j["a"]),
                jnp.asarray(j["b"]))]
    for name, job in (jobs | drop).items():
        if bf16(name) or name in drop:
            out["single"][name] = checks.joint_spatial_steps(
                None, dict(job, device="cpu"))
    return out, pool


@pytest.fixture(scope="module")
def setup():
    out, pool = start(CASES, DROPOUT, CFG32, 3)
    yield out
    pool.shutdown(wait=True)


def reports(setup, case):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    return [r[case] for r in ranks if r[case].get("in_mesh", True)]


def rank0(setup, case):
    r0, = [r for r in reports(setup, case) if r["rank"] == 0]
    return r0


def assert_metrics(got, want, tol, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, ref in want.items():
        assert abs(got[k] - ref) <= tol * abs(ref) + 1e-7, (what, k,
                                                            got[k], ref)


def assert_grads(got, want, env, what):
    """Within ``env`` of each network's max |g| (``want`` in the port's
    names)."""
    for net, ref in want.items():
        assert set(got[net]) == set(ref), (what, net)
        if not ref:         # netD in a loss_fn: no gradient on either side
            continue
        scale = max(float(torch.as_tensor(g).abs().max())
                    for g in ref.values())
        assert scale > 0, (what, net)
        for name, g in ref.items():
            err = float((got[net][name] - torch.as_tensor(g)).abs().max())
            assert err <= env * scale, (what, net, name, err, scale)


def bf16(case):
    return case.startswith("bf16")


def jax_grads(setup, case):
    """JAX's step gradients in the port's names and layouts."""
    _, mu = setup["jax"][case]
    tm = RegistrationModel(RegistrationConfig(**setup["jobs"][case]["cfg"]),
                           device="cpu")
    return port_tree(tm, mu)


# the metrics of JAX's GAN step that read netD: its loss_fn has none
READS_NETD = {"G", "G_GAN", "total", "D", "D_fake", "D_real"}


def grads_of(setup, case):
    """The case whose gradients are held against JAX's: its float64 twin
    where JAX ran in float64."""
    return f"{case}_float64" if setup["x64"] else case


def check_loss(setup, case):
    """One loss_fn on slabs: its metrics JAX's (with the GAN phase those
    that do not read netD), its gradients JAX's (bfloat16: the port's one
    process's in bfloat16; with the GAN phase, whose JAX step adds netD's
    term, none here: the step's test holds them)."""
    want, _ = setup["jax"][case]
    reps = reports(setup, case)
    job = setup["jobs"][case]
    assert len(reps) == job["n_data"] * job["n_spatial"]
    gan = is_gan(setup, case)
    if gan:
        want = {k: v for k, v in want.items() if k not in READS_NETD}
    for r in reps:
        got = {k: r["loss"][k] for k in want} if gan else r["loss"]
        assert_metrics(got, want,
                       BF16_METRIC_TOL if bf16(case) else METRIC_TOL, case)
    if bf16(case):
        assert_grads(rank0(setup, case)["loss_grads"],
                     setup["single"][case]["loss_grads"], BF16_GRAD_ENV,
                     case)
    elif not gan:
        assert_grads(rank0(setup, grads_of(setup, case))["loss_grads"],
                     jax_grads(setup, case), GRAD_ENV, case)


def check_step(setup, case):
    """One train_step: its metrics (with the GAN phase D, D_fake, D_real and
    G_GAN too) and gradients (netD's too; bfloat16: the port's one
    process's) JAX's, every rank's parameters and Adam states bit-equal
    after it, halos and gathers exchanged."""
    want, _ = setup["jax"][case]
    reps = reports(setup, case)
    if is_gan(setup, case):
        assert {"D", "D_fake", "D_real", "G_GAN"} <= set(want)
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        assert_metrics(r["metrics"][0], want,
                       BF16_METRIC_TOL if bf16(case) else METRIC_TOL, case)
    if bf16(case):
        assert_grads(rank0(setup, case)["grads"],
                     setup["single"][case]["grads"], BF16_GRAD_ENV, case)
    else:
        assert_grads(rank0(setup, grads_of(setup, case))["grads"],
                     jax_grads(setup, case), GRAD_ENV, case)


def check_bf16_register(setup, case):
    """bfloat16 register on slabs: JAX's and the port's one process's at
    the bfloat16 bars."""
    reps = sorted(reports(setup, case), key=lambda r: r["rank"])
    want = setup["jax_register"]
    single = setup["single"][case]["register"]
    assert 0.05 < float(np.abs(want[3]).max()) < 0.15     # it deforms
    for i, (name, bar) in enumerate(REGISTER_BARS.items()):
        got = torch.cat([r["register"][i] for r in reps], dim=2)
        assert got.dtype == torch.float32, name
        err = float(np.abs(to_nhwc(got) - want[i]).max())
        assert err <= bar, (name, err)
        # and against the port's one process in bfloat16, at the same bars:
        # the slabs' bfloat16 rounds elsewhere (a norm's statistics summed
        # over the ranks, a conv over a slab and its halo)
        assert float((got - single[i]).abs().max()) <= bar, name


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_with_the_option_on_slabs_matches_jax(setup, case):
    check_loss(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_train_step_with_the_option_on_slabs_matches_jax(setup, case):
    check_step(setup, case)


def test_bf16_register_on_slabs_matches_jax(setup):
    check_bf16_register(setup, "bf16_1x2")


@pytest.mark.parametrize("case", DROPOUT)
def test_dropout_on_slabs_matches_one_process(setup, case):
    """Each spatial rank keeps its rows of the whole mask from the shared
    seed: the loss, the step's metrics and its gradients are one
    process's, seeded alike; the replicas bit-equal after the step."""
    single = setup["single"][case]
    reps = reports(setup, case)
    for r in reps:
        assert_metrics(r["loss"], single["loss"], DROPOUT_METRIC_TOL, case)
        assert_metrics(r["metrics"][0], single["metrics"][0],
                       DROPOUT_METRIC_TOL, case)
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
    r0 = rank0(setup, case)
    assert_grads(r0["loss_grads"], single["loss_grads"], GRAD_ENV, case)
    assert_grads(r0["grads"], single["grads"], GRAD_ENV, case)


def test_the_dropout_masks_are_live(setup):
    """Another seed draws other masks: another loss."""
    job = setup["jobs"]["dropout_1x2"]
    other = checks.joint_spatial_steps(None, dict(
        job, dropout_seed=DROPOUT_SEED + 1, batches=[], device="cpu"))
    assert other["loss"]["total"] != setup["single"]["dropout_1x2"][
        "loss"]["total"]
