"""netG ``unet_*`` on slabs (images split along H, volumes along D, over
``gloo`` CPU ranks) against the JAX RegistrationModel's whole-image step,
from the port's initial weights carried to JAX
(``tests/test_torch_zoo3d_train.py``'s ``jax_params``; the flow head times
``GAIN``), on JAX's patch ids.  The UNet is 4 levels deep
(``UNET_DOWNS``; JAX's netG attribute swapped, the port's ranks given
``unet_downs`` in their job), ngf 4, taps 0,1,2,3:

- 2-D at crop 32 on 1 x 2 (every level splits, the innermost 1 row a
  slab) and 1 x 4 (level 3 splits into 1 row a slab, level 4 is
  gathered, tap 3 whole);
- 3-D at 16^3 on 1 x 2 (level 4 gathered, tap 3 whole);
- the real ``unet_128`` (7 levels) at crop 128, ngf 2, on 1 x 2: its
  ``register`` (level 7, one row, gathered).

Each shallow case: ``register`` (the slabs put together against JAX's,
1e-4 max-abs), one ``loss_fn`` and ``eval_step`` (their metrics
1e-4 relative of JAX's step, run in float64 under ``jax.enable_x64``; the
loss's gradients within 1e-3 of each network's max |g|), one
``train_step`` (its metrics 1e-4, every rank's parameters and Adam states
bit-equal after it, halos and gathers exchanged), and a float64 twin of
the case on the ranks, whose ``loss_fn`` metrics are held within 1e-8
relative and its gradients within 1e-8 of each network's and each
tensor's max |g| of the port's float64 one process on the whole batch
(the bar that sees a gathered level's gradient counted other than once),
and JAX's float64 step within ``JAX64_METRIC_TOL`` / ``JAX64_GRAD_ENV``:
JAX's engine rounds netG's output and taps to float32 even under
``jax.enable_x64``, so its float64 step is no closer than that to a
float64 one.  The real ``unet_128``'s ``register`` against JAX's, 1e-4
max-abs.  JAX compiles one step and one ``register`` a configuration,
each with LLVM at -O0 (``FAST_COMPILE``: an eager ``register`` took
15-21 s a configuration on an 8-core CPU, its compile 1-1.5 s).  One
launch of 4 ranks, in a thread beside JAX."""

import concurrent.futures
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_spatial_options import (FAST_COMPILE, METRIC_TOL,
                                        assert_grads, assert_metrics, images,
                                        jax_train_step, patch_ids, rank0,
                                        reports, step_job)
from test_torch_spatial_zoo import put_together
from test_torch_train import GRAD_ENV, KEY
from test_torch_zoo3d_train import (UNET_DOWNS, jax_model, jax_params,
                                    shallow_unet)
from test_torch_zoo_train import port_tree
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
REGISTER_TOL = 1e-4
F64_TOL = 1e-8
# JAX's float64 step rounds netG's output and taps to float32 (its
# engine's ``astype(jnp.float32)``), compiled here at FAST_COMPILE: 1.4e-6
# relative (smooth, 3-D) and 1.6e-5 of netG's max |g| from the port's
# float64 step
JAX64_METRIC_TOL = 1e-5
JAX64_GRAD_ENV = 1e-4
NARROW = dict(netG="unet_128", ngf=4, nce_layers=(0, 1, 2, 3),
              vxm_enc=(8, 16), vxm_dec=(16, 16, 8), netF_nc=16,
              num_patches=16, int_steps=2)
CONFIGS = {
    "2d": dict(NARROW, crop_size=32),
    "3d": dict(NARROW, ndims=3, crop_size=16, vxm_enc=(4, 4, 4),
               vxm_dec=(4, 4, 4, 4, 4))}
# the flow head's gain: a field of about half a pixel (voxel), short of
# the image's ends, where y_source's exact zeros would make a zero tap
GAIN = {"2d": 3e4, "3d": 3e4}
# case: (its config, (n_data, n_spatial))
CASES = {"2d_1x2": ("2d", (1, 2)), "2d_1x4": ("2d", (1, 4)),
         "3d_1x2": ("3d", (1, 2))}
REAL = dict(NARROW, ngf=2, crop_size=128, nce_layers=(0, 2, 4, 6))


def carried(cfg, gain, shallow=True):
    """JAX's model (its UNet ``UNET_DOWNS`` levels deep where
    ``shallow``) and the port's initial weights (the flow head times
    ``gain``) as JAX's params (numpy) and as the port's state dicts, and
    the port's model."""
    jm = jax_model(cfg) if shallow else JaxModel(JaxConfig(**cfg))
    with shallow_unet(cfg) if shallow else contextlib.nullcontext():
        tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    with torch.no_grad():
        tm.netR.flow.weight.mul_(gain)
    params = jax_params(cfg, tm, shapes)
    # copies: a launch moves the tensors it sends into shared memory
    state = {k: {n: v.clone() for n, v in net.state_dict().items()}
             for k, net in (("G", tm.netG), ("F", tm.netF), ("R", tm.netR))}
    return jm, tm, params, state


def jax_register(jm, params, a, b):
    """JAX's ``register``, compiled at ``FAST_COMPILE`` (1-1.5 s a config
    on an 8-core CPU, where eager calls took 15-21 s)."""
    args = ({k: jax.tree.map(jnp.asarray, params[k]) for k in "GFR"},
            jnp.asarray(a), jnp.asarray(b))
    run = type(jm).register.lower(jm, *args).compile(FAST_COMPILE)
    return [np.asarray(o) for o in run(*args)]


@pytest.fixture(scope="module")
def setup():
    jobs, inputs = {}, {}
    for name, cfg in CONFIGS.items():
        jm, tm, params, state = carried(cfg, GAIN[name])
        side = (cfg["crop_size"],) * cfg.get("ndims", 2)
        a, b = images(11, (2,) + side + (1,))
        A, Bt = (torch.from_numpy(to_nchw(x)) for x in (a, b))
        with jax.enable_x64(True):          # the ids JAX's x64 step draws
            ids = patch_ids(tm, A, None, KEY)
        inputs[name] = (jm, tm, params, a, b)
        for case, (family, mesh_shape) in CASES.items():
            if family == name:
                jobs[case] = dict(step_job(cfg, state, A, Bt, ids, None,
                                           mesh_shape, register=True),
                                  eval=True, unet_downs=UNET_DOWNS)
    twins = {f"{case}_float64": dict(job, dtype="float64", register=None,
                                     eval=False, batches=[])
             for case, job in jobs.items()}
    jm_real, _, params_real, state_real = carried(REAL, GAIN["2d"],
                                                  shallow=False)
    a_real, b_real = images(12, (2, 128, 128, 1))
    real = dict(cfg=REAL, state=state_real, n_data=1, n_spatial=2,
                register=tuple(torch.from_numpy(to_nchw(x))
                               for x in (a_real, b_real)))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, ([
        (case, "joint_spatial_steps", {"job": job})
        for case, job in (jobs | twins | {"real_1x2": real}).items()],),
        LIMIT)
    # the twins' reference: one process in float64 on the whole batch
    out = {"future": future, "jobs": jobs, "jax": {}, "jax_register": {},
           "tm": {}, "single64": {
               case: checks.joint_spatial_steps(None, dict(twin,
                                                           device="cpu"))
               for case, twin in twins.items()}}
    for name, (jm, tm, params, a, b) in inputs.items():
        with jax.enable_x64(True):
            step = jax_train_step(jm, *jax.tree.map(
                lambda x: np.asarray(x, np.float64), (params, a, b)), KEY,
                fast=True)
        register = jax_register(jm, params, a, b)
        for case, (family, _) in CASES.items():
            if family == name:
                out["jax"][case] = step
                out["jax_register"][case] = register
                out["tm"][case] = tm
    out["jax_register"]["real_1x2"] = jax_register(jm_real, params_real,
                                                     a_real, b_real)
    yield out
    pool.shutdown(wait=True)


def jax_grads(setup, case):
    """JAX's step gradients (g = 2 mu) in the port's names and layouts."""
    return port_tree(setup["tm"][case], setup["jax"][case][1])


@pytest.mark.parametrize("case", [*CASES, "real_1x2"])
def test_register_on_slabs_matches_jax(setup, case):
    reps = reports(setup, case)
    want = setup["jax_register"][case]
    assert 0.2 < float(np.abs(want[3]).max()) < 1.0      # it deforms
    for i, name in enumerate(("fake_B", "idt_B", "y_source", "pos_flow")):
        got = put_together(reps, i)
        assert got.shape[2] == want[i].shape[1], name
        err = float(np.abs(to_nhwc(got) - want[i]).max())
        assert err <= REGISTER_TOL, (case, name, err)


def grad_errs(got, want):
    """{net: (max error over the network's max |g|, max error of a tensor
    over its own max |g|)}, ``want`` in the port's names."""
    out = {}
    for net, ref in want.items():
        assert set(got[net]) == set(ref), net
        scale = max(float(torch.as_tensor(g).abs().max())
                    for g in ref.values())
        errs = {k: (float((got[net][k] - torch.as_tensor(g)).abs().max()),
                    float(torch.as_tensor(g).abs().max()))
                for k, g in ref.items()}
        out[net] = (max(e for e, _ in errs.values()) / scale,
                    max(e / m for e, m in errs.values() if m > 1e-6 * scale))
    return out


def check_float64(setup, case):
    """The float64 twin: loss_fn's metrics within F64_TOL relative and its
    gradients within F64_TOL of each network's and each tensor's max |g|
    of the port's float64 one process on the whole batch (a gathered
    level's conv, whose forward and backward every spatial rank runs
    whole, counted once; a whole tap's samples taken once), and JAX's
    float64 step within JAX64_METRIC_TOL / JAX64_GRAD_ENV."""
    want, _ = setup["jax"][case]
    twin = f"{case}_float64"
    single = setup["single64"][twin]
    for r in reports(setup, twin):
        for k, ref in single["loss"].items():
            assert abs(r["loss"][k] - ref) <= F64_TOL * abs(ref), (case, k)
        errs = {k: abs(r["loss"][k] - ref) / abs(ref)
                for k, ref in want.items()}
        assert max(errs.values()) <= JAX64_METRIC_TOL, (case, errs)
    got = rank0(setup, twin)["loss_grads"]
    for net, (whole, each) in grad_errs(got, single["loss_grads"]).items():
        assert whole <= F64_TOL and each <= F64_TOL, (case, net, whole,
                                                      each)
    errs = grad_errs(got, jax_grads(setup, case))
    assert max(w for w, _ in errs.values()) <= JAX64_GRAD_ENV, (case, errs)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_eval_step_on_slabs_match_jax(setup, case):
    """loss_fn's and eval_step's metrics (the whole image's on every rank)
    and loss_fn's gradients, in float32, against JAX's float64 step; the
    float64 twin's (``check_float64``; one test a case for both: a slow
    file of more than 12 tests would start before the suite's slowest
    JAX file)."""
    want, _ = setup["jax"][case]
    reps = reports(setup, case)
    assert len(reps) == np.prod(CASES[case][1])
    for r in reps:
        assert_metrics(r["loss"], want, METRIC_TOL, case)
        assert_metrics(r["eval"], want, METRIC_TOL, case)
    assert_grads(rank0(setup, case)["loss_grads"], jax_grads(setup, case),
                 GRAD_ENV, case)
    check_float64(setup, case)


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_slabs_matches_jax(setup, case):
    """One train_step: its metrics JAX's, every rank's parameters and Adam
    states bit-equal after it, halos and gathers exchanged."""
    want, _ = setup["jax"][case]
    reps = reports(setup, case)
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        assert_metrics(r["metrics"][0], want, METRIC_TOL, case)
