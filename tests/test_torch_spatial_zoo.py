"""The 2-D-only generators on slabs (images split along H over ``gloo``
ranks on the CPU) against the JAX RegistrationModel's whole-image step,
one JAX config a family, each compiled once, from the port's initial
weights carried to JAX (``tests/test_torch_zoo_train.py``'s
``flax_from_port``; netR by JAX's ``convert_netR``, netF's Dense layers
by hand; the flow head times ``GAIN``), on JAX's patch ids:

- ``resnet_cat`` (netF mlp_sample, netR vxm) at crop 32 on 1 x 2 and 1 x
  4, at ngf 10: the narrowest at which no sampled location of its ReLU
  taps is all zero here (at 4 and 8 one is, and JAX's netF gradients are
  NaN there: its L2 norm's square root at 0);
- ``stylegan2`` with netD ``stylegan2`` and the GAN phase at crop 64 (the
  netD's ``linear_0`` reads a side of ``_disc_out_size(crop, 6)``, 0 at
  crop 32), ngf 2, on 1 x 2 and 2 x 2 (global B=2, one item a data rank),
  its field about a third of a pixel: a field of a pixel or more samples
  past the image's ends, y_source then holds exact zeros, from_rgb's 1x1
  conv (zero bias) maps such a pixel to a zero tap, and netF's MLP to a
  zero sample, where JAX's netF gradients are NaN.

Each: ``register`` (the slabs put together against JAX's, 1e-4 max-abs),
one ``loss_fn`` (metrics 1e-4 relative, with the GAN phase those that do
not read netD; gradients within 1e-3 of each network's max |g|),
``eval_step`` (its metrics the loss's), and one ``train_step`` (metrics,
D, D_fake, D_real and G_GAN among them, and gradients, netD's too, against
JAX's, g = 2 mu at beta1 0.5; every rank's parameters and Adam states
bit-equal after it).  For resnet_cat JAX's step and register run in
float64 (``jax.enable_x64``), and the gradients are held on each case's
float64 twin on the ranks: its first conv, which an instance norm
follows, has a weight gradient that float32 computes to 5.3e-3 of netG's
max |g| in JAX's own step (against float64), 2e-3 on slabs and 1.1e-5 in
the port's one process, past any bar of 1e-3.  JAX's StyleGAN2 cannot
run in float64 (its blur kernels are float32 constants), and its nets
have no norm: its step is held in float32.  One launch of 4 ranks, in
a thread beside the JAX compiles."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_spatial_options import (METRIC_TOL, READS_NETD,
                                        assert_grads, assert_metrics,
                                        check_loss, grads_of, images,
                                        jax_grads, jax_train_step, patch_ids,
                                        rank0, reports, step_job)
from test_torch_train import FLOW_GAIN, GRAD_ENV, KEY
from test_torch_zoo_train import flax_from_port
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 400.0
REGISTER_TOL = 1e-4
BASE = dict(vxm_enc=(8, 16), vxm_dec=(16, 16, 8), netF_nc=16,
            num_patches=16, int_steps=2)
CONFIGS = {
    "resnet_cat": dict(BASE, crop_size=32, ngf=10, netG="resnet_cat",
                       nce_layers=(0, 1, 2, 3)),
    "stylegan2_gan": dict(BASE, crop_size=64, ngf=2, netG="stylegan2",
                          nce_layers=(1, 2, 3), lambda_GAN=1.0, ndf=8,
                          netD="stylegan2")}
# the configs whose reference is JAX's step in float64
X64 = {"resnet_cat": True, "stylegan2_gan": False}
# the flow head's gain: a field of about 1.5 px and 0.35 px
GAIN = {"resnet_cat": FLOW_GAIN, "stylegan2_gan": 1e4}
# case: (its config, (n_data, n_spatial))
CASES = {"resnet_cat_1x2": ("resnet_cat", (1, 2)),
         "resnet_cat_1x4": ("resnet_cat", (1, 4)),
         "stylegan2_gan_1x2": ("stylegan2_gan", (1, 2)),
         "stylegan2_gan_2x2": ("stylegan2_gan", (2, 2))}


def flax_netF(netF):
    """PatchSampleF's MLPs as JAX's tree (``mlp_<i>_<j>`` Dense layers):
    the inverse of ``compat/convert.py``'s map."""
    return {f"mlp_{i}_{j}": {
        "kernel": getattr(netF, f"mlp_{i}")[2 * j].weight.detach().numpy().T,
        "bias": getattr(netF, f"mlp_{i}")[2 * j].bias.detach().numpy()}
        for i in range(netF.n_layers) for j in (0, 1)}


def carried(cfg, gain):
    """JAX's model and the port's initial weights (the flow head times
    ``gain``) as JAX's params (numpy) and as the port's state dicts."""
    jm = JaxModel(JaxConfig(**cfg))
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    tm = RegistrationModel(RegistrationConfig(**cfg), device="cpu")
    with torch.no_grad():
        tm.netR.flow.weight.mul_(gain)
    params = {"G": flax_from_port(tm.netG, shapes["G"]),
              "F": flax_netF(tm.netF),
              "R": jax_convert.convert_netR(tm.netR.state_dict(),
                                            cfg["vxm_enc"], cfg["vxm_dec"])}
    nets = {"G": tm.netG, "F": tm.netF, "R": tm.netR}
    if tm.netD is not None:
        params["D"] = flax_from_port(tm.netD, shapes["D"])
        nets["D"] = tm.netD
    params = jax.tree.map(lambda x: np.array(x, dtype=np.float32), params)
    # copies: a launch moves the tensors it sends into shared memory
    state = {k: {n: v.clone() for n, v in net.state_dict().items()}
             for k, net in nets.items()}
    return jm, tm, params, state


@pytest.fixture(scope="module")
def setup():
    jobs, inputs = {}, {}
    for name, cfg in CONFIGS.items():
        jm, tm, params, state = carried(cfg, GAIN[name])
        a, b = images(5, (2, cfg["crop_size"], cfg["crop_size"], 1))
        A, Bt = (torch.from_numpy(to_nchw(x)) for x in (a, b))
        with jax.enable_x64(X64[name]):   # the ids JAX's step draws
            ids = patch_ids(tm, A, None, KEY)
        inputs[name] = (jm, params, a, b)
        for case, (family, mesh_shape) in CASES.items():
            if family == name:
                jobs[case] = dict(step_job(cfg, state, A, Bt, ids, None,
                                           mesh_shape, register=True),
                                  eval=True)
    twins = {f"{case}_float64": dict(job, dtype="float64", register=None,
                                     eval=False)
             for case, job in jobs.items() if X64[CASES[case][0]]}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, ([
        (case, "joint_spatial_steps", {"job": job})
        for case, job in (jobs | twins).items()],), LIMIT)
    out = {"future": future, "jobs": jobs, "jax": {}, "jax_register": {}}
    for name, (jm, params, a, b) in inputs.items():
        with jax.enable_x64(X64[name]):
            if X64[name]:
                params, a, b = jax.tree.map(
                    lambda x: np.asarray(x, np.float64), (params, a, b))
            step = jax_train_step(jm, params, a, b, KEY)
            register = [np.asarray(o) for o in jm.register(
                jax.tree.map(jnp.asarray, params), jnp.asarray(a),
                jnp.asarray(b))]
        for case, (family, _) in CASES.items():
            if family == name:
                out["jax"][case] = step
                out["jax_register"][case] = register
    yield out
    pool.shutdown(wait=True)


def view(setup, case):
    """``setup`` as ``tests/test_torch_spatial_options.py``'s checks
    read it for ``case``: with its family's ``x64``."""
    return dict(setup, x64=X64[CASES[case][0]])


def put_together(reps, i):
    """Output ``i`` of the ranks' ``register``, each a slab of its data
    rank's items: the slabs along H, the data ranks along the batch."""
    by_data = {}
    for r in sorted(reps, key=lambda r: (r["data_rank"], r["spatial_rank"])):
        by_data.setdefault(r["data_rank"], []).append(r["register"][i])
    return torch.cat([torch.cat(s, dim=2) for s in by_data.values()], dim=0)


@pytest.mark.parametrize("case", CASES)
def test_register_on_slabs_matches_jax(setup, case):
    reps = reports(setup, case)
    want = setup["jax_register"][case]
    assert float(np.abs(want[3]).max()) > 0.3        # the field deforms
    for i, name in enumerate(("fake_B", "idt_B", "y_source", "pos_flow")):
        got = put_together(reps, i)
        err = float(np.abs(to_nhwc(got) - want[i]).max())
        assert err <= REGISTER_TOL, (case, name, err)


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_eval_step_on_slabs_match_jax(setup, case):
    """loss_fn's metrics and gradients, and eval_step's metrics (the whole
    image's and global batch's on every rank), JAX's loss.  (One test a
    case for both: a slow file of more than 12 tests would start before
    the suite's slowest JAX file.)"""
    check_loss(view(setup, case), case)
    want, _ = setup["jax"][case]
    gan = CONFIGS[CASES[case][0]].get("lambda_GAN", 0) > 0
    want = {k: v for k, v in want.items()
            if not (gan and k in READS_NETD)}
    for r in reports(setup, case):
        got = {k: r["eval"][k] for k in want}
        assert_metrics(got, want, METRIC_TOL, case)


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_slabs_matches_jax(setup, case):
    """One train_step: its metrics (with the GAN phase D, D_fake, D_real
    and G_GAN too) and gradients (netD's too) JAX's, every rank's
    parameters and Adam states bit-equal after it, halos and gathers
    exchanged.  StyleGAN2's noise weights, which no path reads (no noise is
    drawn), get no gradient on the ranks and JAX's zero."""
    setup = view(setup, case)
    want, _ = setup["jax"][case]
    reps = reports(setup, case)
    if CONFIGS[CASES[case][0]].get("lambda_GAN", 0) > 0:
        assert {"D", "D_fake", "D_real", "G_GAN"} <= set(want)
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        assert_metrics(r["metrics"][0], want, METRIC_TOL, case)
    got = rank0(setup, grads_of(setup, case))["grads"]
    ref = jax_grads(setup, case)
    for net, gs in ref.items():
        unread = set(gs) - set(got[net])
        assert all(k.endswith("noise.weight")
                   and not torch.as_tensor(gs[k]).any()
                   for k in unread), (case, net, unread)
        ref[net] = {k: g for k, g in gs.items() if k not in unread}
    assert_grads(got, ref, GRAD_ENV, case)
