"""netG ``unet_*`` on slabs with dropout and the GAN phase, and in
bfloat16 (images split along H over ``gloo`` ranks on the CPU), against
the port's runs without slabs, which ``tests/test_torch_zoo3d_train.py``,
``tests/test_torch_zoo_bf16_netg.py`` and ``tests/test_torch_dropout.py``
hold against JAX or their own references:

- dropout + the GAN phase (netD ``basic``) on 2 x 2 (global B=2, one item
  a data rank), a UNet 6 levels deep at crop 64 (the dropout level 4 of
  ``num_downs`` 6 splits, 2 rows a slab; level 6 is gathered), against the
  same two data ranks on whole images (2 x 1): each data rank draws its
  own masks (``dropout_seed`` s + d), so one process on the whole batch
  draws other ones;
- bfloat16 (``register`` too) on 1 x 2, the UNet 4 levels deep at crop 32,
  against one process on the whole batch (``checks.joint_spatial_steps``
  with no mesh).

Each: one ``loss_fn`` (metrics and the gradients averaged over the ranks)
and one ``train_step`` (its metrics, D, D_fake, D_real and G_GAN among
them, its gradients, netD's too); the GAN runs' step gradients on float64
twins (G's GAN term reads netD after its Adam step, lr * sign(g), where
float32's spread flips parameters: ``tests/test_torch_spatial_zoo_options.
py``).  Bars: float32 metrics 1e-5 relative, gradients 1e-3 of each
network's max |g|; bfloat16 metrics 1e-2 relative, gradients 0.1 of each
network's max |g| (netG's norm-fed conv biases left out: their gradient
is 0 in exact arithmetic and rounding in bfloat16), ``register``'s fake_B
/ idt_B 0.1, y_source 1e-2, pos_flow 1e-3 max-abs; after ``train_step``
every rank's parameters and Adam states bit-equal.  One launch of 4
ranks, in a thread beside the one-process run."""

import concurrent.futures

import numpy as np
import pytest
import torch

from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from test_torch_spatial_options import (BF16_GAIN, BF16_GRAD_ENV,
                                        BF16_METRIC_TOL, REGISTER_BARS,
                                        assert_grads, assert_metrics, images,
                                        rank0, reports)
from test_torch_train import GRAD_ENV, LR
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
METRIC_TOL = 1e-5
GAIN = 3e4           # a field of about half a pixel
DROPOUT_SEED = 7
NARROW = dict(netG="unet_128", ngf=4, vxm_enc=(8, 16), vxm_dec=(16, 16, 8),
              netF_nc=16, num_patches=16, int_steps=2)
# run: (config, the UNet's depth, (n_data, n_spatial), the run it is held
# to: None for one process)
RUNS = {
    "dropout_gan_2x2": (dict(NARROW, crop_size=64, nce_layers=(0, 2, 4),
                             no_dropout=False, lambda_GAN=1.0, ndf=8),
                        6, (2, 2), "dropout_gan_2x1"),
    "bf16_1x2": (dict(NARROW, crop_size=32, nce_layers=(0, 1, 2, 3),
                      compute_dtype="bfloat16"), 4, (1, 2), None)}


def bf16(run):
    return RUNS[run][0].get("compute_dtype") == "bfloat16"


def norm_fed(downs):
    """netG's conv biases that an instance norm follows (``down_i`` for 0 <
    i < downs - 1, ``up_i`` for i >= 1): their gradient is 0 in exact
    arithmetic, and what bfloat16 computes there is rounding, most of netG's
    max |g| at this width."""
    return ({f"down_{i}.bias" for i in range(1, downs - 1)}
            | {f"up_{i}.bias" for i in range(1, downs)})


def held(grads, run):
    """The gradients a run's bar holds: in bfloat16 netG's without its
    norm-fed biases."""
    if not bf16(run):
        return grads
    skip = norm_fed(RUNS[run][1])
    return dict(grads, G={k: g for k, g in grads["G"].items()
                          if k not in skip})


def job_of(run, seed, mesh_shape=None):
    cfg, downs, shape, _ = RUNS[run]
    n_data, n_spatial = mesh_shape or shape
    side = cfg["crop_size"]
    A, Bt = (torch.from_numpy(to_nchw(x))
             for x in images(seed, (2, side, side, 1)))
    return dict(cfg=cfg, seed=seed, unet_downs=downs,
                flow_gain=BF16_GAIN if bf16(run) else GAIN, loss=(A, Bt),
                batches=[(A, Bt)], lr=LR,
                register=(A, Bt) if bf16(run) else None,
                dropout_seed=DROPOUT_SEED, n_data=n_data,
                n_spatial=n_spatial)


@pytest.fixture(scope="module")
def setup():
    jobs, refs = {}, {}
    for i, (run, (cfg, _, _, held_to)) in enumerate(RUNS.items()):
        jobs[run] = job_of(run, i)
        if held_to is not None:
            refs[held_to] = job_of(run, i, (2, 1))
    twins = {f"{run}_float64": dict(job, dtype="float64", loss=None)
             for run, job in (jobs | refs).items()
             if job["cfg"].get("lambda_GAN", 0) > 0}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, ([
        (run, "joint_spatial_steps", {"job": job})
        for run, job in (jobs | refs | twins).items()],), LIMIT)
    single = {run: checks.joint_spatial_steps(None, dict(job, device="cpu"))
              for run, job in jobs.items() if RUNS[run][3] is None}
    yield {"future": future, "jobs": jobs, "single": single}
    pool.shutdown(wait=True)


def reference(setup, run, twin=False):
    """What ``run`` is held to: one process's report, or rank 0's of the
    run without slabs (its metrics and gradients the global batch's)."""
    held_to = RUNS[run][3]
    if held_to is None:
        return setup["single"][run]
    return rank0(setup, held_to + ("_float64" if twin else ""))


def test_the_dropout_run_has_a_dropout_level():
    """The dropout run's UNet draws masks at its level 4, which splits."""
    cfg, downs, (_, n), _ = RUNS["dropout_gan_2x2"]
    assert not cfg["no_dropout"] and 4 < downs - 1
    assert (cfg["crop_size"] >> 4) % n == 0


@pytest.mark.parametrize("run", RUNS)
def test_loss_fn_on_slabs_is_the_reference(setup, run):
    """loss_fn's metrics and gradients; in bfloat16 ``register``'s slabs
    put together too."""
    ref = reference(setup, run)
    reps = reports(setup, run)
    job = setup["jobs"][run]
    assert len(reps) == job["n_data"] * job["n_spatial"]
    tol = BF16_METRIC_TOL if bf16(run) else METRIC_TOL
    for r in reps:
        assert_metrics(r["loss"], ref["loss"], tol, run)
    assert_grads(held(rank0(setup, run)["loss_grads"], run),
                 held(ref["loss_grads"], run),
                 BF16_GRAD_ENV if bf16(run) else GRAD_ENV, run)
    if bf16(run):
        reps = sorted(reps, key=lambda r: r["rank"])
        assert 0.05 < float(ref["register"][3].abs().max()) < 0.3
        for i, (name, bar) in enumerate(REGISTER_BARS.items()):
            got = torch.cat([r["register"][i] for r in reps], dim=2)
            assert got.dtype == torch.float32, name
            assert np.isfinite(got.numpy()).all(), name
            err = float((got - ref["register"][i]).abs().max())
            assert err <= bar, (run, name, err)


@pytest.mark.parametrize("run", RUNS)
def test_train_step_on_slabs_is_the_reference(setup, run):
    """The step's metrics (with the GAN phase D, D_fake, D_real, G_GAN) and
    gradients (netD's too; a GAN run's on its float64 twin); the replicas
    bit-equal after it, halos and gathers exchanged."""
    ref = reference(setup, run)
    reps = reports(setup, run)
    gan = setup["jobs"][run]["cfg"].get("lambda_GAN", 0) > 0
    if gan:
        assert {"D", "D_fake", "D_real", "G_GAN"} <= set(ref["metrics"][0])
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        assert_metrics(r["metrics"][0], ref["metrics"][0],
                       BF16_METRIC_TOL if bf16(run) else METRIC_TOL, run)
    got = rank0(setup, f"{run}_float64" if gan else run)["grads"]
    want = reference(setup, run, twin=gan)["grads"]
    if gan:
        assert set(want) == {"G", "F", "R", "D"}
    assert_grads(held(got, run), held(want, run),
                 BF16_GRAD_ENV if bf16(run) else GRAD_ENV, run)
