"""The 2-D-only generators on slabs with the StyleGAN2 discriminators,
netD ``patch`` and bfloat16 (images split along H over ``gloo`` ranks on
the CPU), against the port's one process on the whole batch
(``checks.joint_spatial_steps`` with no mesh), which
``tests/test_torch_zoo_train*.py`` and ``tests/test_torch_zoo_bf16*.py``
hold against JAX on the whole image:

- the GAN phase (netD on the gathered fake_B): ``smallstylegan2`` with
  netD ``tilestylegan2`` on 1 x 4 (crop 64: its tiles are 64 pixels),
  ``stylegan2`` with ``patchstylegan2`` on 2 x 2 (global B=2),
  ``smallstylegan2`` with ``smallpatchstylegan2`` on 1 x 2, ``stylegan2``
  with ``patch`` on 1 x 4;
- bfloat16 (``register`` too): ``resnet_cat`` on 1 x 2, ``stylegan2`` on
  1 x 4.

Each: one ``loss_fn`` (metrics and the gradients averaged over the ranks)
and one ``train_step`` (its metrics, D, D_fake, D_real and G_GAN among
them, its gradients, netD's too), on the patch ids both draw from the
model's own generator (one seed).  The GAN steps' gradients are held on
float64 twins of the runs (ranks and one process): G's GAN term is taken
against netD after its Adam update, whose first step moves each parameter
by lr * sign(g), so a netD gradient inside float32's spread flips a
parameter by 2 lr, and netG's gradient then parts from one process's by
1.7e-3 of its max |g| (smallstylegan2 with smallpatchstylegan2; 1e-13 in
float64).  The StyleGAN2 generators' fields are
about a third of a pixel (the flow head times ``GAIN``: no exact zero in
y_source, whose zero tap would give netF's L2 norm its 1/eps derivative),
resnet_cat's at ngf 10 (``tests/test_torch_spatial_zoo.py``), the
bfloat16 runs' about 0.1 px (``BF16_GAIN``, the premise of the pos_flow
bar).

Bars: float32 metrics 1e-5 relative, gradients 1e-3 of each network's max
|g|; bfloat16 metrics 1e-2 relative, gradients 0.1 of each network's max
|g|, ``register``'s fake_B / idt_B 0.1, y_source 1e-2, pos_flow 1e-3
max-abs (``tests/test_torch_spatial_options.py``'s bfloat16 bars); after
``train_step`` every rank's parameters and Adam states bit-equal.  One
launch of 4 ranks, in a thread beside the one-process runs."""

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
from test_torch_spatial_zoo import BASE
from test_torch_train import GRAD_ENV, LR
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 400.0
METRIC_TOL = 1e-5
GAIN = 1e4           # a field of about a third of a pixel
GAN = dict(lambda_GAN=1.0, ndf=8)
SG = dict(BASE, crop_size=32, ngf=2, nce_layers=(1, 2, 3))
BF16 = dict(compute_dtype="bfloat16")
# case: (config, (n_data, n_spatial))
CASES = {
    "smallstylegan2_tile_1x4": (dict(SG, **GAN, netG="smallstylegan2",
                                     netD="tilestylegan2", crop_size=64),
                                (1, 4)),
    "stylegan2_patchstylegan2_2x2": (dict(SG, **GAN, netG="stylegan2",
                                          netD="patchstylegan2"), (2, 2)),
    "smallstylegan2_smallpatch_1x2": (dict(SG, **GAN, netG="smallstylegan2",
                                           netD="smallpatchstylegan2"),
                                      (1, 2)),
    "stylegan2_patch_1x4": (dict(SG, **GAN, netG="stylegan2", netD="patch"),
                            (1, 4)),
    "resnet_cat_bf16_1x2": (dict(BASE, **BF16, crop_size=32, ngf=10,
                                 netG="resnet_cat", nce_layers=(0, 1, 2, 3)),
                            (1, 2)),
    "stylegan2_bf16_1x4": (dict(SG, **BF16, netG="stylegan2"), (1, 4))}


def bf16(case):
    return CASES[case][0].get("compute_dtype") == "bfloat16"


def gan(case):
    return CASES[case][0].get("lambda_GAN", 0) > 0


def job_of(case, seed):
    cfg, (n_data, n_spatial) = CASES[case]
    side = cfg["crop_size"]
    A, Bt = (torch.from_numpy(to_nchw(x))
             for x in images(seed, (2, side, side, 1)))
    return dict(cfg=cfg, seed=seed, flow_gain=BF16_GAIN if bf16(case)
                else GAIN, loss=(A, Bt), batches=[(A, Bt)], lr=LR,
                register=(A, Bt) if bf16(case) else None, n_data=n_data,
                n_spatial=n_spatial)


def step_grads_of(case):
    """The run whose step gradients are held: the float64 twin of a GAN
    run."""
    return f"{case}_float64" if gan(case) else case


@pytest.fixture(scope="module")
def setup():
    jobs = {case: job_of(case, i) for i, case in enumerate(CASES)}
    twins = {step_grads_of(case): dict(job, dtype="float64", loss=None)
             for case, job in jobs.items() if gan(case)}
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, ([
        (case, "joint_spatial_steps", {"job": job})
        for case, job in (jobs | twins).items()],), LIMIT)
    single = {case: checks.joint_spatial_steps(None, dict(job, device="cpu"))
              for case, job in (jobs | twins).items()}
    yield {"future": future, "jobs": jobs, "single": single}
    pool.shutdown(wait=True)


def check_bf16_register(setup, case):
    reps = sorted(reports(setup, case), key=lambda r: r["rank"])
    single = setup["single"][case]["register"]
    assert 0.05 < float(single[3].abs().max()) < 0.3      # it deforms
    for i, (name, bar) in enumerate(REGISTER_BARS.items()):
        got = torch.cat([r["register"][i] for r in reps], dim=2)
        assert got.dtype == torch.float32, name
        assert float((got - single[i]).abs().max()) <= bar, (case, name)
        assert np.isfinite(got.numpy()).all(), name


@pytest.mark.parametrize("case", CASES)
def test_loss_fn_and_register_on_slabs_are_one_process(setup, case):
    """loss_fn's metrics and gradients one process's; in bfloat16
    ``register``'s slabs put together too (one test a case for both: a
    slow file of more than 12 tests would start before the suite's slowest
    JAX file)."""
    if bf16(case):
        check_bf16_register(setup, case)
    single = setup["single"][case]
    reps = reports(setup, case)
    job = setup["jobs"][case]
    assert len(reps) == job["n_data"] * job["n_spatial"]
    for r in reps:
        assert_metrics(r["loss"], single["loss"],
                       BF16_METRIC_TOL if bf16(case) else METRIC_TOL, case)
    assert_grads(rank0(setup, case)["loss_grads"], single["loss_grads"],
                 BF16_GRAD_ENV if bf16(case) else GRAD_ENV, case)


@pytest.mark.parametrize("case", CASES)
def test_train_step_on_slabs_is_one_process(setup, case):
    """The step's metrics (with the GAN phase D, D_fake, D_real, G_GAN) and
    gradients (netD's too) one process's; the replicas bit-equal after it,
    netD's fake_B gathered."""
    single = setup["single"][case]
    reps = reports(setup, case)
    if gan(case):
        assert {"D", "D_fake", "D_real", "G_GAN"} <= set(single["metrics"][0])
        assert set(single["grads"]) == {"G", "F", "R", "D"}
    for r in reps:
        assert torch.equal(r["checksums"][0], reps[0]["checksums"][0])
        assert r["bytes_sent"][0]["halo"] > 0 and r["bytes_sent"][0][
            "gather"] > 0, r["bytes_sent"]
        assert_metrics(r["metrics"][0], single["metrics"][0],
                       BF16_METRIC_TOL if bf16(case) else METRIC_TOL, case)
    held = step_grads_of(case)
    assert_grads(rank0(setup, held)["grads"], setup["single"][held]["grads"],
                 BF16_GRAD_ENV if bf16(case) else GRAD_ENV, case)
