"""The training options' slab forms, each against the whole-tensor op
(``parallel/mesh.py``'s spatial axis: H at 2-D, D at 3-D), on ``gloo`` CPU
ranks (one launch of 4 ranks: 2-D on 1 x 2 and 1 x 4, 3-D on 1 x 2, the
all-negatives keys on 2 x 2):

- ``conv_transpose_slab`` (``no_antialias_up``'s kernel 3, stride 2,
  padding 1, output padding 1), float32 at 2-D and 3-D and bfloat16 at
  2-D: the whole transposed conv's rows, bit for bit, and its gradients;
- ``Dropout`` on a slab: the whole mask's rows, bit for bit, from one
  generator seed;
- ``discriminate`` + ``gan_loss``: NLayer (``basic``, ``n_layers``) on
  the gathered image and ``pixel`` on the slab.  The loss is the whole
  image's on every rank; each slab's input gradient is the spatial ranks'
  sum, n_spatial times the whole image's rows, the module's convention
  (each rank's gradient ``world`` times its share, as the patch samples'
  in ``joint_slab_pieces``), not the rows alone; netD's gradient, averaged
  over the ranks, the whole image's (within 1e-5 of the network's max
  |g|): counted once a data rank;
- ``all_gather_data``: the keys of the data ranks alone, the whole batch's
  once (not n_spatial times), and PatchNCE with all negatives on them the
  whole batch's per-patch losses;
- bfloat16 through gloo: a halo and a gather bit for bit, a sum of the
  spatial ranks' slabs added in float32 and rounded once; netR's UNet in
  bfloat16 with its coarse levels gathered (at 2-D over 4 ranks, its
  fourth level 2 rows: gathered) against the whole UNet in bfloat16, at
  the bfloat16 bar of a map (1e-2 of its max |x|), its input's gradient
  at 5e-2 of its max |g|.

In-process: every option that has a slab form is taken by a spatial
mesh (``SLAB_REFUSALS`` refuses the rest by name,
``tests/test_torch_spatial_joint_units.py``).

Bars: values 1e-5 max-abs, gradients 1e-5 of their max |g|, where not bit
for bit."""

import concurrent.futures

import pytest
import torch

from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import (SLAB_REFUSALS,
                                                 RegistrationModel)
from dfmir_tpu_torch.losses.gan import gan_loss
from dfmir_tpu_torch.losses.nce import patch_nce_loss
from dfmir_tpu_torch.nets.discriminators import discriminate
from dfmir_tpu_torch.nets.factory import define_D
from dfmir_tpu_torch.nets.layers import conv_transpose_nd
from dfmir_tpu_torch.nets.resnet_gen import Dropout
from dfmir_tpu_torch.nets.vxm import VxmUnet
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import Mesh, first_whole_level
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
TOL = 1e-5
NETDS = {2: {"basic": dict(netD="basic"),
             "n_layers": dict(netD="n_layers", n_layers_D=2),
             "pixel": dict(netD="pixel")},
         3: {"n_layers": dict(netD="n_layers", n_layers_D=2),
             "pixel": dict(netD="pixel")}}
# case: (ndims, n_data, n_spatial)
CASES = {"2d_1x2": (2, 1, 2), "2d_1x4": (2, 1, 4), "3d_1x2": (3, 1, 2)}
SMALL = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
             vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
# every option with a slab form, and the config that shows it
LIFTED = {"bf16": dict(compute_dtype="bfloat16"),
          "fastcut": dict(flip_equivariance=True, nce_idt=False,
                          lambda_NCE=10.0),
          "dropout": dict(no_dropout=False),
          "gan_basic": dict(lambda_GAN=1.0, ndf=8),
          "gan_n_layers": dict(lambda_GAN=1.0, ndf=8, netD="n_layers",
                               n_layers_D=2),
          "gan_pixel": dict(lambda_GAN=1.0, ndf=8, netD="pixel"),
          "no_antialias_up": dict(no_antialias_up=True),
          "all_negatives": dict(
              nce_includes_all_negatives_from_minibatch=True)}


def rand(gen, *shape):
    return torch.randn(shape, generator=gen)


def inputs(ndims, seed):
    """The global tensors of one case: B=2, 8 rows along the split axis."""
    g = torch.Generator().manual_seed(seed)
    side = (8,) * ndims if ndims == 3 else (8, 6)
    big = (16,) * 3 if ndims == 3 else (32, 32)
    job = {"convT": {}, "netD": {}, "dropout_seed": 5 + seed,
           "x_drop": rand(g, 2, 4, *side)}
    for dtype in ((torch.float32, torch.bfloat16) if ndims == 2
                  else (torch.float32,)):
        conv = conv_transpose_nd(4, 3, ndims=ndims, generator=g).to(dtype)
        job["convT"][str(dtype).split(".")[1]] = (
            conv, rand(g, 2, 4, *side).to(dtype),
            rand(g, 2, 3, *(2 * s for s in side)).to(dtype))
    for name, kw in NETDS[ndims].items():
        netD = define_D(input_nc=1, ndf=8, ndims=ndims, generator=g, **kw)
        job["netD"][name] = (netD, torch.tanh(rand(g, 2, 1, *big)))
    job["x_bf16"] = rand(g, 2, 3, *side).to(torch.bfloat16)
    if ndims == 2:
        unet = VxmUnet((8, 8, 8, 8), (8, 8, 8, 8, 8, 8), ndims=2,
                       generator=g).to(torch.bfloat16)
        job["unet_bf16"] = (unet, rand(g, 2, 2, 32, 16).to(torch.bfloat16),
                            rand(g, 2, 8, 32, 16).to(torch.bfloat16))
    return job


def keys_job(seed):
    g = torch.Generator().manual_seed(seed)
    keys, queries = rand(g, 2, 16, 8), rand(g, 2, 16, 8)
    return {"keys": keys / keys.norm(dim=-1, keepdim=True),
            "queries": queries / queries.norm(dim=-1, keepdim=True)}


@pytest.fixture(scope="module")
def setup():
    jobs = {name: inputs(nd, i) for i, (name, (nd, _, _)) in
            enumerate(CASES.items())}
    jobs["keys_2x2"] = keys_job(9)
    cases = [(name, "option_slab_pieces", {
        "n_spatial": CASES[name][2], "n_data": CASES[name][1],
        "job": jobs[name]}) for name in CASES]
    cases.append(("keys_2x2", "option_slab_pieces", {
        "n_spatial": 2, "n_data": 2, "job": jobs["keys_2x2"]}))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)
    yield {"future": future, "jobs": jobs}
    pool.shutdown(wait=True)


def reports(setup, case):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    return sorted((r[case] for r in ranks if r[case].get("in_mesh", True)),
                  key=lambda r: (r["data_rank"], r["spatial_rank"]))


def rows(t, r, n):
    k = t.shape[2] // n
    return t.narrow(2, r * k, k)


def close(got, want, tol=TOL):
    """Values: within ``tol`` max-abs (of their max |x| past 1)."""
    return float((got.double() - want.double()).abs().max()) <= tol * max(
        float(want.abs().max()), 1.0)


def close_g(got, want, tol=TOL):
    """Gradients: within ``tol`` of their max |g|."""
    scale = float(want.abs().max())
    assert scale > 0
    return float((got.double() - want.double()).abs().max()) <= tol * scale


@pytest.mark.parametrize("case", CASES)
def test_conv_transpose_slab_is_the_whole_convs_rows(setup, case):
    reps = reports(setup, case)
    n = CASES[case][2]
    for dtype, (conv, x, w) in setup["jobs"][case]["convT"].items():
        conv.zero_grad(set_to_none=True)
        v = x.clone().requires_grad_(True)
        y = conv(v)
        (y * w).sum().backward()
        assert y.shape[2] == 2 * x.shape[2]
        param_sum = {k: 0 for k, _ in conv.named_parameters()}
        for r in reps:
            got, dx, dparams = r[f"convT_{dtype}"]
            s = r["spatial_rank"]
            assert got.dtype == x.dtype
            assert torch.equal(got, rows(y.detach(), s, n)), (dtype, s)
            assert close_g(dx, rows(v.grad, s, n),
                           TOL if dtype == "float32" else 1e-2), (dtype, s)
            for k in param_sum:
                param_sum[k] = param_sum[k] + dparams[k].double()
        # the ranks' parameter gradients add up to the whole conv's
        for k, p in conv.named_parameters():
            assert close_g(param_sum[k], p.grad,
                           TOL if dtype == "float32" else 3e-2), (dtype, k)


@pytest.mark.parametrize("case", CASES)
def test_a_slabs_dropout_mask_is_the_whole_masks_rows(setup, case):
    job = setup["jobs"][case]
    whole = Dropout()(job["x_drop"],
                      torch.Generator().manual_seed(job["dropout_seed"]))
    assert 0.3 < float((whole == 0).float().mean()) < 0.7
    n = CASES[case][2]
    for r in reports(setup, case):
        assert torch.equal(r["dropout"], rows(whole, r["spatial_rank"], n))


@pytest.mark.parametrize("case", CASES)
def test_netD_on_slabs_is_the_whole_images(setup, case):
    """The G phase's GAN loss on slabs: the whole image's loss on every
    rank; each slab's input gradient n_spatial times the whole gradient's
    rows; netD's gradient, averaged over the ranks, the whole image's."""
    n = CASES[case][2]
    reps = reports(setup, case)
    for name, (netD, x) in setup["jobs"][case]["netD"].items():
        netD.zero_grad(set_to_none=True)
        v = x.clone().requires_grad_(True)
        pred, split = discriminate(netD, v)
        assert split is None and pred.numel() > 0
        loss = gan_loss(pred, True)
        loss.backward()
        for r in reps:
            got, dx, dparams = r[f"netD_{name}"]
            assert close(got, loss.detach()), (name, float(got), float(loss))
            assert close_g(dx, n * rows(v.grad, r["spatial_rank"], n)), name
            assert not close_g(dx, rows(v.grad, r["spatial_rank"], n)), name
            # over the network's max |g|: a norm-fed conv bias has a
            # gradient of 0 in exact arithmetic, rounding alone
            scale = max(float(p.grad.abs().max())
                        for p in netD.parameters())
            for k, p in netD.named_parameters():
                err = float((dparams[k] - p.grad).abs().max())
                assert err <= TOL * scale, (name, k, err, scale)


def test_the_data_groups_keys_are_the_whole_batchs(setup):
    """2 x 2: each spatial rank gathers the keys of the data ranks alone
    (its own data rank's and the other's), the whole batch's once; PatchNCE
    with all negatives on them is the whole batch's, row by row."""
    job = setup["jobs"]["keys_2x2"]
    keys, queries = job["keys"], job["queries"]
    whole = patch_nce_loss(queries.reshape(-1, 8), keys.reshape(-1, 8),
                           batch_size=2, all_negatives_from_minibatch=True)
    reps = reports(setup, "keys_2x2")
    assert len(reps) == 4
    for r in reps:
        gathered, loss = r["keys"]
        assert torch.equal(gathered, keys)
        d = r["data_rank"]
        assert close(loss, whole[d * 16:(d + 1) * 16]), d


@pytest.mark.parametrize("case", CASES)
def test_bfloat16_crosses_gloo_bit_for_bit(setup, case):
    x = setup["jobs"][case]["x_bf16"]
    n = CASES[case][2]
    k = x.shape[2] // n
    zero = torch.zeros_like(x.narrow(2, 0, 1))
    padded = torch.cat([zero, x, zero], dim=2)
    total = sum(rows(x, s, n).float() for s in range(n)).to(torch.bfloat16)
    for r in reports(setup, case):
        halo, gathered, summed = r["bf16"]
        s = r["spatial_rank"]
        assert halo.dtype == gathered.dtype == summed.dtype == torch.bfloat16
        assert torch.equal(halo, padded.narrow(2, s * k, k + 2))
        assert torch.equal(gathered, x)
        assert torch.equal(summed, total)


@pytest.mark.parametrize("case", ["2d_1x2", "2d_1x4"])
def test_bf16_unet_on_slabs_gathers_its_coarse_levels(setup, case):
    unet, x, w = setup["jobs"][case]["unet_bf16"]
    n = CASES[case][2]
    assert first_whole_level(32, n, 4) == (4 if n == 4 else None)
    unet.zero_grad(set_to_none=True)
    v = x.clone().requires_grad_(True)
    y = unet(v)
    (y * w).sum().backward()
    for r in reports(setup, case):
        got, dx = r["unet_bf16"]
        s = r["spatial_rank"]
        assert got.dtype == torch.bfloat16
        assert close(got, rows(y.detach(), s, n), 1e-2), s
        assert close_g(dx, rows(v.grad, s, n), 5e-2), s


def fake_mesh(n_spatial=2):
    """A spatial mesh's numbers, with no process group: what the slab
    check reads before any collective."""
    return Mesh(0, n_spatial, torch.device("cpu"), "gloo",
                n_spatial=n_spatial)


@pytest.mark.parametrize("option", LIFTED)
def test_a_spatial_mesh_takes_each_option(option):
    """Each training option passes the slab check (its computations run
    on slabs, tests/test_torch_spatial_options*.py); no refusal names
    it."""
    cfg = RegistrationConfig(**dict(SMALL, **LIFTED[option]))
    assert not any(test(cfg) for _, test in SLAB_REFUSALS)
    model = RegistrationModel(cfg, device="cpu")
    model._check_slabs(cfg.crop_size, fake_mesh(2))
    model._check_slabs(cfg.crop_size, fake_mesh(4))
