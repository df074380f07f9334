"""The 2-D-only generators' slab forms, each against the whole-tensor op
(images split along H over ``gloo`` CPU ranks, one launch of 4 ranks: 1 x
2 on its first two, 1 x 4):

- ``nets/stylegan2.py``: ``upfirdn2d`` down 2, up 2 and a plain blur;
  ``ConvLayer`` downsampling (the blur's window, then its valid stride-2
  conv), ``ResBlock`` downsampling and its 1x1 skip alone, and
  ``ModulatedConv``'s upsampling (the transposed conv cut to the blur's
  rows) and downsampling;
- ``nets/munit.py``: ``Conv2dBlock`` at stride 2 (4x4, reflect pad 1,
  instance norm over the whole map), the 7x7 input block, the 5x5 block
  with its channel LayerNorm after a nearest upsampling, and a
  ``MunitResBlock``;
- both generators whole (``resnet_cat``'s ``GResnet`` and a narrow
  ``StyleGAN2Generator``), in float64: the output and every NCE tap,
  each a slab's rows, and the input's gradient.

Each slab's value is the whole op's rows, its input gradient the whole
gradient's rows, and the parameters' gradients summed over the ranks the
whole op's.  Bars: values 1e-6 max-abs (of their max |x| past 1),
gradients 1e-6 of their max |g|; the generators whole 1e-10 of each (in
float32, the norms' statistics summed over the slabs in another order
than the whole map's, GResnet's output parts from the whole's by 3e-5
through its 14 instance norms at 1 x 4, and its input gradient by 7e-5
of its max |g|).

In-process: ``check_joint_slabs`` on both families' ``slab_level_pads``
(an extent it takes, one it refuses, and the smallest it takes), and
``SLAB_REFUSALS``' refusal by name of every choice still without a slab
form; the three netGs of this file pass it."""

import concurrent.futures

import pytest
import torch

from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import (SLAB_REFUSALS,
                                                 RegistrationModel)
from dfmir_tpu_torch.nets.munit import Conv2dBlock, GResnet, MunitResBlock
from dfmir_tpu_torch.nets.layers import upsample_nearest
from dfmir_tpu_torch.nets.stylegan2 import (ConvLayer, ModulatedConv,
                                            ResBlock, StyleGAN2Generator,
                                            make_kernel, upfirdn2d)
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import Mesh, check_joint_slabs
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
TOL = 1e-6
CASES = {"1x2": 2, "1x4": 4}
BLUR = (1, 3, 3, 1)
# name: (up, down, pad, the kernel's gain)
FIRS = {"down": (1, 2, (1, 1), 1.0), "up": (2, 1, (2, 1), 4.0),
        "blur": (1, 1, (2, 1), 1.0)}
SMALL = dict(crop_size=32, ngf=8, vxm_enc=(8, 16), vxm_dec=(16, 16, 8),
             netF_nc=16, num_patches=16)
ZOO = {"resnet_cat": dict(netG="resnet_cat", nce_layers=(0, 1, 2, 3)),
       "stylegan2": dict(netG="stylegan2", nce_layers=(1, 2, 3)),
       "smallstylegan2": dict(netG="smallstylegan2", nce_layers=(1, 2, 3))}
# every choice still without a slab form: (its SLAB_REFUSALS entry, the
# config that shows it)
STILL_REFUSED = {
    "unet_128": (0, dict(netG="unet_128", nce_layers=(0, 2, 4, 6),
                         crop_size=128)),
    "unet_256": (0, dict(netG="unet_256", nce_layers=(0, 2, 4, 6),
                         crop_size=256)),
    "global_pool": (1, dict(netF="global_pool")),
    "reshape": (1, dict(netF="reshape")),
    "strided_conv": (1, dict(netF="strided_conv")),
    "vxm_transformer": (2, dict(netR="vxm_transformer",
                                vxm_dec=(16, 16, 8, 8))),
    "vxm_dual": (2, dict(netR="vxm_dual", vxm_dec=(16, 16, 8, 8))),
    "num_patches_0": (3, dict(num_patches=0))}


def rand(gen, *shape):
    return torch.randn(shape, generator=gen)


def inputs(seed):
    """The global tensors of one case: B=2, 16 rows (8 for the
    upsampling ops, 32 for GResnet)."""
    g = torch.Generator().manual_seed(seed)
    job = {"fir": {}, "modules": {}, "netGs": {}}
    for name, (up, down, pad, gain) in FIRS.items():
        x = rand(g, 2, 3, 16, 12)
        job["fir"][name] = (make_kernel(BLUR) * gain, up, down, pad, x,
                            rand(g, 2, 3, 16 * up // down, 12 * up // down))
    kw = dict(generator=g)
    x8 = rand(g, 2, 4, 8, 6)
    modules = {
        "conv_down": (ConvLayer(3, 4, 3, downsample=True, **kw),
                      rand(g, 2, 3, 16, 12), (2, 4, 8, 6)),
        "resblock_down": (ResBlock(3, 4, downsample=True, **kw),
                          rand(g, 2, 3, 16, 12), (2, 4, 8, 6)),
        "skip": (ConvLayer(3, 4, 1, downsample=True, activate=False,
                           use_bias=False, **kw),
                 rand(g, 2, 3, 16, 12), (2, 4, 8, 6)),
        "modconv_up": (ModulatedConv(4, 3, 3, upsample=True, **kw), x8,
                       (2, 3, 16, 12)),
        "modconv_down": (ModulatedConv(3, 4, 3, downsample=True, **kw),
                         rand(g, 2, 3, 16, 12), (2, 4, 8, 6)),
        "munit_down": (Conv2dBlock(3, 6, 4, 2, 1, "instance", "relu", **kw),
                       rand(g, 2, 3, 16, 12), (2, 6, 8, 6)),
        "munit_in": (Conv2dBlock(1, 4, 7, 1, 3, "instance", "relu", **kw),
                     rand(g, 2, 1, 16, 12), (2, 4, 16, 12)),
        "munit_up5": (Conv2dBlock(4, 2, 5, 1, 2, "ln", "relu", **kw),
                      upsample_nearest(x8), (2, 2, 16, 12)),
        "munit_res": (MunitResBlock(4, **kw), rand(g, 2, 4, 16, 12),
                      (2, 4, 16, 12))}
    for name, (module, x, w_shape) in modules.items():
        job["modules"][name] = (module, x, rand(g, *w_shape))
    f64 = torch.float64
    job["netGs"]["resnet_cat"] = (
        GResnet(1, 1, 0, 2, 4, 4, **kw).to(f64),
        torch.tanh(rand(g, 2, 1, 32, 16)).to(f64), (0, 1, 2, 3),
        rand(g, 2, 1, 32, 16).to(f64))
    job["netGs"]["stylegan2"] = (
        StyleGAN2Generator(1, 1, 1, 4, 64, 1, **kw).to(f64),
        torch.tanh(rand(g, 2, 1, 16, 12)).to(f64), (1, 2, 3),
        rand(g, 2, 1, 16, 12).to(f64))
    return job


@pytest.fixture(scope="module")
def setup():
    jobs = {name: inputs(i) for i, name in enumerate(CASES)}
    cases = [(name, "zoo_slab_pieces", {"n_spatial": n, "n_data": 1,
                                        "job": jobs[name]})
             for name, n in CASES.items()]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)
    yield {"future": future, "jobs": jobs}
    pool.shutdown(wait=True)


def reports(setup, case):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    reps = sorted((r[case] for r in ranks if r[case].get("in_mesh", True)),
                  key=lambda r: r["spatial_rank"])
    assert len(reps) == CASES[case]
    return reps


def rows(t, r, n):
    k = t.shape[2] // n
    return t.narrow(2, r * k, k)


def err(got, want):
    return float((got.double() - want.double()).abs().max())


def close(got, want, tol=TOL):
    """Values: within ``tol`` max-abs (of their max |x| past 1)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return err(got, want) <= tol * max(float(want.abs().max()), 1.0)


def close_g(got, want, tol=TOL):
    """Gradients: within ``tol`` of their max |g|."""
    scale = float(want.abs().max())
    assert scale > 0
    return err(got, want) <= tol * scale


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", FIRS)
def test_upfirdn2d_on_slabs_is_the_whole_ops_rows(setup, case, name):
    kernel, up, down, pad, x, w = setup["jobs"][case]["fir"][name]
    v = x.clone().requires_grad_(True)
    y = upfirdn2d(v, kernel, up, down, pad)
    assert y.shape[2] == x.shape[2] * up // down
    (y * w).sum().backward()
    n = CASES[case]
    for r in reports(setup, case):
        got, dx = r[f"fir_{name}"]
        s = r["spatial_rank"]
        assert close(got, rows(y.detach(), s, n)), (name, s)
        assert close_g(dx, rows(v.grad, s, n)), (name, s)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["conv_down", "resblock_down", "skip",
                                  "modconv_up", "modconv_down", "munit_down",
                                  "munit_in", "munit_up5", "munit_res"])
def test_a_zoo_op_on_slabs_is_the_whole_ops_rows(setup, case, name):
    module, x, w = setup["jobs"][case]["modules"][name]
    module.zero_grad(set_to_none=True)
    v = x.clone().requires_grad_(True)
    y = module(v)
    assert y.shape == w.shape
    (y * w).sum().backward()
    n = CASES[case]
    total = {}
    for r in reports(setup, case):
        got, dx, dparams = r[f"module_{name}"]
        s = r["spatial_rank"]
        assert close(got, rows(y.detach(), s, n)), (name, s)
        assert close_g(dx, rows(v.grad, s, n)), (name, s)
        for k, g in dparams.items():
            total[k] = total.get(k, 0) + g.double()
    params = {k: p for k, p in module.named_parameters()
              if p.grad is not None}
    assert set(total) == set(params) and params, name
    # over the module's max |g|: a norm-fed conv bias has a gradient of 0
    # in exact arithmetic, rounding alone
    scale = max(float(p.grad.abs().max()) for p in params.values())
    for k, p in params.items():
        assert err(total[k], p.grad) <= TOL * scale, (name, k)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["resnet_cat", "stylegan2"])
def test_a_zoo_generator_on_slabs_is_the_whole_ones_rows(setup, case, name):
    netG, x, layers, w = setup["jobs"][case]["netGs"][name]
    assert netG.tap_pads(layers) == [0] * len(layers)
    v = x.clone().requires_grad_(True)
    y, feats = netG(v, layers=layers)
    (y * w).sum().backward()
    n = CASES[case]
    check_joint_slabs(x.shape[2], n, 0, 1, netG.slab_level_pads())
    for r in reports(setup, case):
        got, taps, dx = r[f"netG_{name}"]
        s = r["spatial_rank"]
        assert got.dtype == torch.float64
        assert close(got, rows(y.detach(), s, n), 1e-10), (name, s)
        assert len(taps) == len(feats)
        for i, (t, f) in enumerate(zip(taps, feats)):
            assert close(t, rows(f.detach(), s, n), 1e-10), (name, s, i)
        assert close_g(dx, rows(v.grad, s, n), 1e-10), (name, s)


# (n_spatial, extent, None if taken else the refusal's words): with netR
# 2 levels deep at int_downsize 2, an extent taken, one refused at netG's
# pads, and the smallest taken (each level's rows one more than its pad)
SLAB_RULE = {
    "stylegan2": [(4, 32, None), (4, 8, "netG's level 0"), (4, 16, None)],
    "resnet_cat": [(4, 64, None), (4, 16, "netG's level 1"),
                   (4, 32, None)]}


@pytest.mark.parametrize("family", SLAB_RULE)
def test_the_slab_rule_on_the_zoo_generators_level_pads(family):
    model = RegistrationModel(RegistrationConfig(**SMALL, **ZOO[family]),
                              device="cpu")
    pads = model.netG.slab_level_pads()
    assert pads == ([2, 1] if family == "stylegan2" else [3, 2, 1])
    for n, extent, refused in SLAB_RULE[family]:
        if refused is None:
            assert check_joint_slabs(extent, n, 2, 2, pads) is None
        else:
            with pytest.raises(ValueError, match=refused):
                check_joint_slabs(extent, n, 2, 2, pads)
            check_joint_slabs(extent, n, 2, 2)   # netR alone takes it


def fake_mesh(n_spatial=2):
    """A spatial mesh's numbers, with no process group: what the slab
    check reads before any collective."""
    return Mesh(0, n_spatial, torch.device("cpu"), "gloo",
                n_spatial=n_spatial)


@pytest.mark.parametrize("netG", ZOO)
def test_a_spatial_mesh_takes_the_2d_only_generators(netG):
    cfg = RegistrationConfig(**SMALL, **ZOO[netG])
    assert not any(test(cfg) for _, test in SLAB_REFUSALS)
    model = RegistrationModel(cfg, device="cpu")
    model._check_slabs(cfg.crop_size, fake_mesh(2))
    model._check_slabs(cfg.crop_size, fake_mesh(4))


@pytest.mark.parametrize("choice", STILL_REFUSED)
def test_a_spatial_mesh_still_refuses_the_rest_by_name(choice):
    i, change = STILL_REFUSED[choice]
    name, test = SLAB_REFUSALS[i]
    cfg = RegistrationConfig(**dict(SMALL, **change))
    assert test(cfg)
    assert [n for n, t in SLAB_REFUSALS if t(cfg)] == [name]
    model = RegistrationModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError) as err_info:
        model.data_parallel(fake_mesh())
    assert name in str(err_info.value)
    assert model.mesh is None
