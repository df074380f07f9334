"""The joint model's slab forms, each against the whole-tensor op
(``parallel/mesh.py``'s spatial axis: H at 2-D, D at 3-D), on ``gloo`` CPU
ranks (one launch of 4 ranks: 2-D on 1 x 2 and 1 x 4, 3-D on 1 x 2):
``instance_norm`` and its gradient, the reflect and replicate pads (each
rank's window of the whole padded image, the halos inside and the pad at
the global ends), ``blur_downsample`` / ``blur_upsample``, a 2-D and a
3-D ``conv_slab``, netG's output and taps (tap 0 the pad's, in its padded
geometry), ``PatchSampleF`` on the slabs' taps, ``smoothness_loss``,
``VxmUnet`` with its levels that do not split gathered (the last level
that splits 1 or 3 rows a rank; 2-D and 3-D) with its input's and
parameters' gradients, and ``Warp2dSlabFunction`` with the mesh (B1 / B2's
plain slab forms: output, dflow and the reduce-scattered int64 dsrc bit
for bit the whole image's).  In-process: the plain slab forms of B1
(``warp`` with ``y0``), B2 (``warp2d_dsrc_fixed_plain`` with ``y0``: the
slabs' int64 sums add up to the whole image's) and B5
(``warp3d_dsrc_binned_plain`` with ``z0``), ``Warp2dSlabFunction``'s data
warp, ``slab_rows``, ``check_joint_slabs`` and the slab rule against JAX's
``shard_batch``, and the refusals: a spatial mesh given to
``RegistrationModel`` either computes the whole image's numbers
(``tests/test_torch_spatial_joint.py``, ``test_torch_spatial_step2d.py``)
or raises, naming the option.

Bars: values 1e-5 max-abs (the pads and blurs, copies and the same sums,
exactly); gradients 1e-5 of their max |g|."""

import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.parallel import make_mesh as jax_make_mesh
from dfmir_tpu.parallel import shard_batch
from dfmir_tpu_torch.engine import registration
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import (SLAB_REFUSALS,
                                                 RegistrationModel)
from dfmir_tpu_torch.losses.regularizers import smoothness_loss
from dfmir_tpu_torch.nets.layers import conv_nd, instance_norm, pad_nd
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF
from dfmir_tpu_torch.nets.resnet_gen import (ResnetGenerator,
                                             nce_feature_dims)
from dfmir_tpu_torch.nets.vxm import VxmUnet
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.filters import blur_downsample, blur_upsample
from dfmir_tpu_torch.ops.warp import (abs_max_bits, from_fixed,
                                      item_max_bits, warp,
                                      warp2d_dsrc_fixed_plain,
                                      warp3d_dsrc_binned_plain,
                                      warp_bwd_plain)
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import (Mesh, check_joint_slabs,
                                           first_whole_level, slab_rows)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
PAD = 3
LAYERS = (0, 4, 8, 12, 16)
# name: (n_spatial, the global tensors' spatial shape, netG's)
CASES = {"2d_1x2": (2, (16, 10), (32, 12)),
         "2d_1x4": (4, (16, 10), (32, 12)),
         "3d_1x2": (2, (8, 6, 5), (16, 8, 8))}
# VxmUnets a case runs on slabs: name: (input's spatial shape, depth), and
# the level each gathers first (first_whole_level; None: none); "edge1":
# the last level
# that splits holds 1 row a rank, "edge3" 3; "split": none gathered, the
# coarsest level 1 row a rank and the one above it 2 (a level of 2 rows a
# rank halves into one of 1, which splits, so a gathered level's finer
# neighbour holds an odd count a rank)
UNETS = {"2d_1x2": {"edge1": ((16, 16), 4, 4), "edge3": ((24, 8), 3, 3)},
         "2d_1x4": {"edge1": ((32, 16), 4, 4), "split": ((16, 8), 2, None)},
         "3d_1x2": {"edge1": ((8, 8, 8), 3, 3)}}


def whole(case, seed=0):
    """The global tensors of a case and the whole-tensor results: {name:
    (value, gradient of the input under sum(value * w))}."""
    n, spatial, g_spatial = CASES[case]
    nd = len(spatial)
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen)
    x = rand(2, 3, *spatial)
    netG = ResnetGenerator(ngf=4, n_blocks=1, ndims=nd, generator=gen)
    netF = PatchSampleF(nce_feature_dims(LAYERS, ngf=4, n_blocks=1), nc=8,
                        generator=gen)
    conv = conv_nd(3, 4, 3, 1, 1, True, ndims=nd, generator=gen)
    job = {"x": x, "pad": PAD, "conv": conv, "netG": netG, "netF": netF,
           "layers": LAYERS, "num_patches": 16,
           "x_g": torch.tanh(rand(2, 1, *g_spatial)),
           "flow": rand(2, nd, *spatial)}
    ops = {"norm": instance_norm, "down": blur_downsample,
           "up": blur_upsample, "conv": conv,
           "pad_reflect": lambda v: pad_nd(v, PAD, "reflect"),
           "pad_replicate": lambda v: pad_nd(v, PAD, "replicate")}
    ref = {}
    for name, fn in ops.items():
        v = x.clone().requires_grad_(True)
        y = fn(v)
        job[f"w_{name}"] = w = rand(*y.shape)
        (y * w).sum().backward()
        ref[name] = (y.detach(), v.grad)
    v = job["x_g"].clone().requires_grad_(True)
    y, feats = netG(v, layers=LAYERS)
    job["ids"] = [torch.randperm(f[0, 0].numel(), generator=gen)[:16]
                  for f in feats]
    samples, _ = netF(feats, 16, job["ids"])
    job["w_sample"] = [rand(*s.shape) for s in samples]
    sum((s * w).sum() for s, w in zip(samples, job["w_sample"])).backward()
    ref["netG"] = (y.detach(), [f.detach() for f in feats])
    ref["sample"] = ([s.detach() for s in samples], v.grad)
    f = job["flow"].clone().requires_grad_(True)
    loss = smoothness_loss(f)
    loss.backward()
    ref["smooth"] = (loss.detach(), f.grad)
    job["unets"] = {}
    for name, (shape, depth, _) in UNETS[case].items():
        unet = VxmUnet([4] * depth, [4] * (depth + 2), ndims=nd,
                       generator=gen)
        u = rand(2, 2, *shape).requires_grad_(True)
        y = unet(u)
        w = rand(*y.shape)
        (y * w).sum().backward()
        ref[f"unet_{name}"] = (y.detach(), u.grad, {
            k: p.grad.clone() for k, p in unet.named_parameters()})
        unet.zero_grad(set_to_none=True)
        job["unets"][name] = (unet, u.detach(), w)
    if nd == 2:
        # a field of about 3 px: targets sample rows of other slabs
        job["warp"] = (rand(*x.shape), rand(2, 2, *spatial) * 3,
                       rand(*x.shape))
    return job, ref


@pytest.fixture(scope="module")
def setup():
    refs, cases = {}, []
    for case, (n, _, _) in CASES.items():
        job, refs[case] = whole(case)
        cases.append((case, "joint_slab_pieces",
                      {"n_spatial": n, "job": job, "n_data": 1}))
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)
    yield refs, future
    pool.shutdown(wait=True)


def ranks_of(setup, case):
    refs, future = setup
    reps = [r[case] for r in future.result(timeout=LIMIT + 60)
            if r[case].get("in_mesh", True)]
    return refs[case], sorted(reps, key=lambda r: r["spatial_rank"])


def rows(t, r, n):
    k = t.shape[2] // n
    return t[:, :, r * k:(r + 1) * k]


def close(a, b, scale=1.0, tol=1e-5):
    return float((a - b).abs().max()) <= tol * scale


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", ["norm", "down", "up", "conv"])
def test_slab_op_is_the_whole_ops_rows(setup, case, op):
    ref, reps = ranks_of(setup, case)
    n = len(reps)
    y, dx = ref[op]
    scale = float(dx.abs().max())
    for r in reps:
        got_y, got_dx = r[op]
        assert close(got_y, rows(y, r["spatial_rank"], n)), op
        assert close(got_dx, rows(dx, r["spatial_rank"], n), scale), op


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_pad_on_slabs_is_the_whole_pads_window(setup, case, mode):
    """Each rank's padded slab is its window of the whole padded image:
    its rows and PAD of halo each side, the pad's rows at a global end;
    the gradient under the whole window's weights is the whole gradient
    summed over the windows that hold each row."""
    ref, reps = ranks_of(setup, case)
    n = len(reps)
    y, _ = ref[f"pad_{mode}"]
    job, _ = whole(case)
    k = (y.shape[2] - 2 * PAD) // n
    # how many ranks' windows hold each padded row
    mult = torch.zeros(y.shape[2])
    for s in range(n):
        mult[s * k:s * k + k + 2 * PAD] += 1
    x = job["x"].clone().requires_grad_(True)
    w = job[f"w_pad_{mode}"] * mult.reshape(-1, *[1] * (y.ndim - 3))
    (pad_nd(x, PAD, mode) * w).sum().backward()
    for r in reps:
        s = r["spatial_rank"]
        got_y, got_dx = r[f"pad_{mode}"]
        assert torch.equal(got_y, y[:, :, s * k:s * k + k + 2 * PAD])
        assert close(got_dx, rows(x.grad, s, n), float(x.grad.abs().max()))


@pytest.mark.parametrize("case", CASES)
def test_netG_taps_on_slabs(setup, case):
    """netG's output and taps on slabs put together along the split axis:
    the whole image's, tap 0 (the pad's output) included, whose end ranks
    own the pad's rows (``slab_rows``)."""
    ref, reps = ranks_of(setup, case)
    y, feats = ref["netG"]
    got = torch.cat([r["netG"][0] for r in reps], dim=2)
    assert close(got, y)
    for i, f in enumerate(feats):
        parts = [r["netG"][1][i] for r in reps]
        assert close(torch.cat(parts, dim=2), f), LAYERS[i]
    tap0 = [r["netG"][1][0].shape[2] for r in reps]
    k = (feats[0].shape[2] - 2 * PAD) // len(reps)
    assert tap0 == [k + PAD] + [k] * (len(reps) - 2) + [k + PAD]


@pytest.mark.parametrize("case", CASES)
def test_patch_sampler_on_slabs(setup, case):
    """PatchSampleF on the slabs' taps with the whole maps' ids: every
    spatial rank holds the whole samples; the taps' input takes
    n_spatial times the whole gradient's rows (each rank's loss is the
    whole sum)."""
    ref, reps = ranks_of(setup, case)
    n = len(reps)
    samples, dx = ref["sample"]
    scale = float(dx.abs().max())
    for r in reps:
        for got, want in zip(r["sample"][0], samples):
            assert close(got, want)
        assert close(r["sample"][1] / n, rows(dx, r["spatial_rank"], n),
                     scale)


@pytest.mark.parametrize("case", CASES)
def test_smoothness_on_slabs(setup, case):
    """The whole image's smoothness on every rank, with world times this
    rank's share of its gradient."""
    ref, reps = ranks_of(setup, case)
    n = len(reps)
    loss, df = ref["smooth"]
    for r in reps:
        assert abs(float(r["smooth"][0]) - float(loss)) <= 1e-6 * float(loss)
        assert close(r["smooth"][1] / n, rows(df, r["spatial_rank"], n),
                     float(df.abs().max()))


@pytest.mark.parametrize("case,name", [(c, n) for c in CASES
                                       for n in UNETS[c]])
def test_vxm_unet_gathers_the_levels_that_do_not_split(setup, case, name):
    """netR's UNet on slabs, the levels that do not split run on the
    gathered map: its output and input gradient are the whole image's
    rows, and the ranks' parameter gradients (each its consumers' part of
    the gathered levels' cotangent) add up to the whole image's."""
    ref, reps = ranks_of(setup, case)
    n = len(reps)
    shape, depth, level = UNETS[case][name]
    assert first_whole_level(shape[0], n, depth) == level
    y, dx, grads = ref[f"unet_{name}"]
    for r in reps:
        got_y, got_dx, _ = r[f"unet_{name}"]
        assert close(got_y, rows(y, r["spatial_rank"], n))
        assert close(got_dx, rows(dx, r["spatial_rank"], n),
                     float(dx.abs().max()))
    scale = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        assert close(sum(r[f"unet_{name}"][2][k] for r in reps), g, scale), k


@pytest.mark.parametrize("case", [c for c in CASES if c.startswith("2d")])
def test_warp2d_slab_function_with_the_mesh(setup, case):
    """``Warp2dSlabFunction`` with the mesh, on the CPU (B1 / B2's plain
    slab forms): the output and dflow the whole warp's rows bit for bit;
    the source gradient, each item's fixed point of max|g| over the ranks'
    cotangents, int64 sums reduce-scattered, the whole image's fixed-point
    dsrc bit for bit and within 1e-5 of autograd's."""
    _, reps = ranks_of(setup, case)
    n = len(reps)
    job, _ = whole(case)
    src, flow, w = job["warp"]
    y = warp(src, flow, impl="torch")
    dsrc, dflow = warp_bwd_plain(src, flow, w)
    fixed = warp2d_dsrc_fixed_plain(flow, w)
    for r in reps:
        s = r["spatial_rank"]
        got_y, got_dsrc, got_dflow = r["warp"]
        assert torch.equal(got_y, rows(y, s, n))
        assert torch.equal(got_dflow, rows(dflow, s, n))
        assert torch.equal(got_dsrc, rows(fixed, s, n))
        assert close(got_dsrc, rows(dsrc, s, n),
                     max(1.0, float(dsrc.abs().max())))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_b2_plain_slab_sums_add_up_to_the_whole(n):
    """B2's plain slab model: each slab's int64 sums in each item's fixed
    point of max|g[b]| over the whole cotangent (items of unlike scales);
    their total, as floats, is the whole image's fixed-point dsrc bit for
    bit; a non-finite item gives NaN over that item alone."""
    g = torch.Generator().manual_seed(n)
    flow = torch.randn((2, 2, 12, 9), generator=g) * 3
    cot = torch.randn((2, 3, 12, 9), generator=g)
    cot[1] *= 300.0
    m = item_max_bits(cot)
    h = 12 // n
    total = sum(warp2d_dsrc_fixed_plain(
        flow[:, :, r * h:(r + 1) * h], cot[:, :, r * h:(r + 1) * h], r * h,
        12, m, sums=True) for r in range(n))
    assert total.dtype == torch.int64 and total.shape == cot.shape
    assert torch.equal(from_fixed(total, m.reshape(-1, 1, 1, 1), 12 * 9),
                       warp2d_dsrc_fixed_plain(flow, cot))
    bad = m.clone()
    bad[0] = abs_max_bits(torch.tensor([float("nan")]))[0]
    got = from_fixed(total, bad.reshape(-1, 1, 1, 1), 12 * 9)
    assert torch.isnan(got[0]).all() and not torch.isnan(got[1]).any()


def test_warp2d_slab_function_data_warp_on_the_cpu():
    """Without a mesh the slab Function is a data warp: its source takes
    no gradient (one that needs it raises), its dflow the whole warp's
    rows bit for bit."""
    g = torch.Generator().manual_seed(5)
    src = torch.randn((2, 3, 18, 11), generator=g)
    flow = torch.randn((2, 2, 18, 11), generator=g) * 3
    cot = torch.randn((2, 3, 6, 11), generator=g)
    f = flow[:, :, 6:12].clone().requires_grad_(True)
    out = warp_cuda.Warp2dSlabFunction.apply(src, f, 6)
    assert torch.equal(out, warp(src, flow, impl="torch")[:, :, 6:12])
    out.backward(cot)
    full = torch.zeros(2, 3, 18, 11)
    full[:, :, 6:12] = cot
    assert torch.equal(f.grad, warp_bwd_plain(src, flow, full,
                                              need_dsrc=False)[1][:, :, 6:12])
    with pytest.raises(ValueError, match="takes a gradient only from its"):
        warp_cuda.Warp2dSlabFunction.apply(src.requires_grad_(True), f, 6)


@pytest.mark.parametrize("y0", [0, 6, 12])
def test_b1_plain_slab_is_the_whole_images_rows(y0):
    g = torch.Generator().manual_seed(y0)
    src = torch.randn((2, 3, 18, 11), generator=g)
    flow = torch.randn((2, 2, 18, 11), generator=g) * 3
    f = flow[:, :, y0:y0 + 6]
    assert torch.equal(warp(src, f, impl="torch", z0=y0),
                       warp(src, flow, impl="torch")[:, :, y0:y0 + 6])


@pytest.mark.parametrize("n", [2, 3])
def test_b5_plain_slab_sums_add_up_to_the_whole(n):
    """B5's plain slab model: each slab's int64 sums in the fixed point of
    max|g| over the whole cotangent; their total, as floats, is the whole
    volume's binned B5 bit for bit; a non-finite max gives NaN."""
    g = torch.Generator().manual_seed(n)
    flow = torch.randn((2, 3, 12, 7, 9), generator=g) * 2.5
    cot = torch.randn((2, 2, 12, 7, 9), generator=g)
    m = abs_max_bits(cot)
    d = 12 // n
    total = sum(warp3d_dsrc_binned_plain(
        flow[:, :, r * d:(r + 1) * d], cot[:, :, r * d:(r + 1) * d], r * d,
        12, m, sums=True) for r in range(n))
    assert torch.equal(from_fixed(total, m, 12 * 7 * 9),
                       warp3d_dsrc_binned_plain(flow, cot))
    bad = abs_max_bits(torch.tensor([float("inf")]))
    assert torch.isnan(from_fixed(total, bad, 12 * 7 * 9)).all()


def test_slab_rows_place_a_pads_tap():
    """Tap 0 (a pad of 3 on 4 slabs of 8 rows): the end ranks own 11 rows,
    the others 8; together the padded extent of 38."""
    got = [slab_rows(rows_, 3, Mesh(r, 4, torch.device("cpu"), "gloo",
                                    n_spatial=4))
           for r, rows_ in enumerate((11, 8, 8, 11))]
    assert got == [(0, 38), (11, 38), (19, 38), (27, 38)]


def test_check_joint_slabs():
    """The joint model's extents: netR's levels that do not split are
    gathered (the returned level), netG's levels must split past their
    pads."""
    assert check_joint_slabs(256, 4, 6, 2, [3, 1, 1]) is None
    assert check_joint_slabs(16, 2, 3, 2, [3, 1, 1]) is None
    assert check_joint_slabs(16, 2, 4, 2, [3, 1, 1]) == 4
    with pytest.raises(ValueError, match="pad of 5"):
        check_joint_slabs(32, 8, 1, 1, [5, 1, 1])


# (extent, n_spatial, netR's depth, what the port does): an int, netR's
# first gathered level (None: every level splits); else the rule that
# refuses it.  int_downsize 2, netG's pads (3, 1, 1): RegistrationConfig()'s
# (netR 6 levels deep; at 2 levels a small extent shows netG's pads within
# the 8 CPU devices)
RULE_CASES = [(64, 2, 6, 6), (64, 4, 6, 5), (64, 8, 6, 4),
              (256, 2, 6, None), (256, 4, 6, None), (256, 8, 6, 6),
              (192, 3, 6, None), (128, 2, 6, None),
              (63, 2, 6, "shard_batch"), (66, 4, 6, "shard_batch"),
              (65, 3, 6, "shard_batch"), (66, 2, 6, "whole-image"),
              (96, 2, 6, "whole-image"), (32, 8, 2, "pad of 1"),
              (16, 8, 2, "pad of 3")]


def jax_splits(extent, n_spatial):
    """Whether JAX's ``shard_batch(..., shard_spatial=True)`` splits a
    (1, extent, extent, 1) image over a 1 x n_spatial mesh."""
    mesh = jax_make_mesh(n_data=1, n_spatial=n_spatial,
                         devices=jax.devices()[:n_spatial])
    try:
        shard_batch(mesh, jnp.zeros((1, extent, extent, 1)),
                    shard_spatial=True)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("extent,n_spatial,depth,want", RULE_CASES)
def test_the_slab_rule_against_shard_batch(extent, n_spatial, depth, want):
    """The port takes every extent that JAX's ``shard_batch`` splits and
    the whole-image model takes, but for netG's levels past their pads
    (32 over 8: netG's last level holds 1 row a rank against a pad of 1;
    16 over 8 its first 2 against a pad of 3); one that JAX refuses it
    refuses with JAX's reason; the engine's check (netR alone) the
    same."""
    assert jax_splits(extent, n_spatial) == (want != "shard_batch")
    args = (extent, n_spatial, depth, 2)
    if not isinstance(want, str):
        assert check_joint_slabs(*args, [3, 1, 1]) == want
        assert first_whole_level(extent, n_spatial, depth) == want
    else:
        with pytest.raises(ValueError, match=want):
            check_joint_slabs(*args, [3, 1, 1])
    if want in ("shard_batch", "whole-image"):
        with pytest.raises(ValueError, match=want):
            check_joint_slabs(*args)
    else:
        assert check_joint_slabs(*args) == first_whole_level(*args[:3])


SMALL = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
             vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
# a config that shows each refusal of SLAB_REFUSALS, in its order
REFUSED = [dict(netF="global_pool"), dict(netR="vxm_dual"),
           dict(num_patches=0)]
# netG unet_128, which SLAB_REFUSALS named first until its levels could
# run gathered
UNET = dict(netG="unet_128", nce_layers=(0, 2, 4, 6), crop_size=128)


def fake_mesh(n_spatial=2):
    """A spatial mesh's numbers, with no process group: what a refusal
    reads before any collective."""
    return Mesh(0, n_spatial, torch.device("cpu"), "gloo",
                n_spatial=n_spatial)


@pytest.mark.parametrize("i", range(len(SLAB_REFUSALS)))
def test_a_spatial_mesh_refuses_each_option_by_name(i):
    name, test = SLAB_REFUSALS[i]
    cfg = RegistrationConfig(**dict(SMALL, **REFUSED[i]))
    assert test(cfg) and not test(RegistrationConfig(**SMALL))
    model = RegistrationModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError) as err:
        model.data_parallel(fake_mesh())
    assert name in str(err.value)
    assert model.mesh is None


def test_a_spatial_mesh_takes_the_unet(monkeypatch):
    """No refusal names netG unet_128, and ``data_parallel`` takes it on a
    1 x 2 mesh (the check it makes before any collective: ``replicate``,
    a broadcast, needs ranks, which ``tests/test_torch_spatial_unet.py``
    starts)."""
    cfg = RegistrationConfig(**dict(SMALL, **UNET))
    assert not any(test(cfg) for _, test in SLAB_REFUSALS)
    model = RegistrationModel(cfg, device="cpu")
    monkeypatch.setattr(registration, "replicate", lambda *a: None)
    model.data_parallel(fake_mesh())
    assert model.mesh is not None and model.mesh.n_spatial == 2


def test_a_spatial_mesh_refuses_an_extent_that_does_not_split():
    model = RegistrationModel(RegistrationConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        model.data_parallel(fake_mesh(3))


def test_the_2d_step_and_visuals_on_slabs_are_refused():
    """The 2-D step runs on slabs (its networks and losses take the mesh:
    ``tests/test_torch_spatial_step2d.py`` holds it to JAX); compute_visuals
    and registration_metrics gather nothing: each raises by name."""
    model = RegistrationModel(RegistrationConfig(**SMALL), device="cpu")
    model.mesh = fake_mesh()
    a = torch.zeros(1, 1, 16, 32)
    assert model._step_mesh(a, None) == (model.mesh, model.mesh)
    with pytest.raises(NotImplementedError, match="compute_visuals"):
        model.compute_visuals(a, a)
    with pytest.raises(NotImplementedError, match="registration_metrics"):
        model.registration_metrics(a, a)


def test_whole_images_keep_their_path():
    """A mesh that does not split (n_spatial 1) leaves every slab form the
    whole op, bit for bit."""
    mesh = dataclasses.replace(fake_mesh(), n_spatial=1, world=1)
    x = torch.randn(2, 3, 8, 6)
    assert torch.equal(instance_norm(x, mesh=mesh), instance_norm(x))
    assert torch.equal(pad_nd(x, 2, "reflect", mesh), pad_nd(x, 2))
    assert torch.equal(blur_downsample(x, mesh=mesh), blur_downsample(x))
    assert torch.equal(blur_upsample(x, mesh=mesh), blur_upsample(x))
    assert np.isfinite(float(smoothness_loss(x[:, :2], mesh)))
