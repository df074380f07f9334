"""netG ``unet_128`` / ``unet_256``'s slab forms, each against the whole
tensor's op (images split along H, volumes along D, over ``gloo`` CPU
ranks, one launch of 4 ranks: 1 x 2 on its first two, 1 x 4):

- ``conv_transpose_slab`` at the UNet's geometry (kernel 4, stride 2,
  padding 1, output padding 0: output rows 2y and 2y + 1 read input rows
  y - 1, y and y + 1), 2-D and 3-D, float64 and bfloat16;
- ``UnetGenerator`` (4 levels, ngf 4) in float64 at extents that gather
  none of its levels (32 rows over 2), one (32 over 4: level 4, 2 rows,
  and so tap 3) and two (16 over 4: levels 3 and 4, taps 2 and 3), and in
  3-D (16^3 over 2 and 4): its output, every tap (a slab's rows, or the
  whole map where its level is gathered), the input's gradient and, summed
  over the ranks, netG's parameters' gradients, under a loss that weighs
  the output and every tap;
- PatchSampleF on those taps (a mix of slab and whole taps): its samples
  on every spatial rank, and netF's and netG's gradients through them.

Each slab's value is the whole op's rows and its input gradient the whole
gradient's rows; a whole tap's and the samples' loss terms are divided by
n_spatial on each rank (every rank holds them whole), so the ranks'
parameter gradients add up to the whole op's.  Bars: float64 1e-10 of
each value's max |x| past 1 and of each gradient's max |g| (the
transposed conv's float64 values bit for bit); bfloat16 bit for bit,
its input gradient within 1e-2 and its parameters' 3e-2 of their max |g|
(``tests/test_torch_spatial_options_units.py``'s bars).

In-process: the slab rule for the UNet family (``check_joint_slabs`` with
``gathered``) takes each extent that JAX's ``shard_batch`` and the
whole-image model take and refuses the rest by their messages."""

import concurrent.futures

import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.parallel import make_mesh as jax_make_mesh
from dfmir_tpu.parallel import shard_batch
from dfmir_tpu_torch.nets.layers import conv_transpose_nd
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF
from dfmir_tpu_torch.nets.unet_gen import UnetGenerator
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
from dfmir_tpu_torch.parallel.mesh import (check_joint_slabs,
                                           first_whole_level)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

LIMIT = 300.0
TOL = 1e-10
F64 = torch.float64
# case: (ndims, n_spatial, extent, the levels it gathers)
CASES = {"2d_32_1x2": (2, 2, 32, 0), "2d_32_1x4": (2, 4, 32, 1),
         "2d_16_1x4": (2, 4, 16, 2), "3d_16_1x2": (3, 2, 16, 1),
         "3d_16_1x4": (3, 4, 16, 2)}
LAYERS = (0, 1, 2, 3)
DOWNS = 4
PATCHES = 8


def rand(gen, *shape, dtype=F64):
    return torch.randn(shape, generator=gen).to(dtype)


def inputs(ndims, extent, seed):
    """One case's global tensors: B=2, the UNet 4 levels deep (the other
    sides 16: the innermost level holds 1 along them too), with netF on
    its taps and patch ids drawn here (up to PATCHES a tap); the
    transposed convs at the UNet's geometry on 8-row maps."""
    g = torch.Generator().manual_seed(seed)
    side = (extent,) + (16,) * (ndims - 1)
    netG = UnetGenerator(1, 1, DOWNS, 4, ndims=ndims, generator=g).to(F64)
    x = torch.tanh(rand(g, 2, 1, *side))
    with torch.no_grad():
        feats = netG(x, layers=LAYERS, encode_only=True)
        y = netG(x)
    dims = [f.shape[1] for f in feats]
    netF = PatchSampleF(dims, nc=8, generator=g).to(F64)
    ids = [torch.randperm(f[0, 0].numel(), generator=g)[:PATCHES]
           for f in feats]
    job = {"unets": {"netG": {
        "netG": netG, "netF": netF, "x": x, "layers": LAYERS, "ids": ids,
        "w": rand(g, *y.shape), "w_taps": [rand(g, *f.shape) for f in feats],
        "w_samples": [rand(g, 2 * len(i), 8) for i in ids]}}}
    job["convT"] = {}
    for dtype in (F64, torch.bfloat16):
        conv = conv_transpose_nd(6, 3, 4, 2, 1, 0, ndims=ndims,
                                 generator=g).to(dtype)
        x8 = rand(g, 2, 6, 8, *(6,) * (ndims - 1), dtype=dtype)
        job["convT"][str(dtype)] = (conv, x8, rand(
            g, 2, 3, 16, *(12,) * (ndims - 1), dtype=dtype))
    return job


@pytest.fixture(scope="module")
def setup():
    jobs = {name: inputs(nd, extent, i)
            for i, (name, (nd, _, extent, _)) in enumerate(CASES.items())}
    cases = []
    for name, (_, n, _, _) in CASES.items():
        cases += [(name, "unet_slab_pieces", {
            "n_spatial": n, "n_data": 1, "job": {"unets": jobs[name][
                "unets"]}}),
                  (f"{name}_convT", "option_slab_pieces", {
                      "n_spatial": n, "n_data": 1, "job": {
                          "convT": jobs[name]["convT"]}})]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(launch, checks.run_cases, ["cpu"] * 4, (cases,),
                         LIMIT)
    yield {"future": future, "jobs": jobs}
    pool.shutdown(wait=True)


def reports(setup, case, n):
    ranks = setup["future"].result(timeout=LIMIT + 60)
    reps = sorted((r[case] for r in ranks if r[case].get("in_mesh", True)),
                  key=lambda r: r["spatial_rank"])
    assert len(reps) == n
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
def test_the_unets_transposed_conv_on_slabs_is_the_whole_convs_rows(
        setup, case):
    n = CASES[case][1]
    reps = reports(setup, f"{case}_convT", n)
    for dtype, (conv, x, w) in setup["jobs"][case]["convT"].items():
        conv.zero_grad(set_to_none=True)
        v = x.clone().requires_grad_(True)
        y = conv(v)
        (y * w).sum().backward()
        assert y.shape[2] == 2 * x.shape[2]
        low = dtype == str(torch.bfloat16)
        param_sum = {k: 0 for k, _ in conv.named_parameters()}
        for r in reps:
            got, dx, dparams = r[f"convT_{dtype}"]
            s = r["spatial_rank"]
            assert got.dtype == x.dtype
            assert torch.equal(got, rows(y.detach(), s, n)), (dtype, s)
            assert close_g(dx, rows(v.grad, s, n),
                           1e-2 if low else TOL), (dtype, s)
            for k in param_sum:
                param_sum[k] = param_sum[k] + dparams[k].double()
        for k, p in conv.named_parameters():
            assert close_g(param_sum[k], p.grad,
                           3e-2 if low else TOL), (dtype, k)


def whole_unet(case):
    """The whole op of ``case``: its taps, samples and gradients under the
    loss the ranks split."""
    c = case["unets"]["netG"]
    netG, netF = c["netG"], c["netF"]
    for m in (netG, netF):
        m.zero_grad(set_to_none=True)
    v = c["x"].clone().requires_grad_(True)
    y, feats = netG(v, layers=c["layers"])
    samples, _ = netF(feats, PATCHES, c["ids"])
    loss = (y * c["w"]).sum()
    for f, w in zip(feats, c["w_taps"]):
        loss = loss + (f * w).sum()
    for smp, w in zip(samples, c["w_samples"]):
        loss = loss + (smp * w).sum()
    loss.backward()
    grads = {k: {p_name: p.grad for p_name, p in m.named_parameters()}
             for k, m in zip("GF", (netG, netF))}
    return y.detach(), feats, samples, v.grad, grads


@pytest.mark.parametrize("case", CASES)
def test_the_unet_on_slabs_is_the_whole_ones_rows(setup, case):
    """The output, each tap (its rows, or the whole map at a gathered
    level), the samples of the taps, the input's gradient, and netG's and
    netF's gradients summed over the ranks: the whole op's."""
    ndims, n, extent, gathered = CASES[case]
    job = setup["jobs"][case]
    y, feats, samples, dx, grads = whole_unet(job)
    whole_levels = (DOWNS + 1 - first_whole_level(extent, n, DOWNS)
                    if gathered else 0)
    assert whole_levels == gathered
    want_whole = [i + 1 > DOWNS - gathered for i in LAYERS]
    total = {k: {} for k in grads}
    for r in reports(setup, case, n):
        got = r["unet_netG"]
        s = r["spatial_rank"]
        assert got["whole"] == want_whole
        assert got["y"].dtype == F64
        assert close(got["y"], rows(y, s, n)), s
        for i, (t, f, is_whole) in enumerate(zip(got["feats"], feats,
                                                 want_whole)):
            assert close(t, f.detach() if is_whole
                         else rows(f.detach(), s, n)), (s, i)
        for i, (smp, want) in enumerate(zip(got["samples"], samples)):
            assert close(smp, want.detach()), (s, i)
        assert close_g(got["x_grad"], rows(dx, s, n)), s
        for net, gs in got["grads"].items():
            for k, g in gs.items():
                total[net][k] = total[net].get(k, 0) + g
    for net, gs in grads.items():
        assert set(total[net]) == set(gs), net
        scale = max(float(g.abs().max()) for g in gs.values())
        for k, g in gs.items():
            assert err(total[net][k], g) <= TOL * scale, (case, net, k)


# (netG, crop, n_spatial, netG's first gathered level or the refusal's
# words) with netR 2 levels deep at int_downsize 2: unet_128 at 128 over
# 2, 4 and 8 (and 16, 32: JAX's 8 CPU devices stop at 8, the rule does
# not), unet_256 at 256 over 4; extents JAX or the whole-image model
# refuse
UNET_RULE = [("unet_128", 128, 2, 7), ("unet_128", 128, 4, 6),
             ("unet_128", 128, 8, 5), ("unet_256", 256, 4, 7),
             ("unet_256", 256, 8, 6), ("unet_128", 384, 2, 7),
             ("unet_128", 130, 2, "whole-image"),
             ("unet_128", 128, 3, "shard_batch"),
             ("unet_256", 128, 2, "whole-image")]


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


def unet_pads(netG):
    return [0] * ({"unet_128": 7, "unet_256": 8}[netG] + 1)


@pytest.mark.parametrize("netG,extent,n_spatial,want", UNET_RULE)
def test_the_slab_rule_on_the_unet_against_shard_batch(netG, extent,
                                                       n_spatial, want):
    """Every UNet extent that JAX's ``shard_batch`` splits and the
    whole-image model takes is taken, its levels from netG's first whole
    level gathered (the innermost, one row, always); the rest refused with
    JAX's or the whole-image model's reason.  Without ``gathered`` the old
    rule refuses every one of them at netG's innermost level."""
    assert jax_splits(extent, n_spatial) == (want != "shard_batch")
    args = (extent, n_spatial, 2, 2, unet_pads(netG))
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            check_joint_slabs(*args, gathered=True)
        return
    assert check_joint_slabs(*args, gathered=True) is None
    levels = len(args[-1]) - 1
    assert first_whole_level(extent, n_spatial, levels) == want
    with pytest.raises(ValueError, match="at netG's level"):
        check_joint_slabs(*args)
