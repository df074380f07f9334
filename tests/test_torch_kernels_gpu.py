"""The port's CUDA kernels (2-D and 3-D warps, VecInt's 2-D and 3-D chains)
against their plain versions, on the card.

Skips without a CUDA card.  On a machine with one (and no JAX), run:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
Tolerances: the forward 1e-5 max-abs (it rounds as the plain version
does) and the chain forward 0.0 (bit-equal); the backward's dflow 1e-5 and
dsrc 1e-5 * max(1, max|dsrc|), the chain backward 1e-5 * max(1, max|dvec|)
(every source gradient is summed in a fixed point, in another order than
autograd's, and is bitwise the same on every run and as
``warp2d_dsrc_fixed_plain`` / ``vecint2d_bwd_fixed_plain`` /
``warp3d_dsrc_binned_plain``); a whole step card vs CPU 1e-3 relative on
the metrics and 1e-2 * the network's max |g| on the gradients, the JAX
suite's cross-program bar (cuDNN's convolutions sum in another order than
the CPU, and on this loss float32 itself is ~5e-3 of netG's max |g| from
float64)."""

import pytest
import torch
import torch.nn.functional as F

from dfmir_tpu_torch import infer
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.integrate import (vecint, vecint2d_bwd_fixed_plain,
                                           vecint_bwd_plain)
from dfmir_tpu_torch.ops.warp import (identity_grid, warp,
                                      warp2d_dsrc_fixed_plain,
                                      warp3d_dsrc_binned_plain,
                                      warp_bwd_plain)

pytestmark = pytest.mark.gpu

FWD, BWD = warp_cuda.FWD, warp_cuda.BWD
VF, VB = warp_cuda.VECINT_FWD, warp_cuda.VECINT_BWD
FWD3D, DFLOW3D, DSRC3D = warp_cuda.FWD3D, warp_cuda.DFLOW3D, warp_cuda.DSRC3D
VF3, VB3 = warp_cuda.VECINT3D_FWD, warp_cuda.VECINT3D_BWD
ZERO = dict.fromkeys(warp_cuda.LAUNCHES, 0)
SMALL = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
             vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
             netF_nc=16, num_patches=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(cuda, shape, scale, shift):
    g = torch.Generator(device=cuda).manual_seed(0)
    B, C, *spatial = shape
    src = torch.randn(shape, device=cuda, generator=g)
    flow = torch.randn((B, len(spatial), *spatial), device=cuda,
                       generator=g) * scale + shift
    return src, flow, torch.randn(shape, device=cuda, generator=g)


def max_err(a, b):
    return float((a - b).abs().max())


CASES = [
    ((1, 2, 128, 128), 5.0, 0.0),     # VecInt's self-warp shape
    ((8, 1, 256, 256), 20.0, 0.0),    # full-resolution source warps
    ((2, 1, 64, 64), 40.0, 50.0),     # most pixels sample outside
    ((3, 3, 67, 45), 3.0, 0.0),       # odd shape
]


@pytest.mark.parametrize("shape,scale,shift", CASES)
def test_warp2d_kernel_matches_plain(cuda, shape, scale, shift):
    src, flow, _ = inputs(cuda, shape, scale, shift)
    before = dict(warp_cuda.LAUNCHES)
    out = warp(src, flow)                         # auto -> the kernel
    assert warp_cuda.LAUNCHES == dict(before, **{FWD: before[FWD] + 1})
    ref = warp(src, flow, impl="torch")
    torch.cuda.synchronize()
    assert max_err(out, ref) <= 1e-5


@pytest.mark.parametrize("need_dsrc", [True, False])
@pytest.mark.parametrize("shape,scale,shift", CASES)
def test_warp2d_bwd_kernel_matches_plain(cuda, shape, scale, shift,
                                         need_dsrc):
    src, flow, g = inputs(cuda, shape, scale, shift)
    before = warp_cuda.LAUNCHES[BWD]
    dsrc, dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g, need_dsrc)
    assert warp_cuda.LAUNCHES[BWD] == before + 1
    ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, g, need_dsrc)
    torch.cuda.synchronize()
    assert max_err(dflow, ref_dflow) <= 1e-5
    if need_dsrc:
        scale = max(1.0, float(ref_dsrc.abs().max()))
        assert max_err(dsrc, ref_dsrc) <= 1e-5 * scale
    else:
        assert dsrc is None


DSRC_CASES = [*CASES,
              ((2, 3, 96, 80), 4.0, 0.0),            # C = 3
              ((1, 1, 256, 256), "collapse", 0.0),   # thousands of terms a
                                                     # pixel
              ((2048, 2, 8, 8), 2.0, 0.0)]           # more items than
                                                     # the card's blocks


@pytest.mark.parametrize("shape,scale,shift", DSRC_CASES)
def test_warp2d_bwd_dsrc_is_fixed_point(cuda, shape, scale, shift):
    """B2's dsrc is the same bits on every call and equal to its plain
    fixed-point model; its dflow is unchanged by the dsrc path."""
    if scale == "collapse":
        src, _, g = inputs(cuda, shape, 0.0, 0.0)
        flow = collapse_field((shape[0], 2, *shape[2:]), cuda)
    else:
        src, flow, g = inputs(cuda, shape, scale, shift)
    dsrc, dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g)
    again, dflow2 = warp_cuda.warp2d_bwd_cuda(src, flow, g)
    assert torch.equal(dsrc, again) and torch.equal(dflow, dflow2)
    assert torch.equal(dsrc, warp2d_dsrc_fixed_plain(flow, g))
    assert torch.equal(dflow, warp_cuda.warp2d_bwd_cuda(src, flow, g,
                                                        need_dsrc=False)[1])


def test_warp2d_bwd_dsrc_zero_and_nan_items(cuda):
    """A zero cotangent gives exactly 0; a NaN in item 0 makes item 0's dsrc
    NaN and leaves item 1 the same bits as alone."""
    src, flow, g = inputs(cuda, (2, 2, 40, 48), 3.0, 0.0)
    zero, _ = warp_cuda.warp2d_bwd_cuda(src, flow, g * 0)
    assert torch.equal(zero, torch.zeros_like(g))
    g[0, 1, 7, 9] = float("nan")
    dsrc, _ = warp_cuda.warp2d_bwd_cuda(src, flow, g)
    alone, _ = warp_cuda.warp2d_bwd_cuda(src[1:].contiguous(),
                                         flow[1:].contiguous(),
                                         g[1:].contiguous())
    assert bool(dsrc[0].isnan().all())
    assert torch.equal(dsrc[1:], alone)


def test_warp2d_autograd_launches_the_kernels(cuda):
    """warp(...).sum().backward() on the card: one forward and one backward
    launch; a data warp (src without grad) asks for dflow alone; a
    self-warp (VecInt) gets the sum of both gradients."""
    src, flow, _ = inputs(cuda, (2, 2, 32, 32), 3.0, 0.0)
    s, f = src.clone().requires_grad_(), flow.clone().requires_grad_()
    before = dict(warp_cuda.LAUNCHES)
    warp(s, f).sum().backward()
    assert warp_cuda.LAUNCHES == dict(before, **{FWD: before[FWD] + 1,
                                                 BWD: before[BWD] + 1})
    ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, torch.ones_like(src))
    assert max_err(s.grad, ref_dsrc) <= 1e-5 * max(1.0, float(
        ref_dsrc.abs().max()))
    assert max_err(f.grad, ref_dflow) <= 1e-5

    f = flow.clone().requires_grad_()
    warp(src, f).sum().backward()               # src needs no grad
    assert max_err(f.grad, ref_dflow) <= 1e-5

    v = flow.clone().requires_grad_()
    g = torch.randn_like(flow)
    warp(v, v).backward(g)
    dsrc, dflow = warp_bwd_plain(flow, flow, g)
    assert max_err(v.grad, dsrc + dflow) <= 1e-5 * max(1.0, float(
        dsrc.abs().max()))


def test_warp2d_wrapper_refuses(cuda):
    src = torch.zeros(1, 1, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_cuda.warp2d_cuda(src.double(), flow.double())
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.warp2d_cuda(src.transpose(2, 3), flow)
    with pytest.raises(ValueError, match="does not match"):
        warp_cuda.warp2d_cuda(src, flow[:, :, :4])
    with pytest.raises(ValueError, match="g must be"):
        warp_cuda.warp2d_bwd_cuda(src, flow, src[:, :, :4].contiguous())
    with pytest.raises(TypeError, match="g must be"):
        warp_cuda.warp2d_bwd_cuda(src, flow, src.cpu())
    # the backward no longer refuses: it launches its kernel once
    s = torch.randn_like(src).requires_grad_()
    before = warp_cuda.LAUNCHES[BWD]
    warp(s, flow).sum().backward()
    assert warp_cuda.LAUNCHES[BWD] == before + 1
    ref, _ = warp_bwd_plain(s, flow, torch.ones_like(src))
    assert max_err(s.grad, ref) <= 1e-5


def test_register_launches_eight_warps(cuda):
    """A register call: 1 chain forward (VecInt) + 1 warp (y_source)."""
    cfg = RegistrationConfig(**SMALL)
    gpu = RegistrationModel(cfg)
    cpu = RegistrationModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(2, 1, 1, 64, 64, generator=g)
    warp_cuda.reset_launches()
    out = infer.register_pair_outputs(gpu, a.to(cuda), b.to(cuda))
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF: 1, FWD: 1})
    ref = infer.register_pair_outputs(cpu, a, b)
    for k in ("fake_B", "y_source", "pos_flow"):
        assert max_err(out[k].cpu(), ref[k]) <= 1e-3, k


STEP2D = dict(ZERO, **{VF: 1, FWD: 2, VB: 1, BWD: 2})


def test_train_step_launches_nine_and_nine(cuda):
    """A small-config train step on the card: 1 chain forward + 2 warps
    (the stacked data warp, `registered`) and 1 chain backward + 2 warp
    backwards; metrics and gradients as on the CPU."""
    cfg = RegistrationConfig(**SMALL)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = RegistrationModel(
            cfg, device=dev, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            models[dev].netR.flow.weight.mul_(1e5)
    g = torch.Generator().manual_seed(3)
    a, b = torch.tanh(2 * torch.randn(2, 2, 1, 64, 64, generator=g))
    grads, metrics = {}, {}
    for dev, m in models.items():
        warp_cuda.reset_launches()
        m.optimizer.zero_grad()
        total, met, _ = m.loss_fn(a.to(dev), b.to(dev),
                                  generator=torch.Generator().manual_seed(4))
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert warp_cuda.LAUNCHES == STEP2D
        else:
            assert warp_cuda.LAUNCHES == ZERO
        metrics[dev] = {k: float(v.detach()) for k, v in met.items()}
        grads[dev] = {net: [p.grad.cpu() for p in getattr(m, net).parameters()]
                      for net in ("netG", "netF", "netR")}
    for k, v in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - v) <= 1e-3 * abs(v), k
    for net, ref in grads["cpu"].items():
        scale = max(float(r.abs().max()) for r in ref)
        err = max(max_err(o, r) for o, r in zip(grads["cuda"][net], ref))
        assert err <= 1e-2 * scale, (net, err, scale)

    warp_cuda.reset_launches()
    before = [p.detach().clone() for p in models["cuda"].parameters()]
    models["cuda"].train_step(a.to(cuda), b.to(cuda), 2e-4,
                              generator=torch.Generator().manual_seed(4))
    torch.cuda.synchronize()
    assert warp_cuda.LAUNCHES == STEP2D
    assert any(not torch.equal(p, q)
               for p, q in zip(models["cuda"].parameters(), before))


def smooth(shape, scale, gen):
    """(B, C, H, W) smooth random field of about +-scale on the card."""
    B, C, H, W = shape
    coarse = torch.randn((B, C, max(H // 16, 2), max(W // 16, 2)),
                         generator=gen, device=gen.device)
    return F.interpolate(coarse, size=(H, W), mode="bicubic",
                         align_corners=True) * scale


CHAIN_CASES = [
    # (B, 2, H, W), field kind, scale (px) of the velocity field
    ((1, 2, 128, 128), "smooth", 20.0),   # register's pos chain
    ((2, 2, 128, 128), "smooth", 20.0),   # the train step's pos/neg chain
    ((16, 2, 128, 128), "smooth", 20.0),  # the train step at B=8
    ((1, 2, 192, 192), "smooth", 20.0),   # backward state and sums in
                                          # global memory
    ((3, 2, 67, 45), "smooth", 10.0),     # odd shape
    ((1, 2, 128, 128), "noise", 25.0),    # violent: x25 N(0, 1)
]


def chain_field(cuda, shape, kind, scale):
    gen = torch.Generator(device=cuda).manual_seed(5)
    if kind == "noise":
        return torch.randn(shape, generator=gen, device=cuda) * scale
    return smooth(shape, scale, gen)


@pytest.mark.parametrize("shape,kind,scale", CHAIN_CASES)
def test_vecint_chain_matches_plain(cuda, shape, kind, scale):
    """The chain forward is bit-equal to the plain loop; its backward is
    within 1e-5 * max(1, max|dvec|) of autograd of the loop; one launch
    each way, the steps saved only for a gradient."""
    vec = chain_field(cuda, shape, kind, scale)
    g = torch.randn(shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(6))
    warp_cuda.reset_launches()
    out = vecint(vec, 7)                          # auto -> the chain kernel
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF: 1})
    ref = vecint(vec, 7, impl="torch")
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF: 1})
    torch.cuda.synchronize()
    assert max_err(out, ref) == 0.0
    assert float((ref - vec / 128).abs().max()) > 1.0    # it deformed

    v = vec.clone().requires_grad_()
    vecint(v, 7).backward(g)
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF: 2, VB: 1})
    dvec = vecint_bwd_plain(vec, 7, g)
    torch.cuda.synchronize()
    assert max_err(v.grad, dvec) <= 1e-5 * max(1.0, float(dvec.abs().max()))

    steps_out, steps = warp_cuda.vecint2d_fwd_cuda(vec, 7, save=True)
    assert steps.shape == (7, *shape) and torch.equal(steps_out, ref)
    again = warp_cuda.vecint2d_bwd_cuda(steps, g)
    assert torch.equal(again, warp_cuda.vecint2d_bwd_cuda(steps, g))
    assert torch.equal(again, v.grad)
    assert torch.equal(again, vecint2d_bwd_fixed_plain(steps, g))
    assert torch.equal(steps[0], vec * (1.0 / 128))
    out_ns, none = warp_cuda.vecint2d_fwd_cuda(vec, 7, save=False)
    assert none is None and torch.equal(out_ns, ref)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("shape,kind,scale",
                         [*CHAIN_CASES, ((1, 2, 512, 512), "smooth", 20.0)])
def test_vecint2d_fwd_clusters(cuda, shape, kind, scale, cluster):
    """The forward chain at clusters of 8 and 16 blocks, with its field in
    shared memory or, at 512^2, in global memory: bit-equal to the plain
    loop at 0-7 steps, saving its steps (each slot the loop's field) and
    not."""
    vec = chain_field(cuda, shape, kind, scale)
    for nsteps in range(8):
        fields = [vec * (1.0 / 2 ** nsteps)]
        for _ in range(nsteps):
            v = fields[-1]
            fields.append(v + warp(v, v, impl="torch"))
        for save in (1, 0):
            out = torch.empty_like(vec)
            steps = torch.empty((max(nsteps, 1), *shape) if save else shape,
                                device=cuda)
            warp_cuda._launch(VF, "dfmir_vecint2d_fwd", vec.get_device(),
                              vec.data_ptr(), steps.data_ptr(),
                              out.data_ptr(), shape[0], *shape[2:], nsteps,
                              save, cluster)
            assert torch.equal(out, fields[-1]), (nsteps, save)
            if save:
                for k in range(nsteps):
                    assert torch.equal(steps[k], fields[k]), (nsteps, k)


@pytest.mark.parametrize("nsteps", [0, 1, 2])
def test_vecint_chain_few_steps(cuda, nsteps):
    vec = chain_field(cuda, (2, 2, 40, 48), "smooth", 8.0)
    g = torch.randn_like(vec)
    v = vec.clone().requires_grad_()
    out = vecint(v, nsteps)
    assert torch.equal(out.detach(), vecint(vec, nsteps, impl="torch"))
    out.backward(g)
    dvec = vecint_bwd_plain(vec, nsteps, g)
    assert max_err(v.grad, dvec) <= 1e-5 * max(1.0, float(dvec.abs().max()))
    steps = warp_cuda.vecint2d_fwd_cuda(vec, nsteps, save=True)[1]
    assert torch.equal(v.grad, vecint2d_bwd_fixed_plain(steps, g))


def test_vecint_chain_refused_launch_raises(cuda):
    """A cluster larger than the card takes (32 blocks) is refused, forward
    and backward: the launcher raises, counts nothing and leaves no error
    behind."""
    vec = chain_field(cuda, (1, 2, 64, 64), "smooth", 5.0)
    steps = torch.empty((7, 1, 2, 64, 64), device=cuda)
    out = torch.empty_like(vec)
    sums = torch.empty(vec.shape, dtype=torch.int64, device=cuda)
    warp_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_cuda._launch(VF, "dfmir_vecint2d_fwd", vec.get_device(),
                          vec.data_ptr(), steps.data_ptr(), out.data_ptr(),
                          1, 64, 64, 7, 1, 32)
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_cuda._launch(VB, "dfmir_vecint2d_bwd", vec.get_device(),
                          steps.data_ptr(), vec.data_ptr(), sums.data_ptr(),
                          out.data_ptr(), 1, 64, 64, 7, 32)
    assert warp_cuda.LAUNCHES == ZERO
    out = vecint(vec, 7)
    assert torch.equal(out, vecint(vec, 7, impl="torch"))
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF: 1})


def test_vecint_chain_refuses_what_it_does_not_take(cuda):
    vec = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_cuda.vecint2d_fwd_cuda(vec.double(), 7, save=False)
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.vecint2d_fwd_cuda(vec.transpose(2, 3), 7, save=False)
    with pytest.raises(ValueError, match="does not match"):
        warp_cuda.vecint2d_fwd_cuda(torch.zeros(1, 3, 8, 8, device=cuda), 7,
                                    save=False)
    with pytest.raises(ValueError, match="steps"):
        warp_cuda.vecint2d_bwd_cuda(torch.zeros(7, 1, 2, 8, 4, device=cuda),
                                    vec)


CASES3D = [
    ((1, 3, 40, 40, 40), 2.0, 0.0),      # VecInt's self-warp shape, cut
    ((1, 1, 64, 64, 64), 3.0, 0.0),      # the data warp, cut
    ((2, 3, 17, 33, 45), 2.0, 0.0),      # odd shape
    ((1, 1, 32, 32, 32), 25.0, 0.0),     # violent: most voxels outside
    ((1, 2, 20, 24, 28), 2.0, 0.0),      # a channel count the kernels
                                         # do not specialise
    ((1, 3, 40, 40, 40), "collapse", 0.0),   # thousands of targets a cell
    ((1, 1, 128, 128, 128), 0.4, 0.0),   # the 3-D joint step's `registered`
    ((2, 1, 128, 128, 128), 0.4, 0.0),   # and its stacked data warp
]


def collapse_field(shape, device, scale=0.95):
    """(B, nd, *spatial) flow scale * (centre - p): every pixel or voxel
    samples near the centre, so thousands of targets share a few cells."""
    B, nd, *spatial = shape
    grid = identity_grid(spatial, device=device)
    centre = torch.tensor([(n - 1) / 2 for n in spatial],
                          device=device).reshape(nd, *[1] * nd)
    return (scale * (centre - grid))[None].expand(
        B, *[-1] * (nd + 1)).contiguous()


@pytest.mark.parametrize("shape,scale,shift", CASES3D)
def test_warp3d_kernels_match_plain(cuda, shape, scale, shift):
    """Each 3-D kernel against its plain version; dsrc also bitwise the same
    over two calls and as the plain binned sum."""
    if scale == "collapse":
        src, _, g = inputs(cuda, shape, 0.0, 0.0)
        flow = collapse_field((shape[0], 3, *shape[2:]), cuda)
    else:
        src, flow, g = inputs(cuda, shape, scale, shift)
    before = dict(warp_cuda.LAUNCHES)
    out = warp(src, flow, mode="trilinear")       # auto -> the kernel
    dflow = warp_cuda.warp3d_bwd_dflow_cuda(src, flow, g)
    dsrc = warp_cuda.warp3d_bwd_dsrc_cuda(flow, g)
    assert warp_cuda.LAUNCHES == dict(before, **{
        k: before[k] + 1 for k in (FWD3D, DFLOW3D, DSRC3D)})
    ref = warp(src, flow, impl="torch")
    ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, g)
    torch.cuda.synchronize()
    assert max_err(out, ref) <= 1e-5
    assert max_err(dflow, ref_dflow) <= 1e-5
    assert max_err(dsrc, ref_dsrc) <= 1e-5 * max(1.0, float(
        ref_dsrc.abs().max()))
    assert torch.equal(dsrc, warp_cuda.warp3d_bwd_dsrc_cuda(flow, g))
    assert torch.equal(dsrc, warp3d_dsrc_binned_plain(flow, g))


def test_warp3d_dsrc_zero_and_nonfinite_cotangents(cuda):
    """A zero cotangent gives exactly 0; a NaN or inf in it gives a dsrc and
    a chain gradient that are not finite where the plain versions are
    not."""
    src, flow, g = inputs(cuda, (1, 3, 20, 24, 28), 2.0, 0.0)
    assert torch.equal(warp_cuda.warp3d_bwd_dsrc_cuda(flow, g * 0),
                       torch.zeros_like(g))
    _, steps = warp_cuda.vecint3d_fwd_cuda(flow, 7, save=True)
    assert torch.equal(warp_cuda.vecint3d_bwd_cuda(steps, g * 0),
                       torch.zeros_like(g))
    for bad in (float("nan"), float("inf")):
        g2 = g.clone()
        g2[0, 1, 10, 12, 14] = bad
        ref, _ = warp_bwd_plain(src, flow, g2, need_dflow=False)
        dsrc = warp_cuda.warp3d_bwd_dsrc_cuda(flow, g2)
        assert not torch.isfinite(ref).all()
        assert not torch.isfinite(dsrc[~torch.isfinite(ref)]).any()
        dvec = vecint_bwd_plain(flow, 7, g2)
        got = warp_cuda.vecint3d_bwd_cuda(steps, g2)
        assert not torch.isfinite(got[~torch.isfinite(dvec)]).any()


def unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past an 8-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return buf.copy_(t)


def test_warp3d_kernels_take_unaligned_tensors(cuda):
    """Buffers off the 8-byte grid (an even W) give the same results: the
    kernels assume no alignment beyond a float's."""
    src, flow, g = inputs(cuda, (2, 3, 12, 14, 16), 2.0, 0.0)
    u_src, u_flow, u_g = (unaligned(t) for t in (src, flow, g))
    assert u_src.data_ptr() % 8 == 4
    ref = warp(src, flow, impl="torch")
    ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, g)
    assert max_err(warp_cuda.warp3d_cuda(u_src, u_flow), ref) <= 1e-5
    assert max_err(warp_cuda.warp3d_bwd_dflow_cuda(u_src, u_flow, u_g),
                   ref_dflow) <= 1e-5
    assert max_err(warp_cuda.warp3d_bwd_dsrc_cuda(u_flow, u_g),
                   ref_dsrc) <= 1e-5 * max(1.0, float(ref_dsrc.abs().max()))


@pytest.mark.parametrize("z0", [0, 6, 12])
def test_warp3d_slab_kernels_are_the_whole_volumes_rows(cuda, z0):
    """B3 and B4 on a slab of 6 planes from plane z0 of the source: the
    whole-volume launches' rows bit for bit, their plain versions with z0
    within 1e-5, and the slab Function's backward launching B4 alone."""
    src, flow, g = inputs(cuda, (2, 3, 18, 14, 16), 2.5, 0.0)
    rows = slice(z0, z0 + 6)
    f, gs = flow[:, :, rows].contiguous(), g[:, :, rows].contiguous()
    out = warp_cuda.warp3d_cuda(src, f, z0)
    dflow = warp_cuda.warp3d_bwd_dflow_cuda(src, f, gs, z0)
    assert torch.equal(out, warp_cuda.warp3d_cuda(src, flow)[:, :, rows])
    assert torch.equal(dflow, warp_cuda.warp3d_bwd_dflow_cuda(
        src, flow, g)[:, :, rows])
    assert max_err(out, warp(src, f, impl="torch", z0=z0)) <= 1e-5
    assert max_err(dflow, warp_bwd_plain(src, f, gs, need_dsrc=False,
                                         z0=z0)[1]) <= 1e-5
    before = dict(warp_cuda.LAUNCHES)
    leaf = f.clone().requires_grad_(True)
    warp(src, leaf, z0=z0).backward(gs)
    assert warp_cuda.LAUNCHES == dict(before, **{
        k: before[k] + 1 for k in (FWD3D, DFLOW3D)})
    assert torch.equal(leaf.grad, dflow)
    with pytest.raises(ValueError, match="not a slab"):
        warp_cuda.warp3d_cuda(src, f, 13)


@pytest.mark.parametrize("y0", [0, 20, 40])
def test_warp2d_slab_kernel_is_the_whole_images_rows(cuda, y0):
    """B1 on a slab of 20 rows from row y0 of a 60-row source: the
    whole-image launch's rows bit for bit, its plain version with y0
    within 1e-5, counted under B1's name; the slab Function's backward (a
    data warp: its source takes no gradient) launches B2's slab form
    without sums, its dflow the whole image's B2 rows bit for bit."""
    src, flow, g = inputs(cuda, (2, 3, 60, 37), 3.0, 0.0)
    rows = slice(y0, y0 + 20)
    f = flow[:, :, rows].contiguous()
    before = dict(warp_cuda.LAUNCHES)
    out = warp_cuda.warp2d_slab_cuda(src, f, y0)
    assert warp_cuda.LAUNCHES == dict(before, **{FWD: before[FWD] + 1})
    assert torch.equal(out, warp_cuda.warp2d_cuda(src, flow)[:, :, rows])
    assert max_err(out, warp(src, f, impl="torch", z0=y0)) <= 1e-5
    assert torch.equal(warp(src, f, z0=y0), out)
    leaf = f.clone().requires_grad_(True)
    before = dict(warp_cuda.LAUNCHES)
    warp(src, leaf, z0=y0).backward(g[:, :, rows])
    assert warp_cuda.LAUNCHES == dict(before, **{
        FWD: before[FWD] + 1, BWD: before[BWD] + 1})
    full = torch.zeros_like(g)
    full[:, :, rows] = g[:, :, rows]
    _, whole_dflow = warp_cuda.warp2d_bwd_cuda(src, flow, full,
                                               need_dsrc=False)
    assert torch.equal(leaf.grad, whole_dflow[:, :, rows])
    with pytest.raises(ValueError, match="not a slab"):
        warp_cuda.warp2d_slab_cuda(src, f, 41)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("C", [1, 2])
def test_warp2d_bwd_slab_sums_are_the_whole_images(cuda, n, C):
    """B2 on n row slabs of a (2, C, 64, 48) image, each in its items'
    fixed point of max|g[b]| over the whole cotangent (the items a
    hundredfold apart): every slab's dflow the whole image's B2 rows bit
    for bit and within 1e-5 of its plain version; its int64 sums twice the
    same and equal to the plain slab model's; the slabs' sums added up,
    as floats, the whole image's B2 dsrc bit for bit."""
    from dfmir_tpu_torch.ops.warp import from_fixed, item_max_bits
    src, flow, g = inputs(cuda, (2, C, 64, 48), 3.0, 0.0)
    g[1] *= 100.0
    whole_dsrc, whole_dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g)
    mbits = item_max_bits(g)
    h = 64 // n
    total = 0
    for r in range(n):
        rows = slice(r * h, (r + 1) * h)
        f, gs = flow[:, :, rows].contiguous(), g[:, :, rows].contiguous()
        before = dict(warp_cuda.LAUNCHES)
        sums, dflow = warp_cuda.warp2d_bwd_slab_cuda(src, f, gs, r * h,
                                                     mbits)
        assert warp_cuda.LAUNCHES == dict(before, **{BWD: before[BWD] + 1})
        assert sums.dtype == torch.int64 and sums.shape == src.shape
        assert torch.equal(dflow, whole_dflow[:, :, rows])
        assert max_err(dflow, warp_bwd_plain(src, f, gs, need_dsrc=False,
                                             z0=r * h)[1]) <= 1e-5
        again, _ = warp_cuda.warp2d_bwd_slab_cuda(src, f, gs, r * h, mbits)
        assert torch.equal(sums, again)
        assert torch.equal(sums, warp2d_dsrc_fixed_plain(
            f, gs, r * h, 64, mbits, sums=True))
        none, dflow_only = warp_cuda.warp2d_bwd_slab_cuda(src, f, gs, r * h)
        assert none is None and torch.equal(dflow_only, dflow)
        total = total + sums
    assert torch.equal(from_fixed(total, mbits.reshape(-1, 1, 1, 1),
                                  64 * 48), whole_dsrc)
    with pytest.raises(ValueError, match="not a slab"):
        warp_cuda.warp2d_bwd_slab_cuda(src, flow[:, :, :h].contiguous(),
                                       g[:, :, :h].contiguous(), 64 - h + 1,
                                       mbits)
    with pytest.raises(ValueError, match="mbits"):
        warp_cuda.warp2d_bwd_slab_cuda(src, flow[:, :, :h].contiguous(),
                                       g[:, :, :h].contiguous(), 0,
                                       mbits[:1])


@pytest.mark.parametrize("n", [2, 3])
def test_warp3d_dsrc_slab_sums_are_the_whole_volumes(cuda, n):
    """B5 on n slabs of a (2, 3, 18, 14, 16) volume, each in the fixed
    point of max|g| over the whole cotangent: the slabs' int64 sums add up
    to the whole-volume B5's integers, so their value equals it bit for
    bit; each slab's sums equal the plain slab model's, twice the same."""
    from dfmir_tpu_torch.ops.warp import abs_max_bits, from_fixed
    _, flow, g = inputs(cuda, (2, 3, 18, 14, 16), 2.5, 0.0)
    mbits = abs_max_bits(g)
    d = 18 // n
    total = 0
    for r in range(n):
        rows = slice(r * d, (r + 1) * d)
        f, gs = flow[:, :, rows].contiguous(), g[:, :, rows].contiguous()
        before = dict(warp_cuda.LAUNCHES)
        sums = warp_cuda.warp3d_bwd_dsrc_slab_cuda(f, gs, r * d, 18, mbits)
        assert warp_cuda.LAUNCHES == dict(before,
                                          **{DSRC3D: before[DSRC3D] + 1})
        assert sums.dtype == torch.int64 and sums.shape == g.shape
        assert torch.equal(sums, warp_cuda.warp3d_bwd_dsrc_slab_cuda(
            f, gs, r * d, 18, mbits))
        assert torch.equal(sums, warp3d_dsrc_binned_plain(
            f, gs, r * d, 18, mbits, sums=True))
        total = total + sums
    whole = warp_cuda.warp3d_bwd_dsrc_cuda(flow, g)
    assert torch.equal(from_fixed(total, mbits, 18 * 14 * 16), whole)
    with pytest.raises(ValueError, match="0 <= z0"):
        warp_cuda.warp3d_bwd_dsrc_slab_cuda(flow[:, :, :6].contiguous(),
                                            g[:, :, :6].contiguous(), 13,
                                            18, mbits)


def test_warp3d_zero_flow_copies_the_source(cuda):
    src, _, _ = inputs(cuda, (1, 2, 20, 24, 28), 0.0, 0.0)
    out = warp_cuda.warp3d_cuda(src, torch.zeros((1, 3, 20, 24, 28),
                                                 device=cuda))
    assert torch.equal(out, src)


def test_warp3d_autograd_launches_the_kernels(cuda):
    """A data warp (src without grad) launches dflow alone; a self-warp
    (VecInt) launches both halves and gets the sum of both gradients."""
    src, flow, _ = inputs(cuda, (1, 1, 24, 24, 24), 2.0, 0.0)
    f = flow.clone().requires_grad_()
    before = dict(warp_cuda.LAUNCHES)
    warp(src, f).sum().backward()
    assert warp_cuda.LAUNCHES == dict(before, **{
        FWD3D: before[FWD3D] + 1, DFLOW3D: before[DFLOW3D] + 1})
    _, ref_dflow = warp_bwd_plain(src, flow, torch.ones_like(src))
    assert max_err(f.grad, ref_dflow) <= 1e-5

    v = flow.clone().requires_grad_()
    g = torch.randn_like(flow)
    before = dict(warp_cuda.LAUNCHES)
    warp(v, v).backward(g)
    assert warp_cuda.LAUNCHES == dict(before, **{
        k: before[k] + 1 for k in (FWD3D, DFLOW3D, DSRC3D)})
    dsrc, dflow = warp_bwd_plain(flow, flow, g)
    assert max_err(v.grad, dsrc + dflow) <= 1e-5 * max(1.0, float(
        dsrc.abs().max()))


def smooth3d(shape, scale, gen):
    """(B, C, D, H, W) smooth random field of about +-scale on the card."""
    B, C, *spatial = shape
    coarse = torch.randn((B, C, *(max(n // 16, 2) for n in spatial)),
                         generator=gen, device=gen.device)
    return F.interpolate(coarse, size=tuple(spatial), mode="trilinear",
                         align_corners=True) * scale


CHAIN3D_CASES = [
    # (B, 3, D, H, W), field kind, scale (voxels) of the velocity field
    # (for "edge", max|v_0| exactly), steps
    ((1, 3, 80, 80, 80), "smooth", 10.0, 7),   # a 3-D register call / step
    ((1, 3, 80, 80, 80), "smooth", 2.0, 7),    # mild: halo 2 or less
    ((2, 3, 80, 80, 80), "posneg", 10.0, 7),   # a bidirectional pos/neg stack
    ((2, 3, 17, 33, 45), "smooth", 5.0, 7),    # odd shape
    ((1, 3, 40, 40, 40), "noise", 25.0, 7),    # violent: x25 N(0, 1)
    ((1, 3, 40, 40, 40), "collapse", 4.0, 7),  # contracts to the centre
    ((1, 3, 40, 40, 40), "edge", 1.0, 2),      # displacements at halo 1,
    ((1, 3, 40, 40, 40), "edge", 2.0, 2),      # at the most staged, 2,
    ((1, 3, 40, 40, 40), "edge", 3.0, 2),      # and past it
    ((1, 3, 64, 64, 64), "smooth", 10.0, 7),   # the 3-D joint model's
    ((2, 3, 64, 64, 64), "posneg", 10.0, 7),   # register call and step
]


def chain3d_field(cuda, shape, kind, scale, nsteps=7):
    gen = torch.Generator(device=cuda).manual_seed(7)
    if kind == "collapse":
        return collapse_field(shape, cuda, scale)
    if kind == "edge":
        v = smooth3d(shape, 1.0, gen)
        return v / v.abs().max() * (scale * 2 ** nsteps)
    if kind == "noise":
        return torch.randn(shape, generator=gen, device=cuda) * scale
    if kind == "posneg":
        half = smooth3d((shape[0] // 2, *shape[1:]), scale, gen)
        return torch.cat([half, -half])
    return smooth3d(shape, scale, gen)


@pytest.mark.parametrize("shape,kind,scale,nsteps", CHAIN3D_CASES)
def test_vecint3d_chain_matches_plain(cuda, shape, kind, scale, nsteps):
    """The 3-D chain forward is bit-equal to the plain loop, saving its
    steps and not; its backward is within 1e-5 * max(1, max|dvec|) of
    autograd of the loop and bitwise the same over two calls; one launch
    each way, the steps saved only for a gradient."""
    vec = chain3d_field(cuda, shape, kind, scale, nsteps)
    g = torch.randn(shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(8))
    warp_cuda.reset_launches()
    out = vecint(vec, nsteps)                     # auto -> the chain kernel
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 1})
    ref = vecint(vec, nsteps, impl="torch")
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 1})
    torch.cuda.synchronize()
    assert max_err(out, ref) == 0.0
    if kind == "edge":      # the first step's largest move is exactly scale
        assert float((vec / 2 ** nsteps).abs().max()) == scale
    else:
        assert float((ref - vec / 2 ** nsteps).abs().max()) > 1.0

    v = vec.clone().requires_grad_()
    vecint(v, nsteps).backward(g)
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 2, VB3: 1})
    dvec = vecint_bwd_plain(vec, nsteps, g)
    torch.cuda.synchronize()
    assert max_err(v.grad, dvec) <= 1e-5 * max(1.0, float(dvec.abs().max()))

    steps_out, steps = warp_cuda.vecint3d_fwd_cuda(vec, nsteps, save=True)
    assert steps.shape == (nsteps, *shape) and torch.equal(steps_out, ref)
    again = warp_cuda.vecint3d_bwd_cuda(steps, g)
    assert torch.equal(again, warp_cuda.vecint3d_bwd_cuda(steps, g))
    assert torch.equal(again, v.grad)
    assert torch.equal(steps[0], vec * (1.0 / 2 ** nsteps))
    out_ns, none = warp_cuda.vecint3d_fwd_cuda(vec, nsteps, save=False)
    assert none is None and torch.equal(out_ns, ref)


@pytest.mark.parametrize("nsteps", [0, 1, 2])
def test_vecint3d_chain_few_steps(cuda, nsteps):
    vec = chain3d_field(cuda, (2, 3, 20, 24, 30), "smooth", 6.0)
    g = torch.randn_like(vec)
    v = vec.clone().requires_grad_()
    out = vecint(v, nsteps)
    assert torch.equal(out.detach(), vecint(vec, nsteps, impl="torch"))
    out.backward(g)
    dvec = vecint_bwd_plain(vec, nsteps, g)
    assert max_err(v.grad, dvec) <= 1e-5 * max(1.0, float(dvec.abs().max()))


def test_vecint3d_chain_takes_unaligned_tensors(cuda):
    """An input and cotangent off the 8-byte grid: the chain reads them
    through their own paths and gives the same results."""
    vec = unaligned(chain3d_field(cuda, (1, 3, 16, 18, 20), "smooth", 6.0))
    g = unaligned(torch.randn_like(vec))
    out, steps = warp_cuda.vecint3d_fwd_cuda(vec, 7, save=True)
    assert torch.equal(out, vecint(vec, 7, impl="torch"))
    dvec = vecint_bwd_plain(vec, 7, g)
    assert max_err(warp_cuda.vecint3d_bwd_cuda(steps, g), dvec) <= 1e-5 * max(
        1.0, float(dvec.abs().max()))


def test_vecint3d_chain_refused_launch_raises(cuda):
    """A cooperative grid larger than the card holds at once (the chains',
    B5's) is refused:
    the launcher raises, counts nothing and leaves no error behind."""
    shape = (1, 3, 16, 16, 16)
    vec = chain3d_field(cuda, shape, "smooth", 5.0)
    steps = warp_cuda.stack3d(vec, 7)
    slot = steps.stride(0)
    out, scratch = torch.empty_like(vec), vec.new_empty((2, *shape))
    bins = warp_cuda._bins3d(vec, 7)
    too_many = 10 ** 6                            # blocks, > the card holds
    maxes = torch.empty(warp_cuda._bricks3d(shape), dtype=torch.int32,
                        device=cuda)
    warp_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_cuda._launch(VF3, "dfmir_vecint3d_fwd", vec.get_device(),
                          vec.data_ptr(), steps.data_ptr(), slot,
                          out.data_ptr(), maxes.data_ptr(), 1, 16, 16, 16, 7,
                          1, too_many)
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_cuda._launch(VB3, "dfmir_vecint3d_bwd", vec.get_device(),
                          steps.data_ptr(), slot, vec.data_ptr(),
                          scratch.data_ptr(), bins.data_ptr(), out.data_ptr(),
                          1, 16, 16, 16, 7, too_many)
    with pytest.raises(RuntimeError, match="launch failed"):  # B5 too
        warp_cuda._launch(DSRC3D, "dfmir_warp3d_bwd_dsrc", vec.get_device(),
                          vec.data_ptr(), vec.data_ptr(), out.data_ptr(),
                          warp_cuda._bins3d(vec, 1).data_ptr(), *shape,
                          too_many)
    assert warp_cuda.LAUNCHES == ZERO
    out = vecint(vec, 7)
    assert torch.equal(out, vecint(vec, 7, impl="torch"))
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 1})


@pytest.mark.parametrize("shape", [(2, 3, 17, 33, 45), (1, 3, 16, 16, 16)])
def test_vecint3d_stack_slots_start_on_lines(cuda, shape):
    """Every field of the 3-D chain's stack starts on a 128-byte line, the
    odd shape's too; the chain reads no field through L1, so a stack off
    its line, or with a slot that is no multiple of 32 floats, gives the
    same bits, and a slot smaller than a field is refused before the
    launch, counting nothing."""
    vec = chain3d_field(cuda, shape, "smooth", 5.0)
    steps = warp_cuda.stack3d(vec, 7)
    assert steps.shape == (7, *shape) and steps.stride(0) % 32 == 0
    assert all(steps[k].data_ptr() % 128 == 0 for k in range(7))
    ref = vecint(vec, 7, impl="torch")
    maxes = torch.empty(warp_cuda._bricks3d(shape), dtype=torch.int32,
                        device=cuda)
    raw = torch.empty(7 * vec.numel() + 64, device=cuda)
    for offset, slot in ((1, vec.numel()), (0, vec.numel() + 1)):
        out = torch.empty_like(vec)
        warp_cuda._launch(VF3, "dfmir_vecint3d_fwd", vec.get_device(),
                          vec.data_ptr(), raw[offset:].data_ptr(), slot,
                          out.data_ptr(), maxes.data_ptr(), shape[0],
                          *shape[2:], 7, 1, 0)
        assert torch.equal(out, ref)
        assert torch.equal(raw[offset:offset + vec.numel()].view(vec.shape),
                           vec * (1.0 / 128))
    warp_cuda.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        warp_cuda._launch(VF3, "dfmir_vecint3d_fwd", vec.get_device(),
                          vec.data_ptr(), raw.data_ptr(), vec.numel() - 1,
                          out.data_ptr(), maxes.data_ptr(), shape[0],
                          *shape[2:], 7, 1, 0)
    assert warp_cuda.LAUNCHES == ZERO


def test_vecint3d_chain_refuses_what_it_does_not_take(cuda):
    vec = torch.zeros(1, 3, 4, 6, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_cuda.vecint3d_fwd_cuda(vec.double(), 7, save=False)
    with pytest.raises(ValueError, match="contiguous"):
        warp_cuda.vecint3d_fwd_cuda(vec.transpose(3, 4), 7, save=False)
    with pytest.raises(ValueError, match="does not match"):
        warp_cuda.vecint3d_fwd_cuda(torch.zeros(1, 2, 4, 6, 8, device=cuda),
                                    7, save=False)
    with pytest.raises(ValueError, match="expected 5-D"):
        warp_cuda.vecint3d_fwd_cuda(torch.zeros(1, 3, 6, 8, device=cuda), 7,
                                    save=False)
    with pytest.raises(ValueError, match="steps"):
        warp_cuda.vecint3d_bwd_cuda(
            torch.zeros(7, 1, 3, 4, 6, 4, device=cuda), vec)


def test_vxm_engine_3d_launches_and_matches_cpu(cuda):
    """A small 3-D engine on the card: 1 chain forward + 1 data warp a
    register call; 1 chain forward + 1 data warp, 1 chain backward + 1
    dflow and no dsrc a train step; metrics and gradients as on the CPU."""
    cfg = VxmConfig(vol_size=32, enc=(8, 16, 16), dec=(16, 16, 16, 16, 8))
    engines = {dev: VxmEngine(cfg, device=dev, seed=1)
               for dev in ("cuda", "cpu")}
    for eng in engines.values():
        with torch.no_grad():
            eng.netR.flow.weight.mul_(1e5)
    g = torch.Generator().manual_seed(2)
    a, b = torch.rand(2, 1, 1, 32, 32, 32, generator=g)
    warp_cuda.reset_launches()
    y, flow = engines["cuda"].register(a.to(cuda), b.to(cuda))
    assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 1, FWD3D: 1})
    y_ref, flow_ref = engines["cpu"].register(a, b)
    assert max_err(y.cpu(), y_ref) <= 1e-3
    assert max_err(flow.cpu(), flow_ref) <= 1e-3
    grads, metrics = {}, {}
    for dev, eng in engines.items():
        warp_cuda.reset_launches()
        eng.optimizer.zero_grad()
        total, met = eng.loss_fn(a.to(dev), b.to(dev))
        total.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert warp_cuda.LAUNCHES == dict(ZERO, **{VF3: 1, FWD3D: 1,
                                                       VB3: 1, DFLOW3D: 1})
        metrics[dev] = {k: float(v.detach()) for k, v in met.items()}
        grads[dev] = [p.grad.cpu() for p in eng.netR.parameters()]
    for k, v in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - v) <= 1e-3 * abs(v), k
    for o, r in zip(grads["cuda"], grads["cpu"]):
        assert max_err(o, r) <= 1e-2 * float(r.abs().max())


# augment's SVF fields (ops/augment.py: max(s // 8, 2) an axis, N(0, 1), 5
# steps): bands of a cluster with no rows (H = 8 and 2 in 16 blocks), a
# short last band (H = 25), fields smaller than the 3-D brick (20^3, 2^3)
SMALL_CHAIN_CASES = [(8, 2, 8, 8), (8, 2, 2, 2), (1, 2, 25, 25),
                     (8, 2, 32, 32), (1, 3, 20, 20, 20), (2, 3, 2, 2, 2)]


@pytest.mark.parametrize("shape", SMALL_CHAIN_CASES)
def test_vecint_chain_small_fields(cuda, shape):
    """At augment's field sizes and 5 steps: one chain launch, bit-equal to
    the plain loop; the backward within its bar of autograd of the loop."""
    vec = torch.randn(shape, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(9))
    chain = VF if len(shape) == 4 else VF3
    back = VB if len(shape) == 4 else VB3
    warp_cuda.reset_launches()
    out = vecint(vec, 5)
    assert warp_cuda.LAUNCHES == dict(ZERO, **{chain: 1})
    ref = vecint(vec, 5, impl="torch")
    torch.cuda.synchronize()
    assert max_err(out, ref) == 0.0
    g = torch.randn_like(vec)
    v = vec.clone().requires_grad_()
    vecint(v, 5).backward(g)
    assert warp_cuda.LAUNCHES == dict(ZERO, **{chain: 2, back: 1})
    dvec = vecint_bwd_plain(vec, 5, g)
    assert max_err(v.grad, dvec) <= 1e-5 * max(1.0, float(dvec.abs().max()))


@pytest.mark.parametrize("shape", [(8, 1, 64, 64), (1, 1, 24, 24, 24)])
def test_augment_launches_and_matches_cpu(cuda, shape):
    """augment's deterministic part on the card: 1 chain forward + 1 B1 /
    B3, the nearest label warp the plain gather; image and flow within
    1e-4 of the CPU's with the same draws, labels only their values."""
    from dfmir_tpu_torch.ops import augment
    spatial = shape[2:]
    draws = augment.draw_deformation(torch.Generator().manual_seed(4),
                                     shape[0], spatial)
    gen = torch.Generator().manual_seed(5)
    src = torch.randn(shape, generator=gen)
    lab = torch.randint(0, 4, shape, generator=gen).float()
    out = {}
    for dev in ("cuda", "cpu"):
        warp_cuda.reset_launches()
        d = augment.DeformationDraws(*(x.to(dev) for x in draws))
        flow = augment.deformation_from_draws(d, spatial)
        out[dev] = augment.deform(src.to(dev), flow, lab.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            fwd = {VF: 1, FWD: 1} if len(spatial) == 2 else {VF3: 1,
                                                              FWD3D: 1}
            assert warp_cuda.LAUNCHES == dict(ZERO, **fwd)
    (img, lb, flow), (img_c, lb_c, flow_c) = out["cuda"], out["cpu"]
    assert max_err(flow.cpu(), flow_c) <= 1e-4
    assert max_err(img.cpu(), img_c) <= 1e-4
    assert set(lb.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0}
