#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dfmir_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing one JSON line:
  1. device   the card (nvidia-smi name and power limit); TF32 off for
              convs and matmuls, so every comparison is float32 to float32
  2. build    nvcc builds every kernel from dfmir_tpu_torch/csrc/
  3. kernel   each 2-D kernel against its plain PyTorch version on the card
              at the main paths' shapes and a few hard ones (forward max-abs
              <= 1e-5; backward dflow <= 1e-5, dsrc <= 1e-5 * max(1,
              max|dsrc|) of autograd and, two calls bitwise the same,
              bit-equal to the fixed-point sum warp2d_dsrc_fixed_plain, in a
              collapse and with more items than blocks too), timed with
              CUDA events beside its byte/op bound and the one PyTorch call
              that computes the same function, B2's device us at every
              case; a host-clock breakdown of one B1 call and one
              B2 call at (1,1,256,256), part by part, on the earlier launch
              path (rebuilt here) and on the lean path, and of each 3-D
              launcher at (1,3,80,80,80) beside the library calls; VecInt's
              2-D chain kernels (vecint2d_fwd bit-equal to the plain loop,
              saving its steps and not, its field in the clusters' shared
              memory or, at (1,2,512,512), in global memory; vecint2d_bwd
              within 1e-5 * max(1, max|dvec|) of autograd of it, bitwise
              the same over two calls and equal to
              vecint2d_bwd_fixed_plain; both at clusters of 8 and 16 blocks)
              beside two chains built here: 7 direct B1 / B2 launches
              with their adds, and the chain written with F.grid_sample;
              at the main cases each chain at nsteps 1..7 (a step's cost,
              the fixed cost)
  4. register the paper's model at full width (RegistrationConfig
              defaults: crop 256, ngf 64, resnet_9blocks, VxmDense
              (16,32,32,64,64,64)/(64,64,64,32,32,32,16), 7 integration
              steps), random weights from --seed with the flow head scaled so
              the field deforms: 4 pairs at B=1 through
              infer.register_pair_outputs as test.py serves them, kernel
              launches counted over that run (1 chain forward + 1 B1 a
              call), one pair against the same
              weights on the CPU (max-abs <= 1e-3), then ms/pair at B=1 and
              pairs/s at B=8
  5. train    the joint translate-and-register step at the same full width
              (mlp_sample netF, 256 patches, nce_layers 0,4,8,12,16): one
              loss_fn on the card against the same weights and patch ids on
              the CPU (metrics within 1e-3 relative), then 1 warm-up and 5
              timed train_step calls at B=1, kernel launches counted over
              them (exactly 1 chain forward + 2 B1 and 1 chain backward + 2
              B2 a step), every metric
              finite and every parameter moved; a reduced-width step (crop
              64, ngf 8) card against CPU (metrics 1e-3 relative; gradients
              within 1e-2 * the network's max |g| of the CPU in float32 and
              1e-3 of the CPU in float64); then ms/step at B=1 and B=8
  6. kernel3d each 3-D trilinear kernel (forward, dflow, dsrc) against its
              plain version on the card: VecInt's self-warp (1,3,80,80,80),
              the 160^3 data warp (dflow only), an odd shape, a violent
              flow (x25 N(0,1)), a zero flow (an exact copy) and a collapse
              (flow 0.95 * (centre - p): thousands of targets a cell); bars
              forward and dflow 1e-5, dsrc 1e-5 * max(1, max|dsrc|) and,
              two calls bitwise the same, bit-equal to the plain binned sum
              (warp3d_dsrc_binned_plain); timed beside its byte/op bound,
              its plain version, grid_sample / grid_sampler_3d_backward and
              two yardsticks of dsrc built here from
              csrc/yardsticks/dsrc3d.cu (its phases as 4 plain launches; an
              int64 atomic scatter of the same terms), with device us a
              launch at the VecInt and 160^3 cases; then VecInt's 3-D
              chain kernels (phase kernel_chain3d: (1,3,80^3) at +-10 and
              +-2 voxels (mild), a (2,3,80^3) pos/neg stack, first steps
              moving exactly 1, 2 and 3 voxels (the halo staged and past
              it), an odd shape, a x25 N(0,1) field, a collapse, 0-2
              steps; vecint3d_fwd bit-equal to the plain loop saving its
              steps and not, each step's bricks by halo and share of
              corners read from L2; vecint3d_bwd within 1e-5 * max(1,
              max|dvec|) and two calls bitwise the same) beside 7 direct
              B3 / B4 + B5 launches with their adds and the F.grid_sample
              chain
  7. vxm3d    the 3-D VoxelMorph engine at VxmConfig() defaults (160^3,
              enc (16,32,32,32), dec (32,32,32,32,32,16,16), 7 integration
              steps at half resolution, NCC 9^3), random weights from --seed
              with the flow head scaled: 4 register calls counted (1 chain
              forward + 1 B3 each), one register and one eval_step
              against the same weights on the CPU (1e-3), 1 warm-up + 5
              timed train steps counted (1 chain forward + 1 B3 + 1 chain
              backward + 1 B4 each, no B5; metrics finite, every parameter
              moved), 20 steps at lr 1e-3
              on one pair (the loss falls), a 64^3 step's gradients card vs
              CPU in float32 (1e-2 of each tensor's max |g|) and float64
              (1e-3); ms per register and per step at B=1, peak memory
  8. profile  (--profile only) device time by kernel and by conv shape
              over register calls, 2-D and 3-D train steps, netG / netR
              times, register calls with cuDNN's autotuner on, and each
              kernel's device time a launch beside grid_sampler_2d / _3d
Each phase's wall seconds follow it.  Then the kernels line (all nine
kernels, their launches by path: register, train, register3d, train3d),
and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --steps

runs the device and build phases and phase chain_steps alone: the chains
redesigned last (vecint2d_fwd, vecint2d_bwd, vecint3d_fwd) at nsteps
1..7 at their main cases, B2 with both gradients at the `registered`,
VecInt-step and collapse cases beside grid_sampler_2d_backward, and one
grid.sync() and one cluster barrier alone (csrc/yardsticks/sync.cu); it
prints no result line.  It calls the kernels through their wrappers
alone, so it also runs from an earlier commit's tree.

Exits non-zero, printing no result, without a CUDA card.  Every failure
propagates.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dfmir_tpu_torch import infer
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.ops import _build, integrate, warp_cuda
from dfmir_tpu_torch.ops.integrate import vecint, vecint_bwd_plain
from dfmir_tpu_torch.ops.warp import (_kernel_takes, identity_grid, warp,
                                      warp2d_dsrc_fixed_plain,
                                      warp3d_dsrc_binned_plain,
                                      warp_bwd_plain)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5
PATH_TOL = 1e-3
FLOW_GAIN = 1e5          # flow head N(0, 1e-5) -> N(0, 1)
N_PAIRS = 4
TRAIN_STEPS = 5          # timed, after one warm-up step
# card vs CPU gradients: within GRAD_ENV * the network's max |g|, the JAX
# suite's cross-program bar: the CPU's own float32 gradient is ~5e-3 of
# netG's max |g| from float64 on this loss (the NCE's T = 0.07 softmax and
# netF's normalisation of near-zero projections amplify rounding).  The
# card against the CPU in float64: within GRAD_ENV_F64 (measured ~2e-5)
GRAD_ENV = 1e-2
GRAD_ENV_F64 = 1e-3
FWD, BWD = warp_cuda.FWD, warp_cuda.BWD
VF, VB = warp_cuda.VECINT_FWD, warp_cuda.VECINT_BWD
FWD3D, DFLOW3D, DSRC3D = warp_cuda.FWD3D, warp_cuda.DFLOW3D, warp_cuda.DSRC3D
VF3, VB3 = warp_cuda.VECINT3D_FWD, warp_cuda.VECINT3D_BWD
ZERO = dict.fromkeys(warp_cuda.LAUNCHES, 0)
# launches a 2-D register call makes: VecInt's chain + the y_source warp
REGISTER_LAUNCHES = {VF: 1, FWD: 1}
# a 2-D train step: the chain, the stacked source/target warp and
# `registered`, each forward and backward
STEP_LAUNCHES = {VF: 1, FWD: 2, VB: 1, BWD: 2}
NSTEPS = 7               # VecInt's integration steps
DEVICE = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=100, warmup=10):
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def smooth_field(shape, scale, gen, device):
    """(B, C, H, W) smooth random field of about +-scale."""
    B, C, H, W = shape
    coarse = torch.randn((B, C, max(H // 16, 2), max(W // 16, 2)),
                         generator=gen, device=device)
    return F.interpolate(coarse, size=(H, W), mode="bicubic",
                         align_corners=True) * scale


# ------------------------------------------------------------ phase 1
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False})
    return smi


# ------------------------------------------------------------ phase 2
YARD_DIR = _build.CSRC_DIR / "yardsticks"
_P, _I = ctypes.c_void_p, ctypes.c_int
YARD_SIGNATURES = {
    "dsrc3d.cu": {
        # (flow, g, dsrc, bins, B, C, D, H, W, phase, stream) -> cudaError_t
        "dfmir_yard_dsrc3d_phased": [_P] * 4 + [_I] * 6 + [_P],
        # (flow, g, dsrc, acc, B, C, D, H, W, stream) -> cudaError_t
        "dfmir_yard_dsrc3d_scatter64": [_P] * 4 + [_I] * 5 + [_P]},
    "sync.cu": {
        # (blocks, nsyncs, stream) -> cudaError_t
        "dfmir_yard_grid_sync": [_I, _I, _P],
        # (clusters, size, nsyncs, stream) -> cudaError_t
        "dfmir_yard_cluster_sync": [_I, _I, _I, _P]},
}
_yard = {}


def phase_build():
    """nvcc builds the port's library (ops/_build.py) and, at once, the
    yardsticks' libraries (csrc/yardsticks/, one each)."""
    lib = _build.library_path()
    existed = lib.exists()
    t0 = time.perf_counter()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in YARD_SIGNATURES:
        out = _build.BUILD_DIR / f"libdfmir_yard_{name[:-3]}.{os.getpid()}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
             str(YARD_DIR / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.load()
    for name, (out, proc) in procs.items():
        output = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {YARD_DIR / name}:\n{output}")
        lib_y = ctypes.CDLL(str(out))
        for entry, argtypes in YARD_SIGNATURES[name].items():
            fn = getattr(lib_y, entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _yard[entry] = fn
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": not existed, "library": lib.name,
          "sources": [str(p.relative_to(_build.PKG_DIR.parent))
                      for p in _build.sources()],
          "yardsticks": [str((YARD_DIR / n).relative_to(
              _build.PKG_DIR.parent)) for n in YARD_SIGNATURES]})


def yard_dsrc3d(entry, flow, g):
    """A yardstick of B5 (csrc/yardsticks/dsrc3d.cu): returns a call that
    launches it on the current stream and returns its dsrc, its output and
    scratch allocated here once; ``call(p)`` launches phase p alone of the
    phased one."""
    B, C, D, H, W = g.shape
    dsrc = torch.empty_like(g)
    if entry == "phased":
        scratch = warp_cuda._bins3d(g, 1)
    else:
        scratch = torch.empty(g.numel() + 1, dtype=torch.int64,
                              device=g.device)
    fn = _yard[f"dfmir_yard_dsrc3d_{entry}"]
    d = g.get_device()

    def call(phase=-1):
        extra = (phase,) if entry == "phased" else ()
        err = fn(flow.data_ptr(), g.data_ptr(), dsrc.data_ptr(),
                 scratch.data_ptr(), B, C, D, H, W, *extra,
                 torch._C._cuda_getCurrentRawStream(d))
        if err:
            raise RuntimeError(f"yardstick {entry}: cudaError {err}")
        return dsrc

    return call


# ------------------------------------------------------------ phase 3
WARP_CASES = [
    # name, (B, C, H, W), flow scale (px), flow shift (px)
    ("vecint_step", (1, 2, 128, 128), 5.0, 0.0),   # one VecInt step
    ("y_source_b1", (1, 1, 256, 256), 5.0, 0.0),
    ("y_source_b8", (8, 1, 256, 256), 20.0, 0.0),
    ("mostly_outside", (2, 1, 128, 128), 40.0, 90.0),
    ("odd_shape", (3, 3, 67, 45), 3.0, 0.0),
]
MAIN_CASE = "y_source_b1"   # the single warp of a register call


def warp2d_bound(B, C, H, W):
    """Least time for the warp's work: flow read once, src read once, out
    written once; ~12 flops a pixel for coordinates and weights, 7 a
    channel for the corner sum."""
    nbytes = 4 * (B * 2 * H * W + 2 * B * C * H * W)
    flops = B * H * W * (12 + 7 * C)
    return bound(nbytes, flops)


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the larger of bytes over HBM's rate and
    float32 operations over the card's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def normalised_grid(flow):
    """grid_sample's normalised (x, y) grid for the pixel flow."""
    H, W = flow.shape[2:]
    locs = identity_grid((H, W), device=flow.device)[None] + flow
    return torch.stack([2 * (locs[:, 1] / (W - 1) - 0.5),
                        2 * (locs[:, 0] / (H - 1) - 0.5)], dim=-1)


def grid_sample_call(src, flow):
    """The one PyTorch call computing the same function (the yardstick):
    grid_sample on the flow's normalised coordinates, built beforehand."""
    grid = normalised_grid(flow)
    return lambda: F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def phase_kernel(seed, profile):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    for name, (B, C, H, W), scale, shift in WARP_CASES:
        src = torch.randn((B, C, H, W), generator=gen, device=dev)
        flow = smooth_field((B, 2, H, W), scale, gen, dev) + shift
        out = warp_cuda.warp2d_cuda(src, flow)
        torch.cuda.synchronize()
        ref = warp(src, flow, impl="torch")
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        library = grid_sample_call(src, flow)
        lib_err = float((library() - ref).abs().max())
        outside = float(((out == 0).float().mean()))
        bound_ms, bound_by = warp2d_bound(B, C, H, W)
        kernel = lambda: warp_cuda.warp2d_cuda(src, flow)  # noqa: E731
        row = {
            "case": name, "shape": [B, C, H, W], "flow_px": scale,
            "shift_px": shift, "max_abs_err": err,
            "zero_fraction": outside,
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: warp(src, flow, impl="torch"),
                                reps=50),
            "library_ms": time_ms(library),
            "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        if profile:
            row["device_us_per_launch"] = device_us(kernel, FWD)
            # cuDNN's grid sampler on 4-D input: every kernel of the call
            row["library_device_us_per_call"] = device_us(library)
        emit({"phase": "kernel", "kernel": FWD, **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp2d kernel disagrees with its plain "
                                 f"version on {name}: {err} > {KERNEL_TOL}")
        rows[name] = row
    return rows


BWD_CASES = [
    # name, (B, C, H, W), flow kind, flow scale (px; "collapse": the
    # factor), flow shift (px), dsrc wanted, src is flow
    ("vecint_step", (2, 2, 128, 128), "smooth", 5.0, 0.0, True, True),
    ("data_warp", (2, 1, 256, 256), "smooth", 5.0, 0.0, False, False),
    ("registered", (1, 1, 256, 256), "smooth", 5.0, 0.0, True, False),
    ("mostly_outside", (2, 1, 128, 128), "smooth", 40.0, 90.0, True, False),
    ("odd_shape", (3, 3, 67, 45), "smooth", 3.0, 0.0, True, False),
    # every pixel samples near the centre: thousands of terms a pixel
    ("collapse", (1, 1, 256, 256), "collapse", 0.95, 0.0, True, False),
    # more items than the card holds blocks: a block takes several items
    ("many_items", (2048, 2, 8, 8), "smooth", 2.0, 0.0, True, False),
]
MAIN_BWD_CASE = "registered"   # the backward of `registered = warp(fake_B,
                               # pos_flow)`, both gradients


def bwd_case_inputs(shape, kind, scale, shift, alias, gen, dev):
    """(src, flow, g) of a BWD_CASES case."""
    B, C, H, W = shape
    if kind == "collapse":
        flow = collapse_field((B, 2, H, W), scale, dev)
    else:
        flow = smooth_field((B, 2, H, W), scale, gen, dev) + shift
    src = flow if alias else torch.randn(shape, generator=gen, device=dev)
    return src, flow, torch.randn(shape, generator=gen, device=dev)


def warp2d_bwd_bound(B, C, H, W, need_dsrc, alias):
    """Least time for the backward's work: flow, src (once, if it is not
    the flow) and g read once, dflow and (if wanted) dsrc written once;
    ~12 flops a pixel for coordinates and weights, 14 a channel for dflow
    and 10 more for the dsrc scatter."""
    px, vals = B * H * W, B * C * H * W
    nbytes = 4 * (2 * px + (0 if alias else vals) + vals + 2 * px
                  + (vals if need_dsrc else 0))
    flops = px * 12 + vals * (14 + (10 if need_dsrc else 0))
    return bound(nbytes, flops)


def grid_sample_bwd_call(src, flow, g, need_dsrc):
    """The one PyTorch call computing the same function: the backward of
    grid_sample (aten::grid_sampler_2d_backward) on the flow's normalised
    grid, built beforehand.  Returns (call, its dflow in pixel units)."""
    H, W = flow.shape[2:]
    grid = normalised_grid(flow)

    def call():
        return torch.ops.aten.grid_sampler_2d_backward(
            g, src, grid, 0, 0, True, [need_dsrc, True])

    dgrid = call()[1]
    dflow = torch.stack([dgrid[..., 1] * (2 / (H - 1)),
                         dgrid[..., 0] * (2 / (W - 1))], dim=1)
    return call, dflow


def phase_kernel_bwd(seed, profile):
    """B2 against its plain version at BWD_CASES: dflow within 1e-5 of
    autograd; dsrc within 1e-5 * max(1, max|dsrc|) of it, bitwise the same
    over two calls and 0.0 from warp2d_dsrc_fixed_plain; timed beside its
    bound, its plain version and grid_sampler_2d_backward, with device us a
    launch at every case."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = {}
    for (name, (B, C, H, W), kind, scale, shift, need_dsrc,
         alias) in BWD_CASES:
        src, flow, g = bwd_case_inputs((B, C, H, W), kind, scale, shift,
                                       alias, gen, dev)
        dsrc, dflow = warp_cuda.warp2d_bwd_cuda(src, flow, g, need_dsrc)
        dsrc2, dflow2 = warp_cuda.warp2d_bwd_cuda(src, flow, g, need_dsrc)
        torch.cuda.synchronize()
        ref_dsrc, ref_dflow = warp_bwd_plain(src, flow, g, need_dsrc)
        torch.cuda.synchronize()
        err_dflow = float((dflow - ref_dflow).abs().max())
        dsrc_scale = (max(1.0, float(ref_dsrc.abs().max())) if need_dsrc
                      else 1.0)
        err_dsrc = (float((dsrc - ref_dsrc).abs().max()) if need_dsrc
                    else 0.0)
        if not need_dsrc and dsrc is not None:
            raise AssertionError(f"{name}: dsrc computed though not wanted")
        same = torch.equal(dflow, dflow2) and (
            not need_dsrc or torch.equal(dsrc, dsrc2))
        fixed_err = (float((dsrc - warp2d_dsrc_fixed_plain(flow, g))
                           .abs().max()) if need_dsrc else 0.0)
        library, lib_dflow = grid_sample_bwd_call(src, flow, g, need_dsrc)
        bound_ms, bound_by = warp2d_bwd_bound(B, C, H, W, need_dsrc, alias)
        kernel = lambda: warp_cuda.warp2d_bwd_cuda(  # noqa: E731
            src, flow, g, need_dsrc)
        row = {
            "case": name, "shape": [B, C, H, W], "flow_px": scale,
            "shift_px": shift, "need_dsrc": need_dsrc, "src_is_flow": alias,
            "max_abs_err_dflow": err_dflow, "max_abs_err_dsrc": err_dsrc,
            "dsrc_scale": dsrc_scale,
            "max_abs_err": max(err_dflow, err_dsrc),
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: warp_bwd_plain(
                src, flow, g, need_dsrc), reps=50),
            "library_ms": time_ms(library),
            "library_max_abs_err_dflow":
                float((lib_dflow - ref_dflow).abs().max()),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bit_reproducible": same, "fixed_max_abs_err": fixed_err,
            "device_us_per_launch": device_us(kernel, BWD),
        }
        if profile:
            row["library_device_us_per_call"] = device_us(library)
        emit({"phase": "kernel", "kernel": BWD, **row})
        if not (err_dflow <= KERNEL_TOL
                and err_dsrc <= KERNEL_TOL * dsrc_scale):
            raise AssertionError(
                f"warp2d backward kernel disagrees with its plain version on "
                f"{name}: dflow {err_dflow}, dsrc {err_dsrc} (scale "
                f"{dsrc_scale}) > {KERNEL_TOL}")
        if not same or fixed_err != 0.0:
            raise AssertionError(
                f"warp2d backward on {name}: two calls the same bits "
                f"{same}, dsrc {fixed_err} from warp2d_dsrc_fixed_plain")
        rows[name] = row
    return rows


# the earlier launch path, rebuilt here as it was, beside the lean one
def seed_launch(entry, src, *args):
    """The launch as ops/warp_cuda.py made it before the lean path: a
    device guard around a Python Stream object and the call."""
    lib = _build.load()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def seed_warp2d(src, flow, counts):
    warp_cuda._check(src, flow, "warp2d_cuda", 2)
    out = torch.empty_like(src)
    seed_launch("dfmir_warp2d_fwd", src, src.data_ptr(), flow.data_ptr(),
                out.data_ptr(), *src.shape)
    counts[FWD] += 1
    return out


def seed_warp2d_bwd(src, flow, g, counts):
    warp_cuda._check(src, flow, "warp2d_bwd_cuda", 2)
    warp_cuda._check_g(g, src)
    dflow = torch.empty_like(flow)
    dsrc = torch.zeros_like(src)
    scratch = torch.empty(warp_cuda._scratch2d(*src.shape),
                          dtype=torch.int64, device=src.device)
    seed_launch("dfmir_warp2d_bwd", src, src.data_ptr(), flow.data_ptr(),
                g.data_ptr(), dsrc.data_ptr(), dflow.data_ptr(),
                scratch.data_ptr(), *src.shape)
    counts[BWD] += 1
    return dsrc, dflow


class SeedWarp2d(torch.autograd.Function):
    """Warp2dFunction's forward over the seed's launcher."""

    @staticmethod
    def forward(ctx, src, flow):
        ctx.save_for_backward(src, flow)
        return seed_warp2d(src, flow, {FWD: 0})

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError


def seed_warp(src, flow):
    """warp(src, flow) as it dispatched before the lean path."""
    if not _kernel_takes(src, flow, "bilinear"):
        raise AssertionError("the card's warp should take these tensors")
    return SeedWarp2d.apply(src.contiguous(), flow.contiguous())


def host_us(fn, calls=2000, warmup=50):
    """Mean host-clock microseconds of one call of ``fn`` over ``calls``
    calls (the enqueue, not the device's work), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def phase_host_path(seed):
    """The host path of one B1 call at y_source's (1,1,256,256) and one B2
    call at the `registered` case, part by part on the host clock: before
    the lean path (rebuilt here) and on it.  The parts are timed one by
    one; "rest" is the whole call less its parts (call overhead, Function
    .apply for warp).  Then the 3-D launchers (host_path3d)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    src = torch.randn((1, 1, 256, 256), generator=gen, device=dev)
    flow = smooth_field((1, 2, 256, 256), 5.0, gen, dev)
    g = torch.randn((1, 1, 256, 256), generator=gen, device=dev)
    out, dsrc, dflow = (torch.empty_like(t) for t in (src, src, flow))
    scratch = torch.empty(warp_cuda._scratch2d(*src.shape),
                          dtype=torch.int64, device=dev)
    lib = _build.load()
    fwd_fn, bwd_fn = lib.dfmir_warp2d_fwd, lib.dfmir_warp2d_bwd
    d = src.get_device()
    counts = dict(ZERO)
    stream = torch._C._cuda_getCurrentRawStream(d)
    fwd_args = (src.data_ptr(), flow.data_ptr(), out.data_ptr(), *src.shape)
    bwd_args = (src.data_ptr(), flow.data_ptr(), g.data_ptr(),
                dsrc.data_ptr(), dflow.data_ptr(), scratch.data_ptr(),
                *src.shape)

    def guard():
        with torch.cuda.device(src.device):
            pass

    def count():
        counts[FWD] += 1

    common = {
        "dispatch": lambda: _kernel_takes(src, flow, "bilinear"),
        "contiguous": lambda: (src.contiguous(), flow.contiguous()),
        "alloc_out": lambda: torch.empty_like(src),
        "args": lambda: (src.data_ptr(), flow.data_ptr(), out.data_ptr(),
                         *src.shape),
        "count": count,
    }
    parts = {
        "before": dict(common, **{
            "check": lambda: warp_cuda._check(src, flow, "warp2d_cuda", 2),
            "load": _build.load,
            "guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream,
            "ctypes_launch": lambda: getattr(lib, "dfmir_warp2d_fwd")(
                *fwd_args, stream)}),
        "after": dict(common, **{
            "check": lambda: warp_cuda._device(src, flow, "warp2d_cuda", 2),
            "entry": lambda: getattr(_build.load(), "dfmir_warp2d_fwd"),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
            "device_test": lambda: d == torch._C._cuda_getDevice(),
            "ctypes_launch": lambda: fwd_fn(*fwd_args, stream)}),
    }
    launchers = {"before": lambda: seed_warp2d(src, flow, counts),
                 "after": lambda: warp_cuda.warp2d_cuda(src, flow)}
    warps = {"before": lambda: seed_warp(src, flow),
             "after": lambda: warp(src, flow)}
    bwd_parts = {
        "before": {
            "check": lambda: (warp_cuda._check(src, flow, "warp2d_bwd_cuda",
                                               2), warp_cuda._check_g(g, src)),
            "alloc_dflow": lambda: torch.empty_like(flow),
            "alloc_dsrc": lambda: torch.zeros_like(src),
            "load": _build.load, "guard": guard,
            "stream": lambda: torch.cuda.current_stream().cuda_stream,
            "ctypes_launch": lambda: getattr(lib, "dfmir_warp2d_bwd")(
                *bwd_args, stream)},
        "after": {
            "check": lambda: (warp_cuda._device(src, flow, "warp2d_bwd_cuda",
                                                2), warp_cuda._check_g(g,
                                                                       src)),
            "alloc_dflow": lambda: torch.empty_like(flow),
            "alloc_dsrc": lambda: torch.empty_like(src),
            "alloc_scratch": lambda: torch.empty(
                warp_cuda._scratch2d(*src.shape), dtype=torch.int64,
                device=dev),
            "entry": lambda: getattr(_build.load(), "dfmir_warp2d_bwd"),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
            "device_test": lambda: d == torch._C._cuda_getDevice(),
            "ctypes_launch": lambda: bwd_fn(*bwd_args, stream)},
    }
    bwd_launchers = {
        "before": lambda: seed_warp2d_bwd(src, flow, g, counts),
        "after": lambda: warp_cuda.warp2d_bwd_cuda(src, flow, g)}
    library = grid_sample_call(src, flow)
    library_bwd, _ = grid_sample_bwd_call(src, flow, g, True)
    lines = {}
    for path in ("before", "after"):
        us = {k: host_us(fn) for k, fn in parts[path].items()}
        launcher_parts = sum(v for k, v in us.items()
                             if k not in ("dispatch", "contiguous"))
        us["launcher_total"] = host_us(launchers[path])
        us["launcher_rest"] = us["launcher_total"] - launcher_parts
        us["warp_total"] = host_us(warps[path])
        us["warp_rest"] = (us["warp_total"] - us["launcher_total"]
                           - us["dispatch"] - us["contiguous"])
        bus = {k: host_us(fn) for k, fn in bwd_parts[path].items()}
        bus["launcher_total"] = host_us(bwd_launchers[path])
        bus["launcher_rest"] = bus["launcher_total"] - sum(
            v for k, v in bus.items() if k != "launcher_total")
        lines[path] = {
            "B1_us": us, "B2_us": bus,
            "B1_launcher_ms_events": time_ms(launchers[path]),
            "B2_launcher_ms_events": time_ms(bwd_launchers[path])}
        emit({"phase": "host_path", "path": path,
              "what": ("the seed's launch path, rebuilt in chip_smoke.py"
                       if path == "before" else "ops/warp_cuda.py"),
              "case": "B1 y_source (1,1,256,256); B2 registered "
                      "(1,1,256,256), both gradients", **lines[path],
              "library_us": host_us(library),
              "library_bwd_us": host_us(library_bwd),
              "library_ms_events": time_ms(library),
              "library_bwd_ms_events": time_ms(library_bwd)})
    lines["3d"] = host_path3d(seed)
    return lines


HOST3D_SHAPE = (1, 3, 80, 80, 80)     # VecInt's field in a 3-D step


def host_path3d(seed):
    """The host path of each 3-D launcher at VecInt's (1,3,80,80,80) (a
    self-warp, and the chain's 7 steps), part by part on the host clock,
    beside the library calls on the same inputs, with each call's CUDA-event
    time and device time: why B3 trailed F.grid_sample host-timed while it
    matched it on the device.  200 calls a part, fewer than the launch queue
    holds, so the host never waits on the card."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    shape = HOST3D_SHAPE
    B, _, D, H, W = shape
    v = chain_field(shape, "smooth", 3.0, gen, dev)     # src is the flow
    g = torch.randn(shape, generator=gen, device=dev)
    _, steps = warp_cuda.vecint3d_fwd_cuda(v, NSTEPS, save=True)
    out, dflow, dsrc = (torch.empty_like(v) for _ in range(3))
    scratch = v.new_empty((2, *shape))
    bins1, bins = warp_cuda._bins3d(v, 1), warp_cuda._bins3d(v, NSTEPS)
    nbricks = warp_cuda._bricks3d(shape)
    maxes = torch.empty(nbricks, dtype=torch.int32, device=dev)
    lib = _build.load()
    d = v.get_device()
    stream = torch._C._cuda_getCurrentRawStream(d)
    args = {
        "dfmir_warp3d_fwd": (v.data_ptr(), v.data_ptr(), out.data_ptr(),
                             *shape),
        "dfmir_warp3d_bwd_dflow": (v.data_ptr(), v.data_ptr(), g.data_ptr(),
                                   dflow.data_ptr(), *shape),
        "dfmir_warp3d_bwd_dsrc": (v.data_ptr(), g.data_ptr(),
                                  dsrc.data_ptr(), bins1.data_ptr(), *shape,
                                  0),
        "dfmir_vecint3d_fwd": (v.data_ptr(), steps.data_ptr(),
                               steps.stride(0), out.data_ptr(),
                               maxes.data_ptr(), B, D, H, W, NSTEPS, 1, 0),
        "dfmir_vecint3d_bwd": (steps.data_ptr(), steps.stride(0),
                               g.data_ptr(), scratch.data_ptr(),
                               bins.data_ptr(), dsrc.data_ptr(), B, D, H, W,
                               NSTEPS, 0),
    }

    def parts(entry, check, **allocs):
        fn = getattr(lib, entry)
        return {"check": check, **allocs,
                "entry": lambda: getattr(_build.load(), entry),
                "stream": lambda: torch._C._cuda_getCurrentRawStream(d),
                "device_test": lambda: d == torch._C._cuda_getDevice(),
                "ctypes_launch": lambda: fn(*args[entry], stream)}

    empty = lambda: torch.empty_like(v)  # noqa: E731
    alloc_bins = {"alloc_bins": lambda: warp_cuda._bins3d(v, 1)}
    launchers = {
        FWD3D: (parts("dfmir_warp3d_fwd",
                      lambda: warp_cuda._device(v, v, "warp3d_cuda", 3),
                      alloc_out=empty),
                lambda: warp_cuda.warp3d_cuda(v, v)),
        DFLOW3D: (parts("dfmir_warp3d_bwd_dflow",
                        lambda: (warp_cuda._device(
                            v, v, "warp3d_bwd_dflow_cuda", 3),
                                 warp_cuda._check_g(g, v)),
                        alloc_dflow=empty),
                  lambda: warp_cuda.warp3d_bwd_dflow_cuda(v, v, g)),
        DSRC3D: (parts("dfmir_warp3d_bwd_dsrc",
                       lambda: warp_cuda._device(
                           g, v, "warp3d_bwd_dsrc_cuda", 3),
                       alloc_dsrc=empty, **alloc_bins),
                 lambda: warp_cuda.warp3d_bwd_dsrc_cuda(v, g)),
        VF3: (parts("dfmir_vecint3d_fwd",
                    lambda: warp_cuda._device(v, v, "vecint3d_fwd_cuda", 3),
                    alloc_out=empty,
                    alloc_steps=lambda: warp_cuda.stack3d(v, NSTEPS),
                    alloc_maxes=lambda: torch.empty(
                        nbricks, dtype=torch.int32, device=dev)),
              lambda: warp_cuda.vecint3d_fwd_cuda(v, NSTEPS, save=True)),
        VB3: (parts("dfmir_vecint3d_bwd",
                    lambda: warp_cuda._device(g, g, "vecint3d_bwd_cuda", 3),
                    alloc_dvec=empty,
                    alloc_scratch=lambda: v.new_empty((2, *shape)),
                    alloc_bins=lambda: warp_cuda._bins3d(v, NSTEPS)),
              lambda: warp_cuda.vecint3d_bwd_cuda(steps, g)),
    }
    rows = {}
    for name, (split, launcher) in launchers.items():
        us = {k: host_us(fn, calls=200, warmup=20) for k, fn in split.items()}
        total = host_us(launcher, calls=200, warmup=20)
        rows[name] = {"us": us, "launcher_us": total,
                      "launcher_rest_us": total - sum(us.values()),
                      "ms_events": time_ms(launcher, reps=50),
                      "device_us": device_us(launcher, name)}
    library, _ = library3d_calls(v, v, g)
    lib_rows = {name: {"host_us": host_us(fn, calls=200, warmup=20),
                       "ms_events": time_ms(fn, reps=50),
                       "device_us": device_us(fn, "grid_sampler_3d")}
                for name, fn in library.items()}
    wrappers = {
        "warp": lambda: warp(v, v),
        "vecint_inference": lambda: vecint(v, NSTEPS),
        "launch_chain_fwd": lambda: launch_chain_fwd(v),
        "launch_chain_bwd": lambda: launch_chain_bwd(steps, g)}
    emit({"phase": "host_path", "path": "3d",
          "case": f"{shape} VecInt self-warp and chain",
          "launchers": rows, "library": lib_rows,
          "wrappers_us": {k: host_us(fn, calls=200, warmup=20)
                          for k, fn in wrappers.items()}})
    return {"launchers": rows, "library": lib_rows}


CHAIN_CASES = [
    # name, (B, 2, H, W), field kind, velocity scale (px), steps
    ("register", (1, 2, 128, 128), "smooth", 10.0, NSTEPS),  # register's
    ("train", (2, 2, 128, 128), "smooth", 10.0, NSTEPS),     # a step's pos/neg
    ("train_b8", (16, 2, 128, 128), "smooth", 10.0, NSTEPS),
    # the backward's state and sums in global memory (no block of 16 holds
    # its pixels' G in registers or their sums in shared memory)
    ("large", (1, 2, 192, 192), "smooth", 10.0, NSTEPS),
    # the forward's field in global memory (two buffers of a band exceed
    # a block's share of shared memory)
    ("large_fwd", (1, 2, 512, 512), "smooth", 10.0, NSTEPS),
    ("odd_shape", (3, 2, 67, 45), "smooth", 5.0, NSTEPS),
    ("violent", (1, 2, 128, 128), "noise", 25.0, NSTEPS),    # x25 N(0, 1)
]
MAIN_CHAIN_CASE = "train"
CHAIN3D_CASES = [
    # name, (B, 3, D, H, W), field kind, velocity scale (voxels; for
    # "edge", max|v_0| exactly), steps
    ("register", (1, 3, 80, 80, 80), "smooth", 10.0, NSTEPS),  # a 3-D register
    ("mild", (1, 3, 80, 80, 80), "smooth", 2.0, NSTEPS),       # call or step
    ("bidir", (2, 3, 80, 80, 80), "posneg", 10.0, NSTEPS),
    ("halo_at_1", (1, 3, 40, 40, 40), "edge", 1.0, 2),   # displacements at
    ("halo_at_2", (1, 3, 40, 40, 40), "edge", 2.0, 2),   # the halo staged
    ("halo_past_2", (1, 3, 40, 40, 40), "edge", 3.0, 2),  # and past it
    ("odd_shape", (2, 3, 17, 33, 45), "smooth", 5.0, NSTEPS),
    ("violent", (1, 3, 40, 40, 40), "noise", 25.0, NSTEPS),    # x25 N(0, 1)
    ("collapse", (1, 3, 80, 80, 80), "collapse", 4.0, NSTEPS),  # crowded
    ("steps_0", (1, 3, 24, 28, 32), "smooth", 5.0, 0),
    ("steps_1", (1, 3, 24, 28, 32), "smooth", 5.0, 1),
    ("steps_2", (1, 3, 24, 28, 32), "smooth", 5.0, 2),
]
MAIN_CHAIN3D_CASE = "register"   # the chain of a 3-D register call and step
# flops a pixel (2-D) or voxel (3-D) a step: the forward's coordinates, its
# corner sums for nd channels and the add; the backward's coordinates, its
# dflow and dsrc terms for nd channels and the add of G
CHAIN_FLOPS = {(2, True): 12 + 7 * 2 + 2, (2, False): 12 + 24 * 2 + 4,
               (3, True): 18 + 32 * 3 + 3, (3, False): 41 + (80 + 32) * 3 + 3}


def chain_bytes(B, nd, N, n):
    """The bytes a chain must move over B*N pixels or voxels of nd
    channels: its input (vec, or g and the n saved fields) read once, each
    field it writes (the saved steps and the result, or dvec) once."""
    return 4 * nd * B * N * (1 + n + 1)


def chain_bound(fwd, B, nd, N, n):
    """Least time for a chain's work: the larger of chain_bytes over HBM's
    rate and CHAIN_FLOPS over the float32 peak."""
    return bound(chain_bytes(B, nd, N, n), n * CHAIN_FLOPS[nd, fwd] * B * N)


def launch_chain_fwd(vec, n=NSTEPS):
    """The chain as n direct single-warp launches (B1 at 2-D, B3 at 3-D),
    each with its add: the path before the chain kernels, without
    autograd."""
    single = warp_cuda.warp2d_cuda if vec.ndim == 4 else warp_cuda.warp3d_cuda
    v = vec * (1.0 / 2 ** n)
    for _ in range(n):
        v = v + single(v, v)
    return v


def launch_chain_bwd(steps, g):
    """Its backward as direct launches (B2 at 2-D; B4 and B5 at 3-D), each
    step with the two adds that autograd made."""
    n = steps.shape[0]
    for k in range(n - 1, -1, -1):
        if g.ndim == 4:
            dsrc, dflow = warp_cuda.warp2d_bwd_cuda(steps[k], steps[k], g)
        else:
            dflow = warp_cuda.warp3d_bwd_dflow_cuda(steps[k], steps[k], g)
            dsrc = warp_cuda.warp3d_bwd_dsrc_cuda(steps[k], g)
        g = g + dsrc + dflow
    return g * (1.0 / 2 ** n)


def grid_sample_chain(vec, n=NSTEPS):
    """The chain written with F.grid_sample, its grid rebuilt each step."""
    grid = normalised_grid if vec.ndim == 4 else grid3d
    v = vec * (1.0 / 2 ** n)
    for _ in range(n):
        v = v + F.grid_sample(v, grid(v), mode="bilinear",
                              padding_mode="zeros", align_corners=True)
    return v


def collapse_field(shape, scale, device):
    """(B, nd, *spatial) flow scale * (centre - p): every pixel or voxel
    samples near the centre, so thousands of targets share a few cells."""
    B, nd, *spatial = shape
    grid = identity_grid(spatial, device=device)
    centre = torch.tensor([(n - 1) / 2 for n in spatial],
                          device=device).reshape(nd, *[1] * nd)
    return (scale * (centre - grid))[None].expand(
        B, *[-1] * (nd + 1)).contiguous()


def chain_field(shape, kind, scale, gen, dev, nsteps=NSTEPS):
    """A velocity field: smooth, a smooth half and its negation stacked on
    the batch (posneg, as the bidirectional model integrates them), N(0, 1)
    noise, about +-scale, a collapse (scale * (centre - p)), or a smooth
    field whose first step moves a voxel by exactly scale at most (edge:
    max|vec * 2^-nsteps| is scale)."""
    if kind == "collapse":
        return collapse_field(shape, scale, dev)
    if kind == "edge":
        v = chain_field(shape, "smooth", 1.0, gen, dev)
        return v / v.abs().max() * (scale * 2 ** nsteps)
    if kind == "noise":
        return torch.randn(shape, generator=gen, device=dev) * scale
    smooth = smooth_field if len(shape) == 4 else smooth_field3d
    if kind == "posneg":
        half = smooth((shape[0] // 2, *shape[1:]), scale, gen, dev)
        return torch.cat([half, -half])
    return smooth(shape, scale, gen, dev)


def steps_fit(call_of_n, name):
    """The kernel ``name``'s device us a launch at nsteps = 1..NSTEPS
    (``call_of_n(n)`` returns the call) and the least-squares line through
    them: its slope, the cost of one step, and its intercept, the fixed
    cost of a launch."""
    us = {n: device_us(call_of_n(n), name) for n in range(1, NSTEPS + 1)}
    pts = [(n, t) for n, t in us.items() if t is not None]
    if len(pts) < 2:
        return {"us_by_nsteps": us, "per_step_us": None, "fixed_us": None}
    mn = statistics.fmean(n for n, _ in pts)
    mt = statistics.fmean(t for _, t in pts)
    slope = (sum((n - mn) * (t - mt) for n, t in pts)
             / sum((n - mn) ** 2 for n, _ in pts))
    return {"us_by_nsteps": us, "per_step_us": slope,
            "fixed_us": mt - slope * mn}


def chain_steps_fit(kernel, vec, g):
    """``steps_fit`` of a chain kernel on vec (its cotangent g): the
    forward saving its steps and not, or the backward of the forward's
    saved steps."""
    if kernel in (VF, VF3):
        fwd = (warp_cuda.vecint2d_fwd_cuda if kernel == VF
               else warp_cuda.vecint3d_fwd_cuda)
        return {"save": steps_fit(lambda n: lambda: fwd(vec, n, save=True),
                                  kernel),
                "inference": steps_fit(
                    lambda n: lambda: fwd(vec, n, save=False), kernel)}
    fwd, bwd = ((warp_cuda.vecint2d_fwd_cuda, warp_cuda.vecint2d_bwd_cuda)
                if kernel == VB else
                (warp_cuda.vecint3d_fwd_cuda, warp_cuda.vecint3d_bwd_cuda))

    def call_of_n(n):
        steps = fwd(vec, n, save=True)[1]
        return lambda: bwd(steps, g)

    return {"save": steps_fit(call_of_n, kernel)}


def yard_sync_call(entry, *args):
    d = torch.cuda.current_device()
    fn = _yard[entry]

    def call():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(d))
        if err:
            raise RuntimeError(f"yardstick {entry}{args}: cudaError {err}")

    return call


def barrier_us(entry, *args, n=1000):
    """One barrier's device us from the csrc/yardsticks/sync.cu launch that
    does nothing but barriers: the launch with ``n`` of them less the one
    with none (CUDA events, median of 20), over ``n``."""
    with_n = time_ms(yard_sync_call(entry, *args, n), reps=20, warmup=3)
    none = time_ms(yard_sync_call(entry, *args, 0), reps=20, warmup=3)
    return (with_n - none) * 1e3 / n


STEP_CASES = [
    # kernel, case, (B, nd, *spatial), field kind, velocity scale
    (VF, "register", (1, 2, 128, 128), "smooth", 10.0),
    (VF, "train", (2, 2, 128, 128), "smooth", 10.0),
    (VF, "train_b8", (16, 2, 128, 128), "smooth", 10.0),
    (VF, "large_fwd", (1, 2, 512, 512), "smooth", 10.0),
    (VB, "train", (2, 2, 128, 128), "smooth", 10.0),
    (VB, "train_b8", (16, 2, 128, 128), "smooth", 10.0),
    (VF3, "register", (1, 3, 80, 80, 80), "smooth", 10.0),
    (VF3, "mild", (1, 3, 80, 80, 80), "smooth", 2.0),
]
# B2's cases timed by --steps, both gradients
STEP_BWD_CASES = ("registered", "vecint_step", "collapse")


def phase_chain_steps(seed):
    """Where the chains' time goes: each at nsteps = 1..7
    (``chain_steps_fit``) at STEP_CASES; B2 with both gradients at
    STEP_BWD_CASES, device us a launch and ms beside
    grid_sampler_2d_backward's; and one barrier alone: a grid.sync() over
    1, 2, 4 and 5 blocks of 256 threads a SM, and a cluster barrier over
    clusters of 8 and 16 blocks.  It calls the wrappers alone, so it runs
    against an earlier tree's library too."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    rows = {}
    for kernel, name, shape, kind, scale in STEP_CASES:
        vec = chain_field(shape, kind, scale, gen, dev)
        g = torch.randn(shape, generator=gen, device=dev)
        rows[kernel, name] = chain_steps_fit(kernel, vec, g)
        emit({"phase": "chain_steps", "kernel": kernel, "case": name,
              "shape": list(shape), "vec_px": scale, **rows[kernel, name]})
    for (name, shape, kind, scale, shift, need_dsrc,
         alias) in BWD_CASES:
        if name not in STEP_BWD_CASES:
            continue
        src, flow, g = bwd_case_inputs(shape, kind, scale, shift, alias,
                                       gen, dev)
        kernel = lambda: warp_cuda.warp2d_bwd_cuda(  # noqa: E731
            src, flow, g, need_dsrc)
        library, _ = grid_sample_bwd_call(src, flow, g, need_dsrc)
        rows[BWD, name] = {
            "device_us_per_launch": device_us(kernel, BWD),
            "ms": time_ms(kernel),
            "library_device_us_per_call": device_us(library),
            "library_ms": time_ms(library),
            "bound_ms": warp2d_bwd_bound(*shape, need_dsrc, alias)[0]}
        emit({"phase": "chain_steps", "kernel": BWD, "case": name,
              "shape": list(shape), **rows[BWD, name]})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = {f"{k}_per_sm": barrier_us("dfmir_yard_grid_sync", k * sms)
            for k in (1, 2, 4, 5)}
    cluster = {f"{c}x{s}": barrier_us("dfmir_yard_cluster_sync", c, s)
               for c, s in ((2, 8), (16, 8), (2, 16), (16, 16))}
    emit({"phase": "chain_steps", "grid_sync_us": grid,
          "cluster_sync_us": cluster, "sms": sms})
    return rows


def halo_report(steps, dims):
    """The 3-D forward chain's halos and the corners it reads from L2, from
    the fields v_0..v_{n-1} it stepped (``steps``) and its brick geometry
    ``dims`` (brick z, y, x, most halo, x pad; warp_cuda.brick3d): each
    brick's halo a step is min(ceil(max|v_k| over its voxels), the most),
    its box that halo around the brick in z and y and the x pad in x; a
    corner inside the volume but outside its voxel's box is read from L2.
    Returns each step's bricks at each halo and share of corners from
    L2."""
    *brick, most, pad = dims
    bricks_by_halo, shares = [], []
    inside = outside = 0
    for v in steps:
        spatial = v.shape[2:]
        nb = [-(-n // b) for n, b in zip(spatial, brick)]
        mag = v.abs().amax(dim=1, keepdim=True)
        mag = F.pad(mag, [0, nb[2] * brick[2] - spatial[2],
                          0, nb[1] * brick[1] - spatial[1],
                          0, nb[0] * brick[0] - spatial[0]])
        m = F.max_pool3d(mag, brick, brick)[:, 0]         # (B, *nb)
        h = torch.where(m.isfinite(), m.ceil().clamp(max=most),
                        torch.full_like(m, most))
        bricks_by_halo.append([int((h == k).sum()) for k in range(most + 1)])
        for a, b in enumerate(brick):
            h = h.repeat_interleave(b, dim=a + 1)
        h = h[:, :spatial[0], :spatial[1], :spatial[2]]   # (B, D, H, W)
        grid = identity_grid(spatial, device=v.device)
        z0 = [(grid[a] + v[:, a]).clamp(-2.0, n + 1.0).floor()
              for a, n in enumerate(spatial)]
        lo = [(grid[a] // b) * b - h for a, b in enumerate(brick[:2])]
        lo.append((grid[2] // brick[2]) * brick[2] - pad + 0 * h)
        size = [brick[0] + 2 * h + 1, brick[1] + 2 * h + 1,
                brick[2] + 2 * pad + 0 * h]
        n_in = n_out = 0
        for k in range(8):
            d = (k >> 2, (k >> 1) & 1, k & 1)
            vol = box = True
            for a in range(3):
                c = z0[a] + d[a]
                vol = vol & (c >= 0) & (c < spatial[a])
                box = box & (c >= lo[a]) & (c - lo[a] < size[a])
            n_in += int(vol.sum())
            n_out += int((vol & ~box).sum())
        shares.append(n_out / max(n_in, 1))
        inside += n_in
        outside += n_out
    return {"bricks_by_halo_by_step": bricks_by_halo,
            "l2_corner_share_by_step": shares,
            "l2_corner_share": outside / max(inside, 1)}


def launch_vecint2d_bwd(steps, g, cluster):
    """vecint2d_bwd_cuda with clusters of ``cluster`` blocks (the wrapper
    takes the kernel's own size); the launch is counted as the wrapper's."""
    dvec = torch.empty_like(g)
    sums = torch.empty(g.shape, dtype=torch.int64, device=g.device)
    warp_cuda._launch(VB, "dfmir_vecint2d_bwd", g.get_device(),
                      steps.data_ptr(), g.data_ptr(), sums.data_ptr(),
                      dvec.data_ptr(), g.shape[0], *g.shape[2:],
                      steps.shape[0], cluster)
    return dvec


def launch_vecint2d_fwd(vec, n, cluster):
    """vecint2d_fwd_cuda(vec, n, save=True)'s output with clusters of
    ``cluster`` blocks; the launch is counted as the wrapper's."""
    out = torch.empty_like(vec)
    steps = vec.new_empty((n, *vec.shape))
    warp_cuda._launch(VF, "dfmir_vecint2d_fwd", vec.get_device(),
                      vec.data_ptr(), steps.data_ptr(), out.data_ptr(),
                      vec.shape[0], *vec.shape[2:], n, 1, cluster)
    return out


def vecint2d_bwd_clusters(size=0):
    """(blocks a cluster, clusters the card holds at once) of vecint2d_bwd
    at ``size`` blocks a cluster, 0 for the kernel's own."""
    size, active = ctypes.c_int(size), ctypes.c_int(0)
    err = _build.load().dfmir_vecint2d_bwd_clusters(ctypes.byref(size),
                                                    ctypes.byref(active))
    if err:
        raise RuntimeError(f"cluster occupancy query: cudaError {err}")
    return size.value, active.value


def cluster_report(kernel, call_of_size, result):
    """The 2-D chain kernel ``kernel`` at clusters of 8 and 16 blocks
    (``call_of_size(size)`` returns the call): each bit-equal to the
    wrapper's ``result``, its ms and device us; for vecint2d_bwd the
    clusters the card holds at once."""
    rows = {}
    for size in (8, 16):
        call = call_of_size(size)
        rows[size] = {"equal": torch.equal(call(), result),
                      "ms": time_ms(call),
                      "device_us": device_us(call, kernel)}
        if kernel == VB:
            rows[size]["active_clusters"] = vecint2d_bwd_clusters(size)[1]
        if not rows[size]["equal"]:
            raise AssertionError(f"{kernel} with clusters of {size} blocks "
                                 f"disagrees with the wrapper's result")
    return rows


def run_chains(phase, cases, names, seed, profile):
    """Each case through the chain kernels ``names`` (forward, backward)
    against the plain loop (forward bit-equal, saving its steps and not;
    backward within 1e-5 * max(1, max|dvec|) and bitwise the same over two
    calls; the 2-D backward bit-equal to vecint2d_bwd_fixed_plain), timed
    beside their bound, the plain loop, the same chain as direct
    single-warp launches with their adds and the F.grid_sample chain.  At
    the main cases (and the 3-D "mild"): device us, each kernel's cost a
    step and fixed cost (nsteps 1..7), the 3-D forward's halo a step and
    share of corners read from L2, the 2-D backward at clusters of 8 and
    16 blocks."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kf, kb = names
    fwd_cuda, bwd_cuda = ((warp_cuda.vecint2d_fwd_cuda,
                           warp_cuda.vecint2d_bwd_cuda) if kf == VF else
                          (warp_cuda.vecint3d_fwd_cuda,
                           warp_cuda.vecint3d_bwd_cuda))
    rows = {kf: {}, kb: {}}
    for name, shape, kind, scale, n in cases:
        B, nd, *spatial = shape
        N = math.prod(spatial)
        vec = chain_field(shape, kind, scale, gen, dev, n)
        g = torch.randn(shape, generator=gen, device=dev)
        out, steps = fwd_cuda(vec, n, save=True)
        out_inf, _ = fwd_cuda(vec, n, save=False)
        dvec = bwd_cuda(steps, g)
        # both backwards sum their source gradients in a fixed point
        same = torch.equal(dvec, bwd_cuda(steps, g))
        fixed_err = (float((dvec - integrate.vecint2d_bwd_fixed_plain(
            steps, g)).abs().max()) if kb == VB else None)
        torch.cuda.synchronize()
        ref = vecint(vec, n, impl="torch")
        ref_dvec = vecint_bwd_plain(vec, n, g)
        err = max(float((out - ref).abs().max()),
                  float((out_inf - ref).abs().max()))
        err_bwd = float((dvec - ref_dvec).abs().max())
        tol_bwd = KERNEL_TOL * max(1.0, float(ref_dvec.abs().max()))
        moved = float((ref - vec / 2 ** n).abs().max())
        if n == NSTEPS and kind != "noise" and not moved > 1.0:
            raise AssertionError(f"{name}: the integrated field moved "
                                 f"{moved} px from vec * 2^-n: the chain "
                                 f"tests nothing across blocks")
        v = vec.clone().requires_grad_()
        gs_out = grid_sample_chain(v, n)
        gs_bwd = lambda: torch.autograd.grad(  # noqa: E731
            gs_out, v, g, retain_graph=True)
        calls = {
            kf: {"kernel": lambda: fwd_cuda(vec, n, save=True),
                 "plain": lambda: vecint(vec, n, impl="torch"),
                 "launches": lambda: launch_chain_fwd(vec, n),
                 "grid_sample": lambda: grid_sample_chain(vec, n)},
            kb: {"kernel": lambda: bwd_cuda(steps, g),
                 "plain": lambda: vecint_bwd_plain(vec, n, g),
                 "launches": lambda: launch_chain_bwd(steps, g),
                 "grid_sample": gs_bwd}}
        before_err = {
            kf: float((launch_chain_fwd(vec, n) - ref).abs().max()),
            kb: float((launch_chain_bwd(steps, g) - ref_dvec).abs().max())}
        gs_err = {kf: float((gs_out - ref).abs().max()),
                  kb: float((gs_bwd()[0] - ref_dvec).abs().max())}
        main = (name == MAIN_CHAIN_CASE if nd == 2
                else name in (MAIN_CHAIN3D_CASE, "mild"))
        for k in (kf, kb):
            c = calls[k]
            bound_ms, bound_by = chain_bound(k == kf, B, nd, N, n)
            row = {"case": name, "shape": list(shape), "field": kind,
                   "vec_px": scale, "nsteps": n,
                   "max_abs_err": err if k == kf else err_bwd,
                   "tol": 0.0 if k == kf else tol_bwd,
                   "ms": time_ms(c["kernel"]),
                   "plain_ms": time_ms(c["plain"], reps=20, warmup=2),
                   "launch_chain_ms": time_ms(c["launches"]),
                   "launch_chain_max_abs_err": before_err[k],
                   "grid_sample_chain_ms": time_ms(c["grid_sample"]),
                   "grid_sample_chain_max_abs_err": gs_err[k],
                   "library_ms": None,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes_bound_ms": chain_bytes(B, nd, N, n)
                   / HBM_BYTES_PER_S * 1e3}
            if k == kb:
                row["bit_reproducible"] = same
                if fixed_err is not None:
                    row["fixed_max_abs_err"] = fixed_err
            if k == kf:
                row["ms_inference"] = time_ms(
                    lambda: fwd_cuda(vec, n, save=False))
                row["inference_bound_ms"], row["inference_bound_by"] = bound(
                    chain_bytes(B, nd, N, 0),
                    n * CHAIN_FLOPS[nd, True] * B * N)
                row["field_max_px"] = float(ref.abs().max())
                row["moved_px"] = moved
                if nd == 3:
                    row.update(halo_report(steps, warp_cuda.brick3d()))
            if profile or main:
                row["device_us_per_launch"] = device_us(c["kernel"], k)
                if k == kf:
                    row["device_us_inference"] = device_us(
                        lambda: fwd_cuda(vec, n, save=False), k)
                row["launch_chain_device_us"] = device_us(c["launches"])
                row["grid_sample_chain_device_us"] = device_us(
                    c["grid_sample"])
            if main and n == NSTEPS:
                fit = chain_steps_fit(k, vec, g)
                row["per_step_us"] = fit["save"]["per_step_us"]
                row["fixed_us"] = fit["save"]["fixed_us"]
                row["steps_fit"] = fit
            if main and k == VB:
                row["blocks_per_cluster"] = vecint2d_bwd_clusters()[0]
                row["clusters"] = cluster_report(
                    VB, lambda size: lambda: launch_vecint2d_bwd(
                        steps, g, size), dvec)
            if main and k == VF:
                row["clusters"] = cluster_report(
                    VF, lambda size: lambda: launch_vecint2d_fwd(
                        vec, n, size), out)
            emit({"phase": phase, "kernel": k, **row})
            if not row["max_abs_err"] <= row["tol"]:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on {name}: {row['max_abs_err']} > "
                                     f"{row['tol']}")
            if row.get("bit_reproducible") is False:
                raise AssertionError(f"{k} gave two results on {name}")
            if row.get("fixed_max_abs_err", 0.0) != 0.0:
                raise AssertionError(f"{k} differs from its fixed-point "
                                     f"model on {name}: "
                                     f"{row['fixed_max_abs_err']}")
            rows[k][name] = row
        del steps, gs_out, v
    return rows


def phase_kernel_chain(seed, profile):
    """VecInt's 2-D chain kernels against the plain loop (run_chains)."""
    return run_chains("kernel", CHAIN_CASES, (VF, VB), seed + 12, profile)


def phase_kernel_chain3d(seed, profile):
    """VecInt's 3-D chain kernels against the plain loop (run_chains),
    device times at the main case always."""
    return run_chains("kernel_chain3d", CHAIN3D_CASES, (VF3, VB3), seed + 13,
                      profile)


# ------------------------------------------------------------ phase 4
def make_pairs(n, batch, size, seed, device):
    gen = torch.Generator().manual_seed(seed)
    pairs = []
    for _ in range(n):
        a = torch.tanh(smooth_field((batch, 1, size, size), 1.5, gen, "cpu")
                       + 0.1 * torch.randn((batch, 1, size, size),
                                           generator=gen))
        b = torch.tanh(smooth_field((batch, 1, size, size), 1.5, gen, "cpu"))
        regions = smooth_field((batch, 1, size, size), 1.0, gen, "cpu")
        label = torch.bucketize(regions, torch.tensor([-0.5, 0.0, 0.5]))
        label = label.float() * 60 / 255          # test.py's uint8 / 255
        pairs.append(tuple(t.to(device) for t in (a, b, label)))
    return pairs


def build_model(cfg, seed, device):
    model = RegistrationModel(cfg, device=device,
                              generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.netR.flow.weight.mul_(FLOW_GAIN)
    return model


def phase_register(seed, smi):
    cfg = RegistrationConfig()
    S = cfg.crop_size
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(N_PAIRS, 1, S, seed, DEVICE)

    # the main path, counted
    warp_cuda.reset_launches()
    outs = [infer.register_pair_outputs(model, a, b, label=lab)
            for a, b, lab in pairs]
    torch.cuda.synchronize()
    launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * N_PAIRS for k, v in REGISTER_LAUNCHES.items()}
    if launches != dict(ZERO, **want):
        raise AssertionError(f"{launches} kernel launches over {N_PAIRS} "
                             f"register calls, expected {want}")
    shapes = {"fake_B": (1, 1, S, S), "idt_B": (1, 1, S, S),
              "y_source": (1, 1, S, S), "pos_flow": (1, 2, S, S),
              "jac_det": (1, S, S), "folding_fraction": (1,),
              "label_warped": (1, 1, S, S)}
    for o in outs:
        for k, shape in shapes.items():
            if tuple(o[k].shape) != shape or not bool(o[k].isfinite().all()):
                raise AssertionError(f"{k}: shape {tuple(o[k].shape)} "
                                     f"(expected {shape}) or not finite")
    flow_max = max(float(o["pos_flow"].abs().max()) for o in outs)
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} px: the field does "
                             f"not deform, the warps test nothing")

    # the same weights on the CPU (plain warp), one pair
    cpu = build_model(cfg, seed, "cpu")
    a, b, lab = (t.cpu() for t in pairs[0])
    t0 = time.perf_counter()
    ref = infer.register_pair_outputs(cpu, a, b, label=lab)
    cpu_s = time.perf_counter() - t0
    errs = {k: float((outs[0][k].cpu() - ref[k]).abs().max())
            for k in ("fake_B", "idt_B", "y_source", "pos_flow", "jac_det")}
    label_mismatch = float((outs[0]["label_warped"].cpu()
                            != ref["label_warped"]).float().mean())
    for k in ("fake_B", "y_source", "pos_flow"):
        if not errs[k] <= PATH_TOL:
            raise AssertionError(f"{k}: card vs CPU {errs[k]} > {PATH_TOL}")

    a, b, lab = pairs[0]
    ms_b1 = time_ms(lambda: infer.register_pair_outputs(model, a, b, lab),
                    reps=30, warmup=3)
    (a8, b8, lab8), = make_pairs(1, 8, S, seed + 1, DEVICE)
    ms_b8 = time_ms(lambda: infer.register_pair_outputs(model, a8, b8, lab8),
                    reps=10, warmup=2)
    emit({"phase": "register", "config": "RegistrationConfig() defaults",
          "crop": S, "ngf": cfg.ngf, "netG": cfg.netG,
          "vxm": [list(cfg.vxm_enc), list(cfg.vxm_dec)],
          "pairs": N_PAIRS, "launches": launches,
          "launches_per_register": {k: v / N_PAIRS
                                    for k, v in launches.items() if v},
          "pos_flow_max_px": flow_max,
          "folding_fraction": [float(o["folding_fraction"][0]) for o in outs],
          "card_vs_cpu_max_abs": errs, "label_mismatch_fraction":
          label_mismatch, "cpu_pair_s": cpu_s,
          "ms_per_pair_b1": ms_b1, "pairs_per_s_b8": 8e3 / ms_b8,
          "ms_per_call_b8": ms_b8, "card": smi})
    return model, launches, ms_b1


# ------------------------------------------------------------ phase 5
SMALL = dict(crop_size=64, netG="resnet_4blocks", ngf=8,
             vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8),
             netF_nc=16, num_patches=16)
NETS = ("netG", "netF", "netR")


def patch_gen(seed):
    """A CPU generator for the patch ids: one seed, the same ids on the
    card and on the CPU."""
    return torch.Generator().manual_seed(seed)


def rel_errs(card, cpu, tol, what):
    """Relative difference of each metric; raises past ``tol``."""
    errs = {k: abs(card[k] - v) / max(abs(v), 1e-12) for k, v in cpu.items()}
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"{what}: card vs CPU metrics differ by {bad} "
                             f"(relative) > {tol}")
    return errs


def loss_and_grads(model, a, b, seed):
    """One loss_fn and backward; (metrics, {net: [grad, ...]}) on the CPU
    in float64."""
    model.optimizer.zero_grad(set_to_none=True)
    total, metrics, _ = model.loss_fn(a, b, generator=patch_gen(seed))
    total.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            {net: [p.grad.detach().cpu().double() for p in
                   getattr(model, net).parameters()] for net in NETS})


def small_step_vs_cpu(seed):
    """A reduced-width loss and backward (the CPU tests' config) on the card
    against the CPU: metrics 1e-3 relative; gradients within GRAD_ENV *
    max|g| of the CPU in float32 and GRAD_ENV_F64 * max|g| of the CPU in
    float64; a train step's launches (STEP_LAUNCHES) on the card."""
    cfg = RegistrationConfig(**SMALL)
    gen = torch.Generator().manual_seed(seed + 3)
    a, b = (torch.tanh(2 * torch.randn((2, 1, 64, 64), generator=gen))
            for _ in range(2))
    out = {}
    for run, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        model = build_model(cfg, seed, dev)
        for net in NETS:
            getattr(model, net).to(dtype)
        warp_cuda.reset_launches()
        out[run] = loss_and_grads(model, a.to(dev, dtype), b.to(dev, dtype),
                                  seed)
        if run == "card":
            torch.cuda.synchronize()
            launches = dict(warp_cuda.LAUNCHES)
            if launches != dict(ZERO, **STEP_LAUNCHES):
                raise AssertionError(f"small step: {launches} launches, "
                                     f"expected {STEP_LAUNCHES}")
    metric_errs = rel_errs(out["card"][0], out["cpu"][0], PATH_TOL,
                           "small step")
    grad_errs = {}
    for net in NETS:
        exact = out["cpu_f64"][1][net]
        scale = max(float(g.abs().max()) for g in exact)

        def rel(run):
            return max(float((x - y).abs().max())
                       for x, y in zip(out[run][1][net], exact)) / scale

        card_cpu = max(float((x - y).abs().max()) for x, y in
                       zip(out["card"][1][net], out["cpu"][1][net])) / scale
        grad_errs[net] = {"net_scale": scale, "card_vs_cpu": card_cpu,
                          "card_vs_f64": rel("card"),
                          "cpu_vs_f64": rel("cpu")}
        if not (card_cpu <= GRAD_ENV and rel("card") <= GRAD_ENV_F64):
            raise AssertionError(f"small step {net}: card gradients off by "
                                 f"{grad_errs[net]} (relative to max |g|): "
                                 f"bars {GRAD_ENV} (CPU), {GRAD_ENV_F64} "
                                 f"(float64)")
    return metric_errs, grad_errs


def time_steps(model, pairs, lr, seed):
    """train_step over ``pairs``; host ms of each (ending in a
    synchronize) and its metrics as floats."""
    gen = patch_gen(seed)
    ms, history = [], []
    for a, b, _ in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = model.train_step(a, b, lr, generator=gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
    return ms, history


def phase_train(seed, smi):
    cfg = RegistrationConfig()
    S = cfg.crop_size
    model = build_model(cfg, seed, DEVICE)
    pairs = make_pairs(1 + TRAIN_STEPS, 1, S, seed + 2, DEVICE)

    # full width: one loss_fn on the card and on the CPU, same weights and
    # patch ids, before any step
    a, b, _ = pairs[0]
    cpu = build_model(cfg, seed, "cpu")
    with torch.no_grad():
        _, m_card, aux = model.loss_fn(a, b, generator=patch_gen(seed))
        t0 = time.perf_counter()
        _, m_cpu, _ = cpu.loss_fn(a.cpu(), b.cpu(), generator=patch_gen(seed))
        cpu_s = time.perf_counter() - t0
    del cpu
    flow_max = float(aux["pos_flow"].abs().max())
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} px: the field does "
                             f"not deform, the warps test nothing")
    full_errs = rel_errs({k: float(v) for k, v in m_card.items()},
                         {k: float(v) for k, v in m_cpu.items()}, PATH_TOL,
                         "full-width loss_fn")

    # the main path, counted: 1 warm-up + TRAIN_STEPS timed steps
    before = {(net, name): p.detach().clone() for net in NETS
              for name, p in getattr(model, net).named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    step_ms, history = time_steps(model, pairs, cfg.lr, seed)
    launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * len(pairs) for k, v in STEP_LAUNCHES.items()}
    if launches != dict(ZERO, **want):
        raise AssertionError(f"{launches} kernel launches over "
                             f"{len(pairs)} train steps, expected {want}")
    peak_b1 = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not v == v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite metrics (step, name): {bad}")
    unmoved = [f"{net}.{name}" for net in NETS
               for name, p in getattr(model, net).named_parameters()
               if torch.equal(p.detach(), before[(net, name)])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} parameters did not move: "
                             f"{unmoved[:8]}")
    del before

    small_metric_errs, small_grad_errs = small_step_vs_cpu(seed)

    pairs8 = make_pairs(4, 8, S, seed + 4, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ms8, _ = time_steps(model, pairs8, cfg.lr, seed)
    peak_b8 = torch.cuda.max_memory_allocated()
    ms_b1 = statistics.median(step_ms[1:])
    ms_b8 = statistics.median(ms8[1:])
    emit({"phase": "train", "config": "RegistrationConfig() defaults",
          "crop": S, "ngf": cfg.ngf, "netG": cfg.netG, "netF": cfg.netF,
          "num_patches": cfg.num_patches, "nce_layers": list(cfg.nce_layers),
          "vxm": [list(cfg.vxm_enc), list(cfg.vxm_dec)],
          "steps": len(pairs), "launches": launches,
          "launches_per_step": {k: v / len(pairs)
                                for k, v in launches.items() if v},
          "pos_flow_max_px": flow_max,
          "full_width_card_vs_cpu_rel": full_errs, "cpu_loss_fn_s": cpu_s,
          "small_step_card_vs_cpu_rel": small_metric_errs,
          "small_step_grad_card_vs_cpu": small_grad_errs,
          "metrics_first": history[0], "metrics_last": history[-1],
          "step_ms_b1": step_ms, "ms_per_step_b1": ms_b1,
          "train_pairs_per_s_b1": 1e3 / ms_b1,
          "step_ms_b8": ms8, "ms_per_step_b8": ms_b8,
          "train_pairs_per_s_b8": 8e3 / ms_b8,
          "peak_mem_gb_b1": peak_b1 / 1e9, "peak_mem_gb_b8": peak_b8 / 1e9,
          "card": smi})
    return model, launches, ms_b1


# ------------------------------------------------------------ phase 6
KERNEL3D_CASES = [
    # name, (B, C, D, H, W), flow kind, flow scale (voxels), dsrc wanted,
    # src is flow
    ("vecint_step", (1, 3, 80, 80, 80), "smooth", 3.0, True, True),
    ("data_warp", (1, 1, 160, 160, 160), "smooth", 3.0, False, False),
    ("odd_shape", (2, 3, 17, 33, 45), "smooth", 2.0, True, False),
    ("violent", (1, 1, 40, 40, 40), "noise", 25.0, True, False),
    ("zero_flow", (1, 2, 32, 48, 64), "smooth", 0.0, True, False),
    ("collapse", (1, 3, 80, 80, 80), "collapse", 0.95, True, False),
]
# the single warps' cases of the kernels line: B3 and B4 run on the main
# path as the 160^3 data warp (VecInt's steps run in the chain kernels), B5
# no longer runs there; its case stays VecInt's self-warp
MAIN3D_CASE = {FWD3D: "data_warp", DFLOW3D: "data_warp",
               DSRC3D: "vecint_step"}
# the cases whose device time a launch is always measured
DEVICE3D_CASES = ("vecint_step", "data_warp")
# ~18 flops a voxel for coordinates and weights; per channel the forward's
# 8 corners x (3 mul + 1 add), dflow's 8 x (7 mul + 3 add), dsrc's 8 x
# (3 mul + 1 add into its source voxel's sum); 23 to combine dflow's terms
FLOPS3D = {FWD3D: (18, 32), DFLOW3D: (41, 80), DSRC3D: (18, 32)}


def smooth_field3d(shape, scale, gen, device):
    """(B, C, D, H, W) smooth random field of about +-scale."""
    B, C, *spatial = shape
    coarse = torch.randn((B, C, *(max(n // 16, 2) for n in spatial)),
                         generator=gen, device=device)
    return F.interpolate(coarse, size=tuple(spatial), mode="trilinear",
                         align_corners=True) * scale


def warp3d_bound(name, B, C, N, alias):
    """Least time for a 3-D kernel's work over B*N voxels: each input read
    once (src is the flow when ``alias``), each output written once."""
    flow, vals = 3 * B * N, B * C * N
    src = 0 if alias else vals
    nbytes = 4 * {FWD3D: flow + src + vals,
                  DFLOW3D: flow + src + vals + flow,
                  DSRC3D: flow + vals + vals}[name]
    per_voxel, per_channel = FLOPS3D[name]
    return bound(nbytes, B * N * per_voxel + vals * per_channel)


def grid3d(flow):
    """grid_sample's normalised (x, y, z) grid for the pixel flow."""
    D, H, W = flow.shape[2:]
    locs = identity_grid((D, H, W), device=flow.device)[None] + flow
    return torch.stack([2 * (locs[:, 2] / (W - 1) - 0.5),
                        2 * (locs[:, 1] / (H - 1) - 0.5),
                        2 * (locs[:, 0] / (D - 1) - 0.5)], dim=-1)


def library3d_calls(src, flow, g):
    """The PyTorch calls that compute the same functions (the yardsticks):
    grid_sample on 5-D input and grid_sampler_3d_backward with its output
    mask, on the normalised grid built beforehand; and the dflow of the
    latter in voxel units."""
    D, H, W = flow.shape[2:]
    grid = grid3d(flow)

    def bwd(mask):
        return lambda: torch.ops.aten.grid_sampler_3d_backward(
            g, src, grid, 0, 0, True, mask)

    dgrid = bwd([False, True])()[1]
    dflow = torch.stack([dgrid[..., 2] * (2 / (D - 1)),
                         dgrid[..., 1] * (2 / (H - 1)),
                         dgrid[..., 0] * (2 / (W - 1))], dim=1)
    return {FWD3D: lambda: F.grid_sample(src, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=True),
            DFLOW3D: bwd([False, True]), DSRC3D: bwd([True, False])}, dflow


def device_us(fn, name=None, calls=10, windows=3):
    """Device time from the profiler over ``calls`` calls of ``fn``: a
    launch of the kernel ``name``, or, with no name, every kernel of one
    call.  The profiler sometimes records none of a window's kernels; then
    the next window is tried, up to ``windows`` (None if none saw one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and (name is None or name in e.key)]
        count = sum(e.count for e in hits) if name else calls * bool(hits)
        if count:
            return sum(e.device_time_total for e in hits) / count
    return None


def dsrc3d_checks(flow, g, out, kernel, device):
    """B5's extra checks and yardsticks: a second call and the plain binned
    sum bit for bit, the yardsticks' results and times (device us of a whole
    call, memsets included, beside B5's, when ``device``)."""
    again = kernel()
    binned = warp3d_dsrc_binned_plain(flow, g)
    yards = {e: yard_dsrc3d(e, flow, g) for e in ("phased", "scatter64")}
    row = {"bit_reproducible": torch.equal(out, again),
           "binned_max_abs_err": float((out - binned).abs().max()),
           "yardsticks_equal": all(torch.equal(fn(), out)
                                   for fn in yards.values())}
    for e, fn in yards.items():
        row[f"{e}_ms"] = time_ms(fn, reps=50)
    if device:
        row["device_us_per_call"] = device_us(kernel)
        for e, fn in yards.items():
            row[f"{e}_device_us_per_call"] = device_us(fn)
        row["phased_us_by_phase"] = phase_us(yards["phased"])
    return row


def phase_us(call, reps=20):
    """Device us of each of B5's 4 phases (count, scan, place, gather; the
    first with its zeroing) as the phased yardstick launches them one by
    one: CUDA events around each launch, median of ``reps`` calls."""
    for p in range(4):
        call(p)
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
             for _ in range(reps)]
    for m in marks:
        for p in range(4):
            m[p].record()
            call(p)
        m[4].record()
    torch.cuda.synchronize()
    return [statistics.median(m[p].elapsed_time(m[p + 1]) for m in marks)
            * 1e3 for p in range(4)]


def phase_kernel3d(seed, profile):
    """Each 3-D kernel against its plain version on the card: forward max-abs
    <= 1e-5 (the zero flow exactly the source), dflow <= 1e-5, dsrc <= 1e-5
    * max(1, max|dsrc|), bitwise the same over two calls and as the plain
    binned sum; timed beside its bound, its plain version, the library call
    and, for dsrc, the two yardsticks (bit-equal to it too)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    rows = {FWD3D: {}, DFLOW3D: {}, DSRC3D: {}}
    for name, shape, kind, scale, need_dsrc, alias in KERNEL3D_CASES:
        B, C, D, H, W = shape
        N = D * H * W
        if kind == "smooth":
            flow = smooth_field3d((B, 3, D, H, W), scale, gen, dev)
        elif kind == "collapse":
            flow = collapse_field((B, 3, D, H, W), scale, dev)
        else:
            flow = torch.randn((B, 3, D, H, W), generator=gen,
                               device=dev) * scale
        src = flow if alias else torch.randn(shape, generator=gen, device=dev)
        g = torch.randn(shape, generator=gen, device=dev)
        kernels = {FWD3D: lambda: warp_cuda.warp3d_cuda(src, flow),
                   DFLOW3D: lambda: warp_cuda.warp3d_bwd_dflow_cuda(
                       src, flow, g),
                   DSRC3D: lambda: warp_cuda.warp3d_bwd_dsrc_cuda(flow, g)}
        plains = {FWD3D: lambda: warp(src, flow, impl="torch"),
                  DFLOW3D: lambda: warp_bwd_plain(src, flow, g,
                                                  need_dsrc=False)[1],
                  DSRC3D: lambda: warp_bwd_plain(src, flow, g,
                                                 need_dflow=False)[0]}
        library, lib_dflow = library3d_calls(src, flow, g)
        if not need_dsrc:          # the data warp: dflow alone, as in a step
            del kernels[DSRC3D]
        outs = {k: fn() for k, fn in kernels.items()}
        torch.cuda.synchronize()
        refs = {k: plains[k]() for k in kernels}
        torch.cuda.synchronize()
        if scale == 0.0 and not torch.equal(outs[FWD3D], src):
            raise AssertionError("warp3d kernel: a zero flow does not copy "
                                 "the source exactly")
        outside = float((outs[FWD3D] == 0).float().mean())
        for k in kernels:
            err = float((outs[k] - refs[k]).abs().max())
            tol = KERNEL_TOL * (max(1.0, float(refs[k].abs().max()))
                                if k == DSRC3D else 1.0)
            bound_ms, bound_by = warp3d_bound(k, B, C, N, alias)
            row = {"case": name, "shape": list(shape), "flow": kind,
                   "flow_px": scale, "src_is_flow": alias,
                   "max_abs_err": err, "tol": tol,
                   "zero_fraction": outside,
                   "ms": time_ms(kernels[k], reps=50),
                   "plain_ms": time_ms(plains[k], reps=10, warmup=2),
                   "library_ms": time_ms(library[k], reps=50),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            if k == FWD3D:
                row["library_max_abs_err"] = float(
                    (library[k]() - refs[k]).abs().max())
            elif k == DFLOW3D:
                row["library_max_abs_err"] = float(
                    (lib_dflow - refs[k]).abs().max())
            else:
                row.update(dsrc3d_checks(flow, g, outs[k], kernels[k],
                                         profile or name in DEVICE3D_CASES))
            if profile or name in DEVICE3D_CASES:
                row["device_us_per_launch"] = device_us(kernels[k], k)
                row["library_device_us_per_launch"] = device_us(
                    library[k], "grid_sampler_3d")
                if row["device_us_per_launch"]:    # None: no record seen
                    row["share_of_bound"] = (bound_ms * 1e3
                                             / row["device_us_per_launch"])
            emit({"phase": "kernel3d", "kernel": k, **row})
            if not err <= tol:
                raise AssertionError(f"{k} disagrees with its plain version "
                                     f"on {name}: {err} > {tol}")
            if k == DSRC3D and not (row["bit_reproducible"]
                                    and row["binned_max_abs_err"] == 0.0
                                    and row["yardsticks_equal"]):
                raise AssertionError(f"{k} on {name}: not bitwise the same "
                                     f"over two calls, as the binned plain "
                                     f"sum and as its yardsticks: {row}")
            rows[k][name] = row
        del src, flow, g, outs, refs, library, lib_dflow
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 7
# a 3-D register call: VecInt's chain + the data warp; a train step: each
# forward and backward (the data warp's source needs no gradient: no dsrc)
REG3D = {VF3: 1, FWD3D: 1}
STEP3D = {VF3: 1, FWD3D: 1, VB3: 1, DFLOW3D: 1}
REG3D_CALLS = 4
SMALL3D = dict(vol_size=64, enc=(8, 16, 16, 16),
               dec=(16, 16, 16, 16, 16, 8, 8))
CONVERGE_STEPS = 20


def make_volume_pairs(n, size, seed, device):
    """Seeded textured volume pairs (source, target), (1, 1, S, S, S): the
    target is smooth noise in three octaves through a tanh, the source the
    target warped (plain version) by a smooth field of a few voxels."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = []
    for _ in range(n):
        tex = sum(F.interpolate(
            torch.randn((1, 1) + (max(size // k, 2),) * 3, generator=gen,
                        device=device), size=(size,) * 3, mode="trilinear",
            align_corners=True) * (8 / k) for k in (8, 16, 32))
        target = torch.tanh(tex)
        field = smooth_field3d((1, 3) + (size,) * 3, 3.0, gen, device)
        pairs.append((warp(target, field, impl="torch"), target))
    return pairs


def build_engine(cfg, seed, device, gain=FLOW_GAIN):
    eng = VxmEngine(cfg, device=device, seed=seed)
    with torch.no_grad():
        eng.netR.flow.weight.mul_(gain)
    return eng


def small3d_grads_vs_cpu(seed):
    """A reduced-size 3-D loss and backward (64^3, enc (8,16,16,16)) on the
    card against the CPU: gradients within GRAD_ENV of each tensor's max
    |g| of the CPU in float32 and GRAD_ENV_F64 of the CPU in float64;
    the STEP3D kernel launches on the card."""
    cfg = VxmConfig(**SMALL3D)
    (src, tgt), = make_volume_pairs(1, cfg.vol_size, seed + 9, "cpu")
    grads = {}
    for run, dev, dtype in (("card", DEVICE, torch.float32),
                            ("cpu", "cpu", torch.float32),
                            ("cpu_f64", "cpu", torch.float64)):
        eng = build_engine(cfg, seed, dev)
        eng.netR.to(dtype)
        warp_cuda.reset_launches()
        total, _ = eng.loss_fn(src.to(dev, dtype), tgt.to(dev, dtype))
        total.backward()
        if run == "card":
            torch.cuda.synchronize()
            if warp_cuda.LAUNCHES != dict(ZERO, **STEP3D):
                raise AssertionError(f"small 3-D step: {warp_cuda.LAUNCHES} "
                                     f"launches, expected {STEP3D}")
        grads[run] = {k: p.grad.detach().cpu().double()
                      for k, p in eng.netR.named_parameters()}
    worst = {"card_vs_cpu": 0.0, "card_vs_f64": 0.0, "cpu_vs_f64": 0.0}
    for k, exact in grads["cpu_f64"].items():
        scale = float(exact.abs().max())
        rel = {"card_vs_cpu": float((grads["card"][k] - grads["cpu"][k])
                                    .abs().max()) / scale,
               "card_vs_f64": float((grads["card"][k] - exact).abs().max())
               / scale,
               "cpu_vs_f64": float((grads["cpu"][k] - exact).abs().max())
               / scale}
        worst = {r: max(worst[r], v) for r, v in rel.items()}
        if not (rel["card_vs_cpu"] <= GRAD_ENV
                and rel["card_vs_f64"] <= GRAD_ENV_F64):
            raise AssertionError(f"small 3-D step {k}: card gradients off by "
                                 f"{rel} (relative to max |g|): bars "
                                 f"{GRAD_ENV} (CPU), {GRAD_ENV_F64} "
                                 f"(float64)")
    return worst


def phase_vxm3d(seed, smi):
    """VxmConfig() at full width (160^3): register and train through the
    3-D kernels, against the CPU, timed."""
    cfg = VxmConfig()
    S = cfg.vol_size
    eng = build_engine(cfg, seed, DEVICE)
    pairs = make_volume_pairs(1 + TRAIN_STEPS, S, seed + 8, DEVICE)

    # the inference path, counted
    warp_cuda.reset_launches()
    outs = [eng.register(s, t) for s, t in pairs[:REG3D_CALLS]]
    torch.cuda.synchronize()
    reg_launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * REG3D_CALLS for k, v in REG3D.items()}
    if reg_launches != dict(ZERO, **want):
        raise AssertionError(f"{reg_launches} warp launches over "
                             f"{REG3D_CALLS} 3-D register calls, expected "
                             f"{want}")
    for y, flow in outs:
        if (tuple(y.shape) != (1, 1, S, S, S)
                or tuple(flow.shape) != (1, 3, S, S, S)
                or not bool(y.isfinite().all() & flow.isfinite().all())):
            raise AssertionError(f"register: shapes {tuple(y.shape)}, "
                                 f"{tuple(flow.shape)} or not finite")
    flow_max = max(float(f.abs().max()) for _, f in outs)
    if not flow_max > 0.5:
        raise AssertionError(f"pos_flow max {flow_max} voxels: the field "
                             f"does not deform, the warps test nothing")
    stats = {k: float(v) for k, v in eng.flow_stats(*pairs[0]).items()}
    metrics_card = {k: float(v) for k, v in eng.eval_step(*pairs[0]).items()}

    # the same weights on the CPU: one register, one eval_step
    cpu = build_engine(cfg, seed, "cpu")
    s_cpu, t_cpu = (x.cpu() for x in pairs[0])
    t1 = time.perf_counter()
    y_ref, flow_ref = cpu.register(s_cpu, t_cpu)
    cpu_register_s = time.perf_counter() - t1
    metrics_cpu = {k: float(v) for k, v in cpu.eval_step(s_cpu,
                                                         t_cpu).items()}
    del cpu
    errs = {"y_source": float((outs[0][0].cpu() - y_ref).abs().max()),
            "pos_flow": float((outs[0][1].cpu() - flow_ref).abs().max())}
    for k, e in errs.items():
        if not e <= PATH_TOL:
            raise AssertionError(f"3-D {k}: card vs CPU {e} > {PATH_TOL}")
    metric_errs = rel_errs(metrics_card, metrics_cpu, PATH_TOL,
                           "3-D eval_step")
    del outs, y_ref, flow_ref

    # the training path, counted: 1 warm-up + TRAIN_STEPS timed steps
    before = {k: p.detach().clone() for k, p in eng.netR.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    warp_cuda.reset_launches()
    step_ms, history = [], []
    for s, t in pairs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = eng.train_step(s, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        history.append({k: float(v) for k, v in m.items()})
    train_launches = dict(warp_cuda.LAUNCHES)
    want = {k: v * len(pairs) for k, v in STEP3D.items()}
    if train_launches != dict(ZERO, **want):
        raise AssertionError(f"{train_launches} warp launches over "
                             f"{len(pairs)} 3-D train steps, expected {want}")
    peak_train = torch.cuda.max_memory_allocated()
    bad = [(i, k) for i, m in enumerate(history) for k, v in m.items()
           if not v == v or abs(v) == float("inf")]
    if bad:
        raise AssertionError(f"non-finite 3-D metrics (step, name): {bad}")
    unmoved = [k for k, p in eng.netR.named_parameters()
               if torch.equal(p.detach(), before[k])]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} parameters did not move: "
                             f"{unmoved[:8]}")
    del before

    torch.cuda.reset_peak_memory_stats()
    s, t = pairs[0]
    reg_ms = time_ms(lambda: eng.register(s, t), reps=10, warmup=2)
    peak_register = torch.cuda.max_memory_allocated()

    # convergence: 20 steps at lr 1e-3 on one pair, from the flow head's
    # own N(0, 1e-5) init (a field near zero)
    fresh = build_engine(cfg, seed + 1, DEVICE, gain=1.0)
    totals = [float(fresh.train_step(s, t, lr=1e-3)["total"])
              for _ in range(CONVERGE_STEPS)]
    del fresh
    if not totals[-1] < totals[0]:
        raise AssertionError(f"3-D loss did not fall over {CONVERGE_STEPS} "
                             f"steps: {totals}")

    small_grad_errs = small3d_grads_vs_cpu(seed)
    ms_step = statistics.median(step_ms[1:])
    emit({"phase": "vxm3d", "config": "VxmConfig() defaults",
          "vol_size": S, "enc": list(cfg.enc), "dec": list(cfg.dec),
          "int_steps": cfg.int_steps, "int_downsize": cfg.int_downsize,
          "image_loss": cfg.image_loss, "ncc_win": cfg.ncc_win,
          "register_calls": REG3D_CALLS, "launches_register": reg_launches,
          "launches_train": train_launches, "steps": len(pairs),
          "pos_flow_max_vox": flow_max, "flow_stats": stats,
          "card_vs_cpu_max_abs": errs, "eval_card_vs_cpu_rel": metric_errs,
          "cpu_register_s": cpu_register_s,
          "metrics_first": history[0], "metrics_last": history[-1],
          "converge_lr": 1e-3, "converge_totals": totals,
          "small_step_grad_rel": small_grad_errs,
          "ms_per_register_b1": reg_ms,
          "step_ms_b1": step_ms, "ms_per_step_b1": ms_step,
          "peak_mem_gb_train": peak_train / 1e9,
          "peak_mem_gb_register": peak_register / 1e9, "card": smi})
    return eng, pairs[0], reg_launches, train_launches, ms_step


# ------------------------------------------------------------ phase 8
CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")


def busy_us(prof):
    """Time the card ran at least one kernel: the union of the kernels'
    intervals (kernels that overlap count once), in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, lo, hi = 0.0, None, None
    for s0, s1 in spans:
        if hi is None or s0 > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s0, s1
        else:
            hi = max(hi, s1)
    return busy + (0.0 if hi is None else hi - lo)


def trace(call, calls):
    """Device time by kernel and by conv op over ``calls`` calls (after 2
    warm-up calls), with the span from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(end) / calls
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / calls
    busy_ms = busy_us(prof) / 1e3 / calls
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in CONV_OPS]
    top_convs = sorted(convs, key=lambda e: -e.device_time_total)[:6]
    warps = {}
    for name in warp_cuda.LAUNCHES:
        hits = [e for e in kernels if name in e.key]
        if not hits:
            continue
        warps[name] = {
            "device_us_per_launch": [e.device_time_total / e.count
                                     for e in hits],
            "launches_per_call": [e.count / calls for e in hits],
            "ms_per_call": sum(e.device_time_total for e in hits) / 1e3
            / calls}
    return {"calls": calls, "device_ms_per_call": device_ms,
            "busy_ms_per_call": busy_ms, "span_ms_per_call": span_ms,
            "device_idle_share": 1 - busy_ms / span_ms,
            "warp_kernels": warps,
            "warp_share_of_device": sum(w["ms_per_call"]
                                        for w in warps.values()) / device_ms,
            "top_kernels": [{"name": e.key[:90],
                             "ms_per_call": e.device_time_total / 1e3 / calls,
                             "launches_per_call": e.count / calls}
                            for e in top],
            "top_convs": [{"op": e.key,
                           "input_shapes": str(e.input_shapes)[:160],
                           "ms_per_call": e.device_time_total / 1e3 / calls}
                          for e in top_convs]}


def phase_profile(model, seed, ms_b1):
    """Register calls at B=1: device time by kernel and by conv shape, the
    split between netG and netR by CUDA events, and the same calls with
    cuDNN's autotuner on (torch.backends.cudnn.benchmark), restored after."""
    (a, b, lab), = make_pairs(1, 1, model.cfg.crop_size, seed, DEVICE)
    call = lambda: infer.register_pair_outputs(model, a, b, lab)  # noqa: E731
    traced = trace(call, 3)
    with torch.no_grad():
        ab = torch.cat([a, b], dim=0)
        netG_ms = time_ms(lambda: model.netG(ab), reps=10, warmup=2)
        netR_ms = time_ms(lambda: model.netR(a, b, registration=True),
                          reps=10, warmup=2)
    torch.backends.cudnn.benchmark = True
    try:
        tuned_ms = time_ms(call, reps=20, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = False
    emit({"phase": "profile", "path": "register", **traced,
          "ms_per_pair_b1": ms_b1, "netG_ms": netG_ms, "netR_ms": netR_ms,
          "ms_per_pair_b1_cudnn_benchmark": tuned_ms})


def phase_profile_train(model, seed, ms_b1):
    """Train steps at B=1: device time by kernel and by conv op, and the
    idle share."""
    (a, b, _), = make_pairs(1, 1, model.cfg.crop_size, seed + 5, DEVICE)
    gen = patch_gen(seed)
    traced = trace(lambda: model.train_step(a, b, model.cfg.lr,
                                            generator=gen), 2)
    emit({"phase": "profile", "path": "train", **traced,
          "ms_per_step_b1": ms_b1})


def phase_profile_vxm3d(eng, pair, ms_step):
    """3-D train steps at B=1: device time by kernel and by conv op, and the
    idle share."""
    traced = trace(lambda: eng.train_step(*pair), 2)
    emit({"phase": "profile", "path": "train3d", **traced,
          "ms_per_step_b1": ms_step})


def kernel_row(name, replaces, source, launches, main_path, rows, main):
    """One kernel's entry of the kernels line: its numbers at its main
    path's case, its launches by path (``launches`` is the main path's)."""
    r = rows[main]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[main_path],
            "launches_by_path": launches,
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"],
            **({"bit_reproducible": all(x["bit_reproducible"]
                                        for x in rows.values())}
               if "bit_reproducible" in r else {}),
            **({"binned_max_abs_err": max(x["binned_max_abs_err"]
                                          for x in rows.values())}
               if "binned_max_abs_err" in r else {}),
            **({"fixed_max_abs_err": max(x["fixed_max_abs_err"]
                                         for x in rows.values())}
               if "fixed_max_abs_err" in r else {}),
            **{key: r[key] for key in ("per_step_us", "fixed_us",
                                       "device_us_per_launch", "ms_inference",
                                       "inference_bound_ms")
               if key in r}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace register calls and train steps with "
                         "torch.profiler")
    ap.add_argument("--steps", action="store_true",
                    help="only build and phase chain_steps (the chains at "
                         "nsteps 1..7, one barrier alone); no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    wall = {}

    def run(name, fn, *fn_args):
        t0 = time.perf_counter()
        out = fn(*fn_args)
        wall[name] = time.perf_counter() - t0
        emit({"phase": name, "wall_s": wall[name]})
        return out

    smi = run("device", phase_device)
    run("build", phase_build)
    if args.steps:
        run("chain_steps", phase_chain_steps, args.seed)
        return 0
    fwd_rows = run("kernel", phase_kernel, args.seed, args.profile)
    bwd_rows = run("kernel_bwd", phase_kernel_bwd, args.seed, args.profile)
    run("host_path", phase_host_path, args.seed)
    chain_rows = run("kernel_chain", phase_kernel_chain, args.seed,
                     args.profile)
    model, reg_launches, reg_ms = run("register", phase_register, args.seed,
                                      smi)
    if args.profile:
        run("profile_register", phase_profile, model, args.seed, reg_ms)
    del model
    model, train_launches, train_ms = run("train", phase_train, args.seed,
                                          smi)
    if args.profile:
        run("profile_train", phase_profile_train, model, args.seed, train_ms)
    del model
    rows3d = run("kernel3d", phase_kernel3d, args.seed, args.profile)
    chain3d_rows = run("kernel_chain3d", phase_kernel_chain3d, args.seed,
                       args.profile)
    eng, pair, reg3d_launches, train3d_launches, step3d_ms = run(
        "vxm3d", phase_vxm3d, args.seed, smi)
    if args.profile:
        run("profile_train3d", phase_profile_vxm3d, eng, pair, step3d_ms)
    del eng, pair

    paths = {"register": reg_launches, "train": train_launches,
             "register3d": reg3d_launches, "train3d": train3d_launches}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    src2d, src3d = ("dfmir_tpu_torch/csrc/warp2d.cu",
                    "dfmir_tpu_torch/csrc/warp3d.cu")
    tpu = "dfmir_tpu/ops/warp_pallas.py"
    emit({"kernels": [
        kernel_row(FWD, f"{tpu}:143", src2d, by_path(FWD), "train",
                   fwd_rows, MAIN_CASE),
        kernel_row(BWD, f"{tpu}:972", src2d, by_path(BWD), "train",
                   bwd_rows, MAIN_BWD_CASE),
        kernel_row(VF, f"{tpu}:143", src2d, by_path(VF), "train",
                   chain_rows[VF], MAIN_CHAIN_CASE),
        kernel_row(VB, f"{tpu}:972", src2d, by_path(VB), "train",
                   chain_rows[VB], MAIN_CHAIN_CASE),
        kernel_row(FWD3D, f"{tpu}:356", src3d, by_path(FWD3D), "train3d",
                   rows3d[FWD3D], MAIN3D_CASE[FWD3D]),
        kernel_row(DFLOW3D, f"{tpu}:576", src3d, by_path(DFLOW3D),
                   "train3d", rows3d[DFLOW3D], MAIN3D_CASE[DFLOW3D]),
        kernel_row(DSRC3D, f"{tpu}:643", src3d, by_path(DSRC3D), "train3d",
                   rows3d[DSRC3D], MAIN3D_CASE[DSRC3D]),
        kernel_row(VF3, f"{tpu}:356", src3d, by_path(VF3), "train3d",
                   chain3d_rows[VF3], MAIN_CHAIN3D_CASE),
        kernel_row(VB3, f"{tpu}:576", src3d, by_path(VB3), "train3d",
                   chain3d_rows[VB3], MAIN_CHAIN3D_CASE),
    ], "wall_s": wall})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
