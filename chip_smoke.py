#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dfmir_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each printing one JSON line:
  1. device   the card (nvidia-smi name and power limit); TF32 off for
              convs and matmuls, so every comparison is float32 to float32
  2. build    nvcc builds every kernel from dfmir_tpu_torch/csrc/
  3. kernel   each kernel against its plain PyTorch version on the card at
              the main path's shapes and a few hard ones (max-abs <= 1e-5),
              timed with CUDA events beside its byte/op bound and the one
              PyTorch call that computes the same function
  4. register the paper's model at full width (RegistrationConfig
              defaults: crop 256, ngf 64, resnet_9blocks, VxmDense
              (16,32,32,64,64,64)/(64,64,64,32,32,32,16), 7 integration
              steps), random weights from --seed with the flow head scaled so
              the field deforms: 4 pairs at B=1 through
              infer.register_pair_outputs as test.py serves them, kernel
              launches counted over that run, one pair against the same
              weights on the CPU (max-abs <= 1e-3), then ms/pair at B=1 and
              pairs/s at B=8
  5. profile  (--profile only) device time by kernel and by conv shape
              over register calls, netG / netR times, and the same calls
              with cuDNN's autotuner on
Then the kernels line, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card.  Every failure
propagates.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from dfmir_tpu_torch import infer
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.ops import _build, warp_cuda
from dfmir_tpu_torch.ops.warp import identity_grid, warp

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_TOL = 1e-5
PATH_TOL = 1e-3
FLOW_GAIN = 1e5          # flow head N(0, 1e-5) -> N(0, 1)
N_PAIRS = 4
WARPS_PER_REGISTER = 8   # 7 VecInt steps + the y_source warp
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
def phase_build():
    lib = _build.library_path()
    existed = lib.exists()
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": not existed, "library": lib.name,
          "sources": [str(p.relative_to(_build.PKG_DIR.parent))
                      for p in _build.sources()]})


# ------------------------------------------------------------ phase 3
WARP_CASES = [
    # name, (B, C, H, W), flow scale (px), flow shift (px)
    ("vecint_step", (1, 2, 128, 128), 5.0, 0.0),
    ("y_source_b1", (1, 1, 256, 256), 5.0, 0.0),
    ("y_source_b8", (8, 1, 256, 256), 20.0, 0.0),
    ("mostly_outside", (2, 1, 128, 128), 40.0, 90.0),
    ("odd_shape", (3, 3, 67, 45), 3.0, 0.0),
]
MAIN_CASE = "vecint_step"   # 7 of the 8 launches per register call


def warp2d_bound(B, C, H, W):
    """Least time for the warp's work: flow read once, src read once, out
    written once; ~12 flops a pixel for coordinates and weights, 7 a
    channel for the corner sum."""
    nbytes = 4 * (B * 2 * H * W + 2 * B * C * H * W)
    flops = B * H * W * (12 + 7 * C)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_sample_call(src, flow):
    """The one PyTorch call computing the same function (the yardstick):
    grid_sample on the flow's normalised coordinates, built beforehand."""
    H, W = flow.shape[2:]
    locs = identity_grid((H, W), device=flow.device)[None] + flow
    grid = torch.stack([2 * (locs[:, 1] / (W - 1) - 0.5),
                        2 * (locs[:, 0] / (H - 1) - 0.5)], dim=-1)
    return lambda: F.grid_sample(src, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)


def phase_kernel(seed):
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
        row = {
            "case": name, "shape": [B, C, H, W], "flow_px": scale,
            "shift_px": shift, "max_abs_err": err,
            "zero_fraction": outside,
            "ms": time_ms(lambda: warp_cuda.warp2d_cuda(src, flow)),
            "plain_ms": time_ms(lambda: warp(src, flow, impl="torch"),
                                reps=50),
            "library_ms": time_ms(library),
            "library_max_abs_err": lib_err,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        emit({"phase": "kernel", "kernel": "warp2d_bilinear_fwd", **row})
        if not err <= KERNEL_TOL:
            raise AssertionError(f"warp2d kernel disagrees with its plain "
                                 f"version on {name}: {err} > {KERNEL_TOL}")
        rows[name] = row
    return rows


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
    warp_cuda.LAUNCHES = 0
    outs = [infer.register_pair_outputs(model, a, b, label=lab)
            for a, b, lab in pairs]
    torch.cuda.synchronize()
    launches = warp_cuda.LAUNCHES
    if launches != WARPS_PER_REGISTER * N_PAIRS:
        raise AssertionError(f"{launches} warp kernel launches over "
                             f"{N_PAIRS} register calls, expected "
                             f"{WARPS_PER_REGISTER * N_PAIRS}")
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
          "launches_per_register": launches / N_PAIRS,
          "pos_flow_max_px": flow_max,
          "folding_fraction": [float(o["folding_fraction"][0]) for o in outs],
          "card_vs_cpu_max_abs": errs, "label_mismatch_fraction":
          label_mismatch, "cpu_pair_s": cpu_s,
          "ms_per_pair_b1": ms_b1, "pairs_per_s_b8": 8e3 / ms_b8,
          "ms_per_call_b8": ms_b8, "card": smi})
    return model, launches, ms_b1


# ------------------------------------------------------------ phase 5
def phase_profile(model, seed, ms_b1):
    """Device time by kernel and by conv shape over register calls at B=1,
    the split between netG and netR by CUDA events, and the same calls with
    cuDNN's autotuner on (torch.backends.cudnn.benchmark), restored after."""
    from torch.profiler import ProfilerActivity, profile

    (a, b, lab), = make_pairs(1, 1, model.cfg.crop_size, seed, DEVICE)
    call = lambda: infer.register_pair_outputs(model, a, b, lab)  # noqa: E731
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    calls = 3
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
    warp_k = [e for e in kernels if "warp2d_bilinear_fwd" in e.key]
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in ("aten::cudnn_convolution",
                          "aten::cudnn_convolution_transpose")]
    top_convs = sorted(convs, key=lambda e: -e.device_time_total)[:4]

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
    emit({"phase": "profile", "calls": calls,
          "device_ms_per_call": device_ms,
          "span_ms_per_call": span_ms,
          "device_idle_share": 1 - device_ms / span_ms,
          "warp2d_device_us_per_launch":
              [e.device_time_total / e.count for e in warp_k],
          "warp2d_launches_per_call": [e.count / calls for e in warp_k],
          "ms_per_pair_b1": ms_b1,
          "netG_ms": netG_ms, "netR_ms": netR_ms,
          "ms_per_pair_b1_cudnn_benchmark": tuned_ms,
          "top_kernels": [{"name": e.key[:90],
                           "ms_per_call": e.device_time_total / 1e3 / calls,
                           "launches_per_call": e.count / calls}
                          for e in top],
          "top_convs": [{"op": e.key, "input_shapes": str(e.input_shapes)[:160],
                         "ms_per_call": e.device_time_total / 1e3 / calls}
                        for e in top_convs]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace register calls with torch.profiler")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2

    smi = phase_device()
    phase_build()
    rows = phase_kernel(args.seed)
    model, launches, ms_b1 = phase_register(args.seed, smi)
    if args.profile:
        phase_profile(model, args.seed, ms_b1)

    main_row = rows[MAIN_CASE]
    emit({"kernels": [{
        "name": "warp2d_bilinear_fwd", "route": "cuda",
        "source": "dfmir_tpu_torch/csrc/warp2d.cu",
        "replaces": "dfmir_tpu/ops/warp_pallas.py:143",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
