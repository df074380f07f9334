"""Offline registration evaluation of a trained checkpoint (the JAX
package's ``scripts/evaluate.py``): deformation-field statistics (%|J|<0,
min |J|), image similarity (global NCC, PSNR, windowed NCC) and, where
label maps exist, segmentation overlap (per-label Dice, HD95).

    python -m dfmir_tpu_torch.evaluate --dataroot DATA --name EXP \\
        [--checkpoints_dir ./checkpoints] [--crop_size 256] [--num_test N] \\
        [--gpu_ids -1] [--out results/eval.json]
    python -m dfmir_tpu_torch.evaluate --ndims 3 --dataroot DATA --name EXP \\
        [--vol_size 160] [--enc 16,32,32,32] [--dec 32,32,32,32,32,16,16]

2-D: reads {dataroot}/testA and testB (PNGs); Dice and HD95 before and
after the predicted warp where testA_label and testB_label hold the
pairs' labels, else against {dataroot}/trainA_label.  The checkpoint is
``{epoch}_net_{G,R}.pth``.  ``--ndims 3``: a ``--model vxm`` checkpoint
(``{epoch}_net_R.pth``, net-shape flags as in training) on paired
``.npy`` / ``.npz`` test volumes; NCC and PSNR before and after the warp,
and Dice and HD95 before and after where testA_label and testB_label hold
label volumes.  Either reads the JAX package's ``.msgpack`` where no
``.pth`` exists and ``msgpack`` is installed.  Prints one JSON summary
line and writes the per-pair records to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dfmir_tpu_torch.compat.convert import (load_strict, net_state_from_jax,
                                            netR_state_from_jax)
from dfmir_tpu_torch.data.image_folder import decode_image
from dfmir_tpu_torch.device import float32_math
from dfmir_tpu_torch.data.transforms import resize, to_array
from dfmir_tpu_torch.data.volume import (crop_or_pad, load_volume,
                                         normalize_minmax)
from dfmir_tpu_torch.engine import checkpoints as ckpt
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.losses import ncc_loss
from dfmir_tpu_torch.metrics import (hausdorff_distance, label_dice,
                                     ncc_metric, psnr)
from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det
from dfmir_tpu_torch.ops.warp import warp
from dfmir_tpu_torch.options.base_options import device_from_gpu_ids
from dfmir_tpu_torch.utils.png import read_png


def main(argv=None):
    float32_math()
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--checkpoints_dir", default="./checkpoints")
    ap.add_argument("--epoch", default="latest")
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--num_patches", type=int, default=256)
    ap.add_argument("--num_test", type=int, default=50)
    ap.add_argument("--gpu_ids", default="0")
    ap.add_argument("--out", default=None)
    # volume mode (--ndims 3): a --model vxm checkpoint; the net-shape
    # flags must match the training run (VxmTask's defaults)
    ap.add_argument("--ndims", type=int, default=2, choices=[2, 3])
    ap.add_argument("--vol_size", type=int, default=160)
    ap.add_argument("--int_steps", type=int, default=7)
    ap.add_argument("--int_downsize", type=int, default=2)
    ap.add_argument("--bidir", action="store_true")
    ap.add_argument("--enc", default="16,32,32,32")
    ap.add_argument("--dec", default="32,32,32,32,32,16,16")
    args = ap.parse_args(argv)

    device = torch.device(device_from_gpu_ids(
        [int(i) for i in str(args.gpu_ids).split(",") if int(i) >= 0]))
    if args.ndims == 3:
        return eval_volumes(args, device)

    cfg = RegistrationConfig(crop_size=args.crop_size,
                             num_patches=args.num_patches)
    model = RegistrationModel(cfg, device=device,
                              generator=torch.Generator().manual_seed(0))
    save_dir = os.path.join(args.checkpoints_dir, args.name)
    loaded = ckpt.load_networks(
        save_dir, args.epoch, ["G", "R"],
        msgpack_converter=lambda name, tree: net_state_from_jax(
            model, name, tree))
    load_strict(model.netG, loaded["G"])
    load_strict(model.netR, loaded["R"])

    def load_img(path):
        img = resize(decode_image(path), (args.crop_size, args.crop_size),
                     "bicubic")
        return torch.from_numpy(to_array(img))[None].to(device)

    A_dir = os.path.join(args.dataroot, "testA")
    B_dir = os.path.join(args.dataroot, "testB")
    names_A = sorted(os.listdir(A_dir))[: args.num_test]
    names_B = sorted(os.listdir(B_dir))
    # paired labels (testA_label + testB_label): Dice / HD95 before and
    # after the predicted warp; reference-layout data carry trainA_label
    # only, the fallback
    labA_dir = os.path.join(args.dataroot, "testA_label")
    labB_dir = os.path.join(args.dataroot, "testB_label")
    label_dir = os.path.join(args.dataroot, "trainA_label")

    def warp_label(lab, pos_flow):
        src = torch.from_numpy(lab.astype(np.float32))[None, None]
        out = warp(src.to(device), pos_flow, mode="nearest")
        return out[0, 0].cpu().numpy().astype(lab.dtype)

    records, pair_s = [], []
    for i, name in enumerate(names_A):
        t0 = time.perf_counter()
        A = load_img(os.path.join(A_dir, name))
        B = load_img(os.path.join(B_dir, names_B[i % len(names_B)]))
        _, _, y_source, pos_flow = model.register(A, B)
        y_np = y_source[0, 0].cpu().numpy()
        B_np = B[0, 0].cpu().numpy()
        rec = {
            "name": name,
            "folding_fraction": float(folding_fraction(pos_flow)[0]),
            "jac_det_min": float(jacobian_det(pos_flow).min()),
            "ncc_global": ncc_metric(y_np, B_np),
            "ncc_windowed": -float(ncc_loss(y_source, B)),
            "psnr": psnr(y_np, B_np),
        }
        labA_path = os.path.join(labA_dir, name)
        labB_path = os.path.join(labB_dir, names_B[i % len(names_B)])
        if os.path.exists(labA_path) and os.path.exists(labB_path):
            labA = read_png(labA_path)
            labB = read_png(labB_path)
            warped = warp_label(labA, pos_flow)

            def _dice_hd(moving, fixed):
                d = label_dice(moving, fixed)
                dice = float(np.mean(list(d.values()))) if d else 1.0
                hd = [hausdorff_distance(moving == lab, fixed == lab,
                                         percentile=95)
                      for lab in d
                      if (moving == lab).any() and (fixed == lab).any()]
                return dice, (float(np.mean(hd)) if hd else None)

            for tag, pair in (("before", (labA, labB)),
                              ("after", (warped, labB))):
                dice, hd = _dice_hd(*pair)
                rec[f"dice_{tag}"] = dice
                if hd is not None:
                    rec[f"hd95_{tag}"] = hd
        elif os.path.exists(os.path.join(label_dir, name)):
            lab = read_png(os.path.join(label_dir, name))
            warped = warp_label(lab, pos_flow)
            d = label_dice(warped, lab)
            rec["label_dice_mean"] = float(np.mean(list(d.values()))) \
                if d else 1.0
            masks = [(warped == lab_id, lab == lab_id) for lab_id in d]
            hd = [hausdorff_distance(a, b, percentile=95)
                  for a, b in masks if a.any() and b.any()]
            if hd:
                rec["hd95_mean"] = float(np.mean(hd))
        records.append(rec)
        pair_s.append(time.perf_counter() - t0)

    summary = summarize(records, args.out)
    return {"summary": summary, "records": records, "pair_s": pair_s}


def summarize(records, out, **extra):
    """The mean of every key over the records that have it, ``n_pairs``
    and ``extra``; printed as one JSON line and, with the records, written
    to ``out``."""
    keys = sorted({k for r in records for k in r if k != "name"})
    summary = {f"mean_{k}": float(np.mean([r[k] for r in records if k in r]))
               for k in keys}
    summary["n_pairs"] = len(records)
    summary.update(extra)
    print(json.dumps(summary))
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({"summary": summary, "records": records}, f, indent=1)
    return summary


def eval_volumes(args, device):
    """3-D registration quality of a ``--model vxm`` checkpoint (the JAX
    script's ``eval_volumes``): NCC and PSNR before and after the
    predicted warp, deformation health, and per-label Dice and HD95
    before and after where paired label volumes exist.  The metrics other
    than windowed NCC run on the host, in numpy.  Returns the summary, the
    records, the seconds of each pair and of its Dice / HD95, and each
    labelled pair's label values before and after the warp."""
    cfg = VxmConfig(
        ndims=3, vol_size=args.vol_size, int_steps=args.int_steps,
        int_downsize=args.int_downsize, bidir=args.bidir,
        enc=tuple(int(v) for v in args.enc.split(",")),
        dec=tuple(int(v) for v in args.dec.split(",")), batch_size=1)
    eng = VxmEngine(cfg, device=device)
    save_dir = os.path.join(args.checkpoints_dir, args.name)
    loaded = ckpt.load_networks(
        save_dir, args.epoch, ["R"],
        msgpack_converter=lambda name, tree: netR_state_from_jax(
            tree, cfg.enc, cfg.dec))
    load_strict(eng.netR, loaded["R"])
    size = (args.vol_size,) * 3

    def load_vol(path):
        vol = crop_or_pad(normalize_minmax(load_volume(path)), size)
        return torch.from_numpy(vol)[None, None].to(device)

    def load_lab(path):
        lab = np.load(path)
        return crop_or_pad(np.asarray(lab, np.float32),
                           size).astype(np.int32)

    A_dir = os.path.join(args.dataroot, "testA")
    B_dir = os.path.join(args.dataroot, "testB")
    names_A = sorted(os.listdir(A_dir))[: args.num_test]
    names_B = sorted(os.listdir(B_dir))
    labA_dir = os.path.join(args.dataroot, "testA_label")
    labB_dir = os.path.join(args.dataroot, "testB_label")

    records, pair_s, label_s, label_values = [], [], [], []
    for i, name in enumerate(names_A):
        t0 = time.perf_counter()
        name_B = names_B[i % len(names_B)]
        A = load_vol(os.path.join(A_dir, name))
        B = load_vol(os.path.join(B_dir, name_B))
        y_source, pos_flow = eng.register(A, B)
        y_np, B_np, A_np = (x[0, 0].cpu().numpy() for x in (y_source, B, A))
        rec = {
            "name": name,
            "folding_fraction": float(folding_fraction(pos_flow)[0]),
            "jac_det_min": float(jacobian_det(pos_flow).min()),
            "ncc_global_before": ncc_metric(A_np, B_np),
            "ncc_global_after": ncc_metric(y_np, B_np),
            "ncc_windowed_before": -float(ncc_loss(A, B)),
            "ncc_windowed_after": -float(ncc_loss(y_source, B)),
            "psnr_before": psnr(A_np, B_np, data_range=1.0),
            "psnr_after": psnr(y_np, B_np, data_range=1.0),
        }
        labA_path = os.path.join(labA_dir, name)
        labB_path = os.path.join(labB_dir, name_B)
        if os.path.exists(labA_path) and os.path.exists(labB_path):
            labA = load_lab(labA_path)
            labB = load_lab(labB_path)
            src = torch.from_numpy(labA.astype(np.float32))[None, None]
            warped = warp(src.to(device), pos_flow, mode="nearest")[
                0, 0].cpu().numpy().astype(labA.dtype)
            t1 = time.perf_counter()
            for tag, moving in (("before", labA), ("after", warped)):
                d = label_dice(moving, labB)
                rec[f"dice_{tag}"] = (float(np.mean(list(d.values())))
                                      if d else 1.0)
                hd = [hausdorff_distance(moving == lab, labB == lab,
                                         percentile=95)
                      for lab in d
                      if (moving == lab).any() and (labB == lab).any()]
                if hd:
                    rec[f"hd95_{tag}"] = float(np.mean(hd))
            label_s.append(time.perf_counter() - t1)
            label_values.append({"moving": np.unique(labA).tolist(),
                                 "warped": np.unique(warped).tolist()})
        records.append(rec)
        pair_s.append(time.perf_counter() - t0)

    summary = summarize(records, args.out, ndims=3)
    return {"summary": summary, "records": records, "pair_s": pair_s,
            "label_s": label_s, "label_values": label_values}


if __name__ == "__main__":
    main()
