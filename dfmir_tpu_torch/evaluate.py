"""Offline registration evaluation of a trained checkpoint (the 2-D half of
the JAX package's ``scripts/evaluate.py``): deformation-field statistics
(%|J|<0, min |J|), image similarity (global NCC, PSNR, windowed NCC) and,
where label maps exist, segmentation overlap (per-label Dice, HD95).

    python -m dfmir_tpu_torch.evaluate --dataroot DATA --name EXP \\
        [--checkpoints_dir ./checkpoints] [--crop_size 256] [--num_test N] \\
        [--gpu_ids -1] [--out results/eval.json]

Reads {dataroot}/testA and testB; Dice and HD95 before and after the
predicted warp where testA_label and testB_label hold the pairs' labels,
else against {dataroot}/trainA_label.  The checkpoint is
``{epoch}_net_{G,R}.pth``, or the JAX package's ``.msgpack`` where
``msgpack`` is installed.  Prints one JSON summary line and writes the
per-pair records to --out.  ``--ndims 3`` (volumes) is ROADMAP A10b.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from dfmir_tpu_torch.compat.convert import load_strict, net_state_from_jax
from dfmir_tpu_torch.data.image_folder import decode_image
from dfmir_tpu_torch.data.transforms import resize, to_array
from dfmir_tpu_torch.engine import checkpoints as ckpt
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.losses import ncc_loss
from dfmir_tpu_torch.metrics import (hausdorff_distance, label_dice,
                                     ncc_metric, psnr)
from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det
from dfmir_tpu_torch.ops.warp import warp
from dfmir_tpu_torch.options.base_options import device_from_gpu_ids
from dfmir_tpu_torch.utils.png import read_png


def main(argv=None):
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
    # volume mode (--ndims 3), the JAX script's flags: ROADMAP A10b
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
        raise NotImplementedError("--ndims 3: the volume evaluation is not "
                                  "ported yet (ROADMAP A10b)")

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

    keys = sorted({k for r in records for k in r if k != "name"})
    summary = {f"mean_{k}": float(np.mean([r[k] for r in records if k in r]))
               for k in keys}
    summary["n_pairs"] = len(records)
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "records": records}, f, indent=1)
    return {"summary": summary, "records": records, "pair_s": pair_s}


if __name__ == "__main__":
    main()
