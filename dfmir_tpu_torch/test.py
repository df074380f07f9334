"""Inference entry point (the JAX package's ``test.py``): batch-1 serial
inference over the test split.

    python -m dfmir_tpu_torch.test --dataroot DATA --name EXP [flags]

For each pair it warps the pair's label map from
``{dataroot}/trainA_label`` (nearest) into ``{dataroot}/deform_label/``,
writes the registered image to ``{dataroot}/deform_trainA/``, the
Jacobian-determinant overlay and its statistics to ``{dataroot}/jac_vis/``
(``stats.jsonl``), and the visuals to the HTML gallery under
``{results_dir}/{name}/{phase}_{epoch}``.  The per-pair tensors come from
``infer.register_pair_outputs``.  ``main`` returns the number of pairs
and the seconds of each.

It serves the paper's model only: ``--model vxm`` is refused before any
model is built (the JAX package's ``test.py`` cannot serve it either); a
volumetric checkpoint is scored by ``python -m dfmir_tpu_torch.evaluate
--ndims 3``.
"""

import json
import os
import time

import numpy as np
import torch

from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.device import float32_math
from dfmir_tpu_torch.infer import register_pair_outputs
from dfmir_tpu_torch.models import create_model
from dfmir_tpu_torch.options import TestOptions
from dfmir_tpu_torch.utils import html as html_mod
from dfmir_tpu_torch.utils.jac_vis import jac_det_to_rgb, overlay
from dfmir_tpu_torch.utils.png import read_png, write_png
from dfmir_tpu_torch.utils.util import copyconf
from dfmir_tpu_torch.utils.visualizer import save_images


def save_gray(img01, path):
    """(H, W) float in [0, 1] -> 8-bit PNG."""
    arr = np.clip(np.asarray(img01, np.float32), 0.0, 1.0) * 255.0
    write_png(path, arr.astype(np.uint8))


def main(argv=None):
    float32_math()
    opt = TestOptions(argv).parse()
    if opt.model != "registration":
        raise ValueError(
            f"test.py serves --model registration, not --model {opt.model}; "
            f"score a volumetric checkpoint with python -m "
            f"dfmir_tpu_torch.evaluate --ndims 3")
    opt.num_threads = 0
    opt.batch_size = 1
    opt.serial_batches = True
    opt.no_flip = True
    opt.display_id = -1
    dataset = create_dataset(opt)
    create_dataset(copyconf(opt, phase="train"))  # checks the train split
    model = create_model(opt)

    web_dir = os.path.join(opt.results_dir, opt.name,
                           f"{opt.phase}_{opt.epoch}")
    print("creating web directory", web_dir)
    webpage = html_mod.HTML(
        web_dir,
        f"Experiment = {opt.name}, Phase = {opt.phase}, Epoch = {opt.epoch}")

    images_A_names = sorted(os.listdir(
        os.path.join(opt.dataroot, opt.phase + "A")))
    label_dir = os.path.join(opt.dataroot, "trainA_label")

    pair_s = []
    for i, data in enumerate(dataset):
        if i == 0:
            model.data_dependent_initialize(data)
            model.setup(opt)
            model.parallelize()
            model.eval()
        if i >= opt.num_test:
            break
        t0 = time.perf_counter()
        model.set_input(data)
        model.test()
        img_path = model.get_image_paths()
        print(i, img_path[0] if img_path else "")

        name = images_A_names[i % len(images_A_names)]
        label_path = os.path.join(label_dir, name)
        label = None
        if os.path.exists(label_path):
            lab = read_png(label_path).astype(np.float32)
            lab = lab[None] if lab.ndim == 2 else np.moveaxis(lab, -1, 0)
            label = torch.from_numpy(lab / 255.0)[None].to(model.device)
        real_A, real_B = model._batch
        out = register_pair_outputs(model.engine, real_A, real_B, label)

        if label is not None:
            out_dir = os.path.join(opt.dataroot, "deform_label")
            os.makedirs(out_dir, exist_ok=True)
            save_gray(out["label_warped"][0, 0].cpu().numpy(),
                      os.path.join(out_dir, name))

        y_source = out["y_source"][0, 0].cpu().numpy()
        out_dir = os.path.join(opt.dataroot, "deform_trainA")
        os.makedirs(out_dir, exist_ok=True)
        save_gray(y_source / 2.0 + 0.5, os.path.join(out_dir, name))

        det = out["jac_det"][0].cpu().numpy()
        fold = float(out["folding_fraction"][0])
        jac_dir = os.path.join(opt.dataroot, "jac_vis")
        os.makedirs(jac_dir, exist_ok=True)
        write_png(os.path.join(jac_dir, name),
                  overlay(y_source, jac_det_to_rgb(det)))
        stats = {"name": name, "folding_fraction": fold,
                 "jac_det_min": float(det.min()),
                 "jac_det_max": float(det.max())}
        with open(os.path.join(jac_dir, "stats.jsonl"), "a") as f:
            f.write(json.dumps(stats) + "\n")

        visuals = {"real_A": real_A, "real_B": real_B,
                   "fake_B": out["fake_B"], "registered": out["y_source"]}
        save_images(webpage, visuals, img_path, width=opt.display_winsize)
        pair_s.append(time.perf_counter() - t0)
    webpage.save()
    return {"n_pairs": len(pair_s), "pair_s": pair_s}


if __name__ == "__main__":
    main()
