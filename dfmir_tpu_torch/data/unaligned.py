"""Unpaired A/B dataset (the JAX package's ``data/unaligned.py``).

Sorted file lists from ``{dataroot}/{phase}A`` and ``{phase}B`` (test falls
back to val), ``A[i]`` paired with ``B[i % B_size]``, a joint 50% horizontal
flip of the pair in training, and ``load_size -> crop_size`` once the decay
epochs start (FastCUT finetuning).  Each sample draws from
``numpy.random.default_rng((seed, epoch, index))`` in the JAX dataset's
order (the pair flip, then A's and B's crop and flip), so any worker
thread, and the JAX package, produce the same pixels.  Samples are CHW.
"""

from __future__ import annotations

import copy
import os
from typing import Dict

import numpy as np

from dfmir_tpu_torch.data.image_folder import (ImageCache, load_image,
                                               make_dataset)
from dfmir_tpu_torch.data.transforms import apply_transform, flip_lr


class UnalignedDataset:
    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", opt.phase == "train")
        self.current_epoch = 0
        self.dir_A = os.path.join(opt.dataroot, opt.phase + "A")
        self.dir_B = os.path.join(opt.dataroot, opt.phase + "B")
        if (opt.phase == "test" and not os.path.exists(self.dir_A)
                and os.path.exists(os.path.join(opt.dataroot, "valA"))):
            self.dir_A = os.path.join(opt.dataroot, "valA")
            self.dir_B = os.path.join(opt.dataroot, "valB")
        self.A_paths = sorted(make_dataset(self.dir_A, opt.max_dataset_size))
        self.B_paths = sorted(make_dataset(self.dir_B, opt.max_dataset_size))
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        self.seed = int(getattr(opt, "seed", 0) or 0)
        self.cache = ImageCache(
            float(getattr(opt, "cache_images_mb", 0) or 0))

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return max(self.A_size, self.B_size)

    def _effective_opt(self):
        # FastCUT finetuning: once decay starts, stop resize-crop aug.
        is_finetuning = (self.isTrain
                         and self.current_epoch > self.opt.n_epochs)
        if not is_finetuning or self.opt.load_size == self.opt.crop_size:
            return self.opt
        opt = copy.copy(self.opt)
        opt.load_size = opt.crop_size
        return opt

    def __getitem__(self, index: int) -> Dict:
        A_path = self.A_paths[index % self.A_size]
        B_path = self.B_paths[index % self.B_size]
        rng = np.random.default_rng(
            (self.seed, self.current_epoch, index))
        A_img = load_image(A_path, grayscale=True, cache=self.cache)
        B_img = load_image(B_path, grayscale=True, cache=self.cache)
        if self.isTrain and rng.random() > 0.5:
            A_img, B_img = flip_lr(A_img), flip_lr(B_img)
        opt = self._effective_opt()
        # uint8 batches go to the device as raw pixels and are normalized
        # there (RegistrationTask.set_input)
        dt = "uint8" if getattr(opt, "uint8_transfer", False) else "float32"
        A = apply_transform(opt, A_img, grayscale=True, rng=rng,
                            out_dtype=dt)
        B = apply_transform(opt, B_img, grayscale=True, rng=rng,
                            out_dtype=dt)
        return {"A": A, "B": B, "A_paths": A_path, "B_paths": B_path}
