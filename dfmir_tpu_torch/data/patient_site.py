"""Per-patient-site slice datasets (the JAX package's
``data/patient_site.py``; the reference's alternate medical loaders).

- ``PatientSiteDataset`` (``--dataset_mode patient_site``): the dataroot
  holds a directory per patient / site, each with ``t1/`` and ``t2/`` slice
  folders; item i pairs A = (site s, slice k) with B = (a random site,
  the same slice index k), a cross-site pair at one anatomical position.
  A comes back a second time as C (the original modality), as in the
  reference.  Each image is centre-cropped to ``--crop_size`` (zeros
  outside), in grayscale and [-1, 1].
- ``TripletDataset`` (``--dataset_mode triplet``): sorted ``{phase}A`` /
  ``{phase}B`` pairs plus a third stream C from ``trainA`` (the
  untranslated original-modality images; A's own files without that
  folder), each through the shared transform chain.

Each item draws from ``numpy.random.default_rng((seed, epoch, index))``
in the JAX dataset's order, so any worker thread, and the JAX package,
give the same pixels.  Images decode with the port's PNG codec
(``utils/png.py``, PIL's ``convert("L")`` rounding); items are CHW.
``RegistrationTask.set_input`` reads A and B and ignores C, as the JAX
task does.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from dfmir_tpu_torch.data.image_folder import load_image, make_dataset
from dfmir_tpu_torch.data.transforms import apply_transform, crop, to_array


def center_crop_array(img: np.ndarray, size: int) -> np.ndarray:
    """A (H, W) uint8 image centre-cropped to ``size`` (PIL's crop: zeros
    outside) -> CHW float32 in [-1, 1]."""
    h, w = img.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    return to_array(crop(img, (left, top, left + size, top + size)))


class PatientSiteDataset:
    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", opt.phase == "train")
        self.current_epoch = 0
        self.seed = int(getattr(opt, "seed", 0) or 0)
        root = opt.dataroot
        sites = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d, "t1")))
        if not sites:
            raise RuntimeError(
                f"{root}: no site directories with t1/ subfolders")
        self.A = [sorted(make_dataset(os.path.join(root, s, "t1")))
                  for s in sites]
        self.B = [sorted(make_dataset(os.path.join(root, s, "t2")))
                  for s in sites]
        self.dir_size = len(self.A[0])
        self.n_sites = len(self.A)

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return self.n_sites * self.dir_size

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, self.current_epoch, index))
        site, k = divmod(index, self.dir_size)
        b_site = int(rng.integers(0, self.n_sites))
        A_path = self.A[site][k]
        B_path = self.B[b_site][k % len(self.B[b_site])]
        size = self.opt.crop_size
        A = center_crop_array(load_image(A_path), size)
        B = center_crop_array(load_image(B_path), size)
        return {"A": A, "B": B, "C": A.copy(),
                "A_paths": A_path, "B_paths": B_path}


class TripletDataset:
    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", opt.phase == "train")
        self.current_epoch = 0
        self.seed = int(getattr(opt, "seed", 0) or 0)
        root = opt.dataroot
        self.A_paths = sorted(make_dataset(
            os.path.join(root, opt.phase + "A"), opt.max_dataset_size))
        self.B_paths = sorted(make_dataset(
            os.path.join(root, opt.phase + "B"), opt.max_dataset_size))
        c_dir = os.path.join(root, "trainA")
        self.C_paths = (sorted(make_dataset(c_dir))
                        if os.path.isdir(c_dir) else list(self.A_paths))
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        self.C_size = len(self.C_paths)

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return max(self.A_size, self.B_size)

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.default_rng((self.seed, self.current_epoch, index))
        paths = {"A_paths": self.A_paths[index % self.A_size],
                 "B_paths": self.B_paths[index % self.B_size],
                 "C_paths": self.C_paths[index % self.C_size]}
        item = {k[0]: apply_transform(self.opt, load_image(p),
                                      grayscale=True, rng=rng)
                for k, p in paths.items()}
        return {**item, **paths}
