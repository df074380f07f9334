"""Paired 3-D volumes for volumetric registration (``--dataset_mode
volume``; the JAX package's ``data/volume.py``).

The layout is the 2-D one: ``{dataroot}/{phase}A`` and ``{phase}B`` hold
``.npy`` / ``.npz`` volumes (npz key ``vol``, else the first array), and
``A[i]`` pairs with ``B[i % B_size]``.  Volumes are min-max normalized to
[0, 1] and center-cropped / zero-padded to ``--vol_size``, so that every
batch has one shape.  Items are ``(1, D, H, W)`` float32 (NCDHW once
batched), where the JAX package's are ``(D, H, W, 1)``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

VOL_EXTENSIONS = (".npy", ".npz")


def make_volume_dataset(directory: str, max_dataset_size=None):
    if not os.path.isdir(directory):
        raise NotADirectoryError(f"{directory} is not a valid directory")
    out = []
    for root, _, fnames in sorted(os.walk(directory, followlinks=True)):
        for fname in sorted(fnames):
            if fname.lower().endswith(VOL_EXTENSIONS):
                out.append(os.path.join(root, fname))
    if max_dataset_size is not None and max_dataset_size != float("inf"):
        out = out[: int(max_dataset_size)]
    return out


def load_volume(path: str) -> np.ndarray:
    """A (D, H, W) float32 volume; a trailing size-1 axis is dropped."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "vol" if "vol" in z.files else z.files[0]
            vol = z[key]
    else:
        vol = np.load(path)
    vol = np.asarray(vol, np.float32)
    if vol.ndim == 4 and vol.shape[-1] == 1:
        vol = vol[..., 0]
    if vol.ndim != 3:
        raise ValueError(f"{path}: expected a 3-D volume, got {vol.shape}")
    return vol


def normalize_minmax(vol: np.ndarray) -> np.ndarray:
    lo, hi = float(vol.min()), float(vol.max())
    if hi - lo < 1e-12:
        return np.zeros_like(vol)
    return (vol - lo) / (hi - lo)


def crop_or_pad(vol: np.ndarray, target) -> np.ndarray:
    """Center crop / zero-pad each axis to the target shape (an odd
    remainder goes after)."""
    out = vol
    for ax, t in enumerate(target):
        s = out.shape[ax]
        if s > t:
            start = (s - t) // 2
            out = np.take(out, range(start, start + t), axis=ax)
        elif s < t:
            lo = (t - s) // 2
            widths = [(0, 0)] * out.ndim
            widths[ax] = (lo, t - s - lo)
            out = np.pad(out, widths)
    return out


class VolumeDataset:
    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", opt.phase == "train")
        self.current_epoch = 0
        self.dir_A = os.path.join(opt.dataroot, opt.phase + "A")
        self.dir_B = os.path.join(opt.dataroot, opt.phase + "B")
        self.A_paths = make_volume_dataset(self.dir_A, opt.max_dataset_size)
        self.B_paths = make_volume_dataset(self.dir_B, opt.max_dataset_size)
        self.A_size = len(self.A_paths)
        self.B_size = len(self.B_paths)
        size = getattr(opt, "vol_size", 160)
        self.target = (size, size, size) if np.isscalar(size) else tuple(size)

    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument("--vol_size", type=int, default=160,
                            help="cubic crop/pad size for volumes")
        return parser

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch

    def __len__(self) -> int:
        return max(self.A_size, self.B_size)

    def _load(self, path: str) -> np.ndarray:
        vol = normalize_minmax(load_volume(path))
        return crop_or_pad(vol, self.target)[None]

    def __getitem__(self, index: int) -> Dict:
        A_path = self.A_paths[index % self.A_size]
        B_path = self.B_paths[index % self.B_size]
        return {"A": self._load(A_path), "B": self._load(B_path),
                "A_paths": A_path, "B_paths": B_path}
