"""Small host-side helpers (the JAX package's ``utils/util.py``), on NCHW
tensors or arrays.  PNG files go through ``utils/png.py``; PIL is imported
only where an image is resized (``correct_resize*``, ``save_image`` at an
aspect ratio other than 1), inside the function."""

from __future__ import annotations

import argparse
import os
from typing import Iterable, Union

import numpy as np
import torch

from dfmir_tpu_torch.utils.png import write_png


def require_pil(what: str):
    """PIL's ``Image`` module, or ImportError saying what needed it."""
    try:
        from PIL import Image
    except ImportError as err:
        raise ImportError(f"{what} needs PIL (Pillow), which is not "
                          f"installed; the port's main path does not") from err
    return Image


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def copyconf(default_opt, **kwargs):
    conf = argparse.Namespace(**vars(default_opt))
    for key, val in kwargs.items():
        setattr(conf, key, val)
    return conf


def mkdirs(paths: Union[str, Iterable[str]]) -> None:
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor2im(arr, imtype=np.uint8) -> np.ndarray:
    """(B, C, H, W), (C, H, W) or (H, W) in [-1, 1] -> (H, W, 3) uint8 RGB,
    the first item of a batch."""
    arr = np.asarray(to_numpy(arr), dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = arr[:, :, None] if arr.ndim == 2 else np.moveaxis(arr, 0, -1)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    img = (arr + 1.0) / 2.0 * 255.0
    return np.clip(img, 0, 255).astype(imtype)


def correct_resize(arr, size, method=None) -> np.ndarray:
    """PIL-quality resize of a (B, C, H, W) [-1, 1] batch to ``size``
    (w, h); bicubic unless ``method`` names another PIL filter."""
    Image = require_pil("correct_resize")
    method = Image.BICUBIC if method is None else method
    arr = np.asarray(to_numpy(arr), np.float32)
    out = []
    for i in range(arr.shape[0]):
        img = Image.fromarray(tensor2im(arr[i]))
        resized = np.asarray(img.resize(size, method), np.float32) / 255.0
        out.append(np.moveaxis(resized * 2.0 - 1.0, -1, 0))
    res = np.stack(out)
    if arr.shape[1] == 1:
        res = res.mean(axis=1, keepdims=True)
    return res


def correct_resize_label(arr, size) -> np.ndarray:
    """Nearest-neighbour PIL resize of a (B, [1,] H, W) integer label batch
    to ``size`` (w, h); returns (B, h, w) int64."""
    Image = require_pil("correct_resize_label")
    arr = to_numpy(arr)
    out = []
    for i in range(arr.shape[0]):
        lab = arr[i, 0] if arr.ndim == 4 else arr[i]
        img = Image.fromarray(lab.astype(np.uint8))
        out.append(np.asarray(img.resize(size, Image.NEAREST), np.int64))
    return np.stack(out)


def save_image(image_numpy: np.ndarray, image_path: str,
               aspect_ratio: float = 1.0) -> None:
    """Write an (H, W[, 3]) uint8 image as PNG, stretched to
    ``aspect_ratio`` (bicubic, through PIL) when it is not 1."""
    if aspect_ratio is None or aspect_ratio == 1.0:
        write_png(image_path, image_numpy)
        return
    Image = require_pil("save_image at an aspect ratio other than 1")
    pil = Image.fromarray(image_numpy)
    h, w = image_numpy.shape[0], image_numpy.shape[1]
    if aspect_ratio > 1.0:
        pil = pil.resize((int(w * aspect_ratio), h), Image.BICUBIC)
    else:
        pil = pil.resize((w, int(h / aspect_ratio)), Image.BICUBIC)
    pil.save(image_path)
