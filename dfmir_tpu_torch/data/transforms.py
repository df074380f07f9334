"""Host-side image preprocessing on uint8 numpy images, producing CHW
arrays: the JAX package's ``data/transforms.py`` chain, grayscale -> one
of resize / scale_width / scale_shortside / fixsize -> optional zoom ->
crop / patch / trim -> make-power-of-2 (base 4) -> flip -> to-array +
normalize((0.5,), (0.5,)).

Images are (H, W) uint8 arrays (or (H, W, C)); random parameters are drawn
from an explicit ``numpy.random.Generator`` in the JAX chain's order, so
the same generator gives the same pixels bit for bit.  Crop, flip and
the conversion are numpy.  A resize to the size the image already has is a
copy (PIL's ``Image.resize`` returns ``self.copy()`` there); any other
resize imports PIL inside the function and raises ``ImportError`` without
it.  The default chain at ``--load_size`` = ``--crop_size`` needs no PIL.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from dfmir_tpu_torch.utils.png import to_grayscale
from dfmir_tpu_torch.utils.util import require_pil


@dataclasses.dataclass
class TransformParams:
    """Pre-drawn random parameters, so that A/B (or image/label) pairs can
    share one crop and flip."""

    crop_pos: Tuple[int, int] = (0, 0)
    flip: bool = False
    scale_factor: Optional[Tuple[float, float]] = None
    patch_index: int = 0


def get_params(opt, size: Tuple[int, int],
               rng: Optional[np.random.Generator] = None) -> TransformParams:
    rng = rng or np.random.default_rng()
    w, h = size
    new_w, new_h = w, h
    if opt.preprocess == "resize_and_crop":
        new_w = new_h = opt.load_size
    elif opt.preprocess == "scale_width_and_crop":
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    flip = bool(rng.random() > 0.5)
    zoom = tuple(rng.uniform(0.8, 1.0, size=2)) if "zoom" in opt.preprocess \
        else None
    return TransformParams(crop_pos=(x, y), flip=flip, scale_factor=zoom)


def image_size(img: np.ndarray) -> Tuple[int, int]:
    """(width, height), as PIL's ``Image.size``."""
    return img.shape[1], img.shape[0]


def resize(img: np.ndarray, size: Tuple[int, int],
           method: str = "bicubic") -> np.ndarray:
    """PIL's ``Image.resize(size, method)`` for ``size`` = (w, h): a copy
    when the image has that size, else PIL's resampling."""
    size = (int(size[0]), int(size[1]))
    if image_size(img) == size:
        return img.copy()
    Image = require_pil(f"resizing a {img.shape[1]}x{img.shape[0]} image "
                        f"to {size[0]}x{size[1]}")
    pil_method = getattr(Image.Resampling, method.upper())
    return np.asarray(Image.fromarray(img).resize(size, pil_method))


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """PIL's ``Image.crop(box)``: (x1, y1, x2, y2), zeros outside."""
    x1, y1, x2, y2 = box
    h, w = img.shape[:2]
    out = np.zeros((y2 - y1, x2 - x1) + img.shape[2:], img.dtype)
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if sx2 > sx1 and sy2 > sy1:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = img[sy1:sy2, sx1:sx2]
    return out


def flip_lr(img: np.ndarray) -> np.ndarray:
    """PIL's ``transpose(FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(img[:, ::-1])


def _scale_width(img, target_width, crop_width, method):
    ow, oh = image_size(img)
    if ow == target_width and oh >= crop_width:
        return img
    h = int(max(target_width * oh / ow, crop_width))
    return resize(img, (target_width, h), method)


def _scale_shortside(img, target_width, method):
    ow, oh = image_size(img)
    if min(ow, oh) >= target_width:
        return img
    scale = target_width / min(ow, oh)
    return resize(img, (round(ow * scale), round(oh * scale)), method)


def _zoom(img, crop_width, factor, method):
    iw, ih = image_size(img)
    zw = max(crop_width, iw * factor[0])
    zh = max(crop_width, ih * factor[1])
    return resize(img, (int(round(zw)), int(round(zh))), method)


def _crop(img, pos, size):
    ow, oh = image_size(img)
    x1, y1 = pos
    if ow > size or oh > size:
        return crop(img, (x1, y1, x1 + size, y1 + size))
    return img


def _patch(img, index, size, rng):
    ow, oh = image_size(img)
    nw, nh = ow // size, oh // size
    startx = int(rng.integers(0, ow - nw * size + 1))
    starty = int(rng.integers(0, oh - nh * size + 1))
    index = index % (nw * nh)
    ix, iy = index // nh, index % nh
    gx, gy = startx + ix * size, starty + iy * size
    return crop(img, (gx, gy, gx + size, gy + size))


def _trim(img, trim_width, rng):
    ow, oh = image_size(img)
    xs = int(rng.integers(0, ow - trim_width)) if ow > trim_width else 0
    ys = int(rng.integers(0, oh - trim_width)) if oh > trim_width else 0
    return crop(img, (xs, ys, min(xs + trim_width, ow),
                      min(ys + trim_width, oh)))


def _make_power_2(img, base, method):
    ow, oh = image_size(img)
    w = int(round(ow / base) * base)
    h = int(round(oh / base) * base)
    if w == ow and h == oh:
        return img
    return resize(img, (w, h), method)


def to_chw(img: np.ndarray) -> np.ndarray:
    """(H, W) or (H, W, C) -> (C, H, W)."""
    return img[None] if img.ndim == 2 else np.moveaxis(img, -1, 0)


def to_array(img: np.ndarray) -> np.ndarray:
    """uint8 image -> CHW float32 in [-1, 1] (ToTensor + Normalize(0.5,
    0.5)), in the JAX chain's float32 operations and order."""
    arr = np.asarray(img, dtype=np.float32)
    arr = arr / 255.0
    return np.ascontiguousarray(to_chw(arr * 2.0 - 1.0))


def apply_transform(opt, img: np.ndarray,
                    params: Optional[TransformParams] = None,
                    grayscale: bool = True,
                    method: str = "bicubic",
                    convert: bool = True,
                    rng: Optional[np.random.Generator] = None,
                    out_dtype: str = "float32"):
    """The whole chain; returns CHW float32 in [-1, 1], or with
    ``out_dtype="uint8"`` the CHW uint8 pixels before the normalize, or
    with ``convert=False`` the (H, W) image itself (label maps)."""
    rng = rng or np.random.default_rng()
    pre = opt.preprocess
    if grayscale and img.ndim == 3:
        img = to_grayscale(img)
    if "fixsize" in pre:
        img = resize(img, (opt.crop_size, opt.crop_size), method)
    if "resize" in pre:
        img = resize(img, (opt.load_size, opt.load_size), method)
    elif "scale_width" in pre:
        img = _scale_width(img, opt.load_size, opt.crop_size, method)
    elif "scale_shortside" in pre:
        img = _scale_shortside(img, opt.load_size, method)
    if "zoom" in pre:
        factor = params.scale_factor if params and params.scale_factor \
            else tuple(rng.uniform(0.8, 1.0, size=2))
        img = _zoom(img, opt.crop_size, factor, method)
    if "crop" in pre:
        if params is None:
            ow, oh = image_size(img)
            x = int(rng.integers(0, max(0, ow - opt.crop_size) + 1))
            y = int(rng.integers(0, max(0, oh - opt.crop_size) + 1))
            img = _crop(img, (x, y), opt.crop_size)
        else:
            img = _crop(img, params.crop_pos, opt.crop_size)
    if "patch" in pre:
        img = _patch(img, params.patch_index if params else 0,
                     opt.crop_size, rng)
    if "trim" in pre:
        img = _trim(img, opt.crop_size, rng)
    img = _make_power_2(img, base=4, method=method)
    if not getattr(opt, "no_flip", False):
        flip = params.flip if params is not None else bool(rng.random() > 0.5)
        if flip:
            img = flip_lr(img)
    if not convert:
        return img
    if out_dtype == "uint8":
        return np.ascontiguousarray(to_chw(np.asarray(img, np.uint8)))
    return to_array(img)
