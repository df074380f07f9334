"""Image-directory walk and decoding (the JAX package's
``data/image_folder.py``): image files under a root, sorted walk,
extension-filtered, capped at ``max_dataset_size``; decoded images kept in
a byte-capped cache of numpy arrays (``--cache_images_mb``)."""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from dfmir_tpu_torch.utils.png import read_png
from dfmir_tpu_torch.utils.util import require_pil

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff",
)


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str,
                 max_dataset_size: Optional[float] = None) -> List[str]:
    if not (os.path.isdir(directory) or os.path.islink(directory)):
        raise NotADirectoryError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory, followlinks=True)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    if max_dataset_size is not None and max_dataset_size != float("inf"):
        images = images[: int(max_dataset_size)]
    return images


class ImageCache:
    """Decoded images up to ``cache_mb`` megabytes in all (0: none).

    Insert-only: a training set is re-read uniformly every epoch, so
    evicting buys nothing.  The arrays are read-only; the transforms copy
    before they change one."""

    def __init__(self, cache_mb: float = 0):
        self.capacity = float(cache_mb) * (1 << 20)
        self.nbytes = 0
        self._images: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        return self._images.get(key)

    def put(self, key, img: np.ndarray) -> None:
        with self._lock:
            if key in self._images or \
                    self.nbytes + img.nbytes > self.capacity:
                return
            img.setflags(write=False)
            self._images[key] = img
            self.nbytes += img.nbytes


def decode_image(path: str, grayscale: bool = True) -> np.ndarray:
    """(H, W) uint8 (grayscale, as PIL's ``convert("L")``) or the image's
    own (H, W[, C]).  PNGs decode through ``utils/png.py``; other formats
    need PIL."""
    if path.lower().endswith(".png"):
        return read_png(path, mode="L" if grayscale else None)
    Image = require_pil(f"decoding {path} (not a PNG)")
    with Image.open(path) as img:
        if grayscale and img.mode != "L":
            return np.array(img.convert("L"))
        return np.array(img)


def load_image(path: str, grayscale: bool = True,
               cache: Optional[ImageCache] = None) -> np.ndarray:
    """``decode_image``, through ``cache`` when one is given."""
    key = (path, grayscale)
    img = cache.get(key) if cache is not None else None
    if img is None:
        img = decode_image(path, grayscale)
        if cache is not None:
            cache.put(key, img)
    return img
