"""A history buffer of generated images for discriminator updates (the JAX
package's ``utils/image_pool.py``; the reference ImagePool), on numpy's
``default_rng(seed)``: once the pool is full, each query image is swapped
for a random buffered one with probability 0.5.

Not wired into the step, as in the JAX package: its ``RegistrationTask``
forces ``pool_size=0`` and its engine never queries a pool.
"""

from __future__ import annotations

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.num_imgs = 0
        self.images = []
        self.rng = np.random.default_rng(seed)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: a (B, ...) batch; returns a batch mixing history and
        new."""
        if self.pool_size == 0:
            return images
        images = np.asarray(images)
        out = []
        for image in images:
            if self.num_imgs < self.pool_size:
                self.num_imgs += 1
                self.images.append(image.copy())
                out.append(image)
            elif self.rng.random() > 0.5:
                idx = int(self.rng.integers(0, self.pool_size))
                tmp = self.images[idx].copy()
                self.images[idx] = image.copy()
                out.append(tmp)
            else:
                out.append(image)
        return np.stack(out)
