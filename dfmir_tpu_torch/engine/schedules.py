"""Learning-rate policies matching the reference get_scheduler (linear,
step, cosine, plateau), a copy of the JAX package's ``engine/schedules.py``.
Computed on the host once per epoch (the reference steps its schedulers at
epoch end) and passed to ``RegistrationModel.train_step`` as ``lr``.
"""

from __future__ import annotations

import math


class LRSchedule:
    """Stateful per-epoch LR, mirroring torch scheduler.step() semantics."""

    def __init__(self, opt):
        self.policy = opt.lr_policy
        self.base_lr = opt.lr
        self.opt = opt
        self.epochs_stepped = 0
        # plateau state (ReduceLROnPlateau mode='min', factor=0.2,
        # threshold=0.01, patience=5)
        self._plateau_lr = opt.lr
        self._best = None
        self._bad_epochs = 0

    def current_lr(self) -> float:
        o = self.opt
        k = self.epochs_stepped
        if self.policy == "linear":
            factor = 1.0 - max(
                0, k + o.epoch_count - o.n_epochs) / float(o.n_epochs_decay + 1)
            return self.base_lr * factor
        if self.policy == "step":
            return self.base_lr * (0.1 ** (k // o.lr_decay_iters))
        if self.policy == "cosine":
            return self.base_lr * (1 + math.cos(math.pi * k / o.n_epochs)) / 2
        if self.policy == "plateau":
            return self._plateau_lr
        raise NotImplementedError(
            f"learning rate policy [{self.policy}] is not implemented")

    def step(self, metric: float = 0.0) -> float:
        """Advance one epoch (reference update_learning_rate); returns new lr."""
        if self.policy == "plateau":
            # rel threshold 0.01, mode min
            if self._best is None or metric < self._best * (1 - 0.01):
                self._best = metric
                self._bad_epochs = 0
            else:
                self._bad_epochs += 1
                if self._bad_epochs > 5:
                    self._plateau_lr *= 0.2
                    self._bad_epochs = 0
        self.epochs_stepped += 1
        return self.current_lr()
