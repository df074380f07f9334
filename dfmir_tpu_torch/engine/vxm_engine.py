"""The volumetric (and 2-D) pure-registration engine, classic VoxelMorph:
VxmDense, an image similarity (windowed NCC or MSE) and the L2 gradient
smoothness of the pre-integration SVF (the stationary velocity field the
flow head emits, before scaling and squaring).

A port of ``dfmir_tpu/engine/vxm_engine.py``: the same ``VxmConfig``, the
same losses and metrics, and the entry points ``register``,
``train_step``, ``eval_step`` and ``flow_stats``.  The JAX engine threads
a ``VxmState`` through pure functions; this one holds netR and its Adam
state (``torch.optim.Adam``, betas (0.9, 0.999), eps 1e-8: the update of
``optax.scale_by_adam`` followed by ``-lr * u``, with ``lr`` set each
step).  ``remat`` recomputes netR's forward in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does.

When the tensors lie on the card, VecInt's chain runs as one kernel launch
each way (2-D or 3-D) and the data warp on the single-warp kernels
(bilinear or trilinear); on the CPU the plain versions run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.losses import grad_loss, mse_loss, ncc_loss
from dfmir_tpu_torch.nets.vxm import VxmDense, default_unet_features
from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det


@dataclasses.dataclass(frozen=True)
class VxmConfig:
    ndims: int = 3
    vol_size: int = 160
    enc: Tuple[int, ...] = (16, 32, 32, 32)
    dec: Tuple[int, ...] = (32, 32, 32, 32, 32, 16, 16)
    int_steps: int = 7
    int_downsize: int = 2
    bidir: bool = False
    image_loss: str = "ncc"      # 'ncc' | 'mse'
    ncc_win: int = 9
    lambda_smooth: float = 0.01  # classic vxm weight for l2 grad on the SVF
    lr: float = 1e-4
    batch_size: int = 1
    compute_dtype: str = "float32"
    remat: bool = False          # recompute netR's forward in the backward

    @classmethod
    def from_opt(cls, opt) -> "VxmConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(opt).items() if k in fields}
        for key in ("enc", "dec"):
            if key in kwargs and isinstance(kwargs[key], str):
                kwargs[key] = tuple(int(v) for v in kwargs[key].split(","))
        return cls(**kwargs)


class VxmEngine:
    """netR (VxmDense) on ``device`` (CUDA unless the caller names
    another), its weights drawn on the CPU from ``seed`` (so one seed gives
    the same weights on every device), and one Adam over them.

    Volumes are (B, 1, *spatial), NCDHW at 3-D."""

    def __init__(self, cfg: VxmConfig, device=None, seed: int = 0):
        self.device = resolve_device(device)
        if not cfg.enc:
            enc, dec = default_unet_features()
            cfg = dataclasses.replace(cfg, enc=tuple(enc), dec=tuple(dec))
        self.cfg = cfg
        self.netR = VxmDense(
            ndims=cfg.ndims, nb_features=(tuple(cfg.enc), tuple(cfg.dec)),
            int_steps=cfg.int_steps, int_downsize=cfg.int_downsize,
            bidir=cfg.bidir, compute_dtype=cfg.compute_dtype,
            generator=torch.Generator().manual_seed(seed),
        ).to(self.device).eval()
        self.optimizer = torch.optim.Adam(
            self.netR.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0

    def _sim(self, pred, target):
        if self.cfg.image_loss == "ncc":
            return ncc_loss(pred, target,
                            kernel_var=[self.cfg.ncc_win] * self.cfg.ndims)
        if self.cfg.image_loss == "mse":
            return mse_loss(pred, target)
        raise NotImplementedError(self.cfg.image_loss)

    def _forward(self, source, target):
        return self.netR(source, target, return_preint=True)

    def loss_fn(self, source, target):
        """(total, metrics): metrics sim, smooth and total, as tensors."""
        cfg = self.cfg
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(self._forward, source, target,
                             use_reentrant=False)
        else:
            out = self._forward(source, target)
        if cfg.bidir:
            y_source, y_target, _, preint = out
            sim = 0.5 * (self._sim(y_source, target)
                         + self._sim(y_target, source))
        else:
            y_source, _, preint = out
            sim = self._sim(y_source, target)
        smooth = grad_loss(preint, penalty="l2") * cfg.lambda_smooth
        total = sim + smooth
        return total, {"sim": sim, "smooth": smooth, "total": total}

    def train_step(self, source, target, lr=None) -> Dict[str, torch.Tensor]:
        """One backward through netR and one Adam update at ``lr``
        (``cfg.lr`` when None).  Returns the metrics, detached, on the
        engine's device."""
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics = self.loss_fn(source, target)
        total.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.cfg.lr if lr is None else lr)
        self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def register(self, source, target):
        """(y_source, pos_flow): the inference path."""
        return self.netR(source, target, registration=True)

    @torch.no_grad()
    def eval_step(self, source, target) -> Dict[str, torch.Tensor]:
        return self.loss_fn(source, target)[1]

    @torch.no_grad()
    def flow_stats(self, source, target) -> Dict[str, torch.Tensor]:
        """Scalar field-health statistics of the registration flow."""
        _, pos_flow = self.register(source, target)
        det = jacobian_det(pos_flow)
        return {"fold": folding_fraction(pos_flow).mean(),
                "jac_min": det.min(), "jac_max": det.max(),
                "jac_mean": det.mean(), "flow_max": pos_flow.abs().max()}
