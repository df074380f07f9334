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

Data parallelism (``data_parallel``, the JAX package's sharded step):
each rank steps on its slice of the global batch; NCC's mean is the
global batch's (``parallel.mesh.global_mean``), MSE and the gradient loss
are each rank's own mean, netR's gradients and the metrics are averaged
over the ranks.  ``eval_step`` scores the batch it is given.

The spatial axis (``data_parallel`` with a mesh of ``make_mesh(mesh,
n_data, n_spatial)``, n_spatial > 1; JAX's ``shard_batch(...,
shard_spatial=True)``): each rank holds its data rank's items and, of
those, its spatial rank's slab of D / n_spatial planes along D
(``parallel.mesh.slab_slice``).  netR runs on the slabs with halo
exchanges (``nets/vxm.py``), the losses and statistics are the whole
volume's (``losses/``, ``ops/jacobian.py``), and every entry point speaks
for the global batch: ``register`` returns this rank's slabs of
(y_source, pos_flow), ``train_step``, ``eval_step`` and ``flow_stats``
the global metrics.  D must be divisible by n_spatial * lcm(2^len(enc),
int_downsize), so that every level of the UNet and the half-resolution
SVF split into equal slabs that start on even planes (``check_slabs``).

When the tensors lie on the card, VecInt's chain runs as one kernel launch
each way (2-D or 3-D) and the data warp on the single-warp kernels
(bilinear or trilinear); on the CPU the plain versions run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.losses import grad_loss, mse_loss, ncc_loss
from dfmir_tpu_torch.nets.vxm import VxmDense, default_unet_features
from dfmir_tpu_torch.ops.jacobian import field_stats
from dfmir_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                           all_reduce_metrics, is_spatial,
                                           replicate, state_tensors)


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
    compute_dtype: str = "float32"  # unused: netR is float32 (see VxmEngine)
    remat: bool = False          # recompute netR's forward in the backward

    @classmethod
    def from_opt(cls, opt) -> "VxmConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in vars(opt).items() if k in fields}
        for key in ("enc", "dec"):
            if key in kwargs and isinstance(kwargs[key], str):
                kwargs[key] = tuple(int(v) for v in kwargs[key].split(","))
        return cls(**kwargs)


def check_slabs(depth: int, n_spatial: int, cfg: "VxmConfig") -> None:
    """Raise unless a volume of ``depth`` planes splits into ``n_spatial``
    slabs that every level of netR cuts the same on every rank: D must be
    divisible by n_spatial * lcm(2^len(enc), int_downsize)."""
    unit = n_spatial * math.lcm(2 ** len(cfg.enc), cfg.int_downsize)
    if depth % unit:
        raise ValueError(
            f"a depth of {depth} does not split over {n_spatial} spatial "
            f"ranks: D must be divisible by n_spatial * lcm(2^len(enc), "
            f"int_downsize) = {n_spatial} * lcm({2 ** len(cfg.enc)}, "
            f"{cfg.int_downsize}) = {unit}")


class VxmEngine:
    """netR (VxmDense) on ``device`` (CUDA unless the caller names
    another), its weights drawn on the CPU from ``seed`` (so one seed gives
    the same weights on every device), and one Adam over them.

    netR computes in float32 whatever ``cfg.compute_dtype`` says: the JAX
    engine never passes that field to its VxmDense either, so ``--model
    vxm --compute_dtype bfloat16`` trains in float32 in both packages.

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
            bidir=cfg.bidir, generator=torch.Generator().manual_seed(seed),
        ).to(self.device).eval()
        self.optimizer = torch.optim.Adam(
            self.netR.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        self.step = 0
        self.mesh: Optional[Mesh] = None

    def state_tensors(self):
        """netR's parameters and every Adam state tensor."""
        return state_tensors([self.netR], [self.optimizer])

    def data_parallel(self, mesh: Mesh) -> None:
        """Step as rank ``mesh.rank`` of ``mesh.world``: check that every
        rank holds rank 0's netR and Adam state, then broadcast them from
        rank 0 (JAX's ``replicate``).  A mesh with n_spatial > 1
        (``make_mesh``) splits the volumes along D too: ``cfg.vol_size``
        must pass ``check_slabs``, and every call takes this rank's
        slabs."""
        if is_spatial(mesh):
            if self.cfg.ndims != 3:
                raise ValueError("the spatial axis splits 3-D volumes")
            check_slabs(self.cfg.vol_size, mesh.n_spatial, self.cfg)
        replicate(self.state_tensors(), mesh)
        self.mesh = mesh

    def _spatial(self, source) -> Optional[Mesh]:
        """The mesh when it splits the volumes (``source`` then a slab,
        whose whole depth must pass ``check_slabs``), else None."""
        if not is_spatial(self.mesh):
            return None
        check_slabs(source.shape[2] * self.mesh.n_spatial,
                    self.mesh.n_spatial, self.cfg)
        return self.mesh

    def _sim(self, pred, target, mesh):
        if self.cfg.image_loss == "ncc":
            return ncc_loss(pred, target,
                            kernel_var=[self.cfg.ncc_win] * self.cfg.ndims,
                            mesh=mesh)
        if self.cfg.image_loss == "mse":
            return mse_loss(pred, target, mesh if is_spatial(mesh) else None)
        raise NotImplementedError(self.cfg.image_loss)

    def _forward(self, source, target):
        return self.netR(source, target, return_preint=True,
                         mesh=self._spatial(source))

    def loss_fn(self, source, target, train: bool = True):
        """(total, metrics): metrics sim, smooth and total, as tensors.
        Data parallel, with ``train``: this rank's part of the global
        batch's loss.  On slabs (train or not): the global volume's and
        batch's loss, with this rank's share of its gradient."""
        cfg = self.cfg
        spatial = self._spatial(source)
        mesh = spatial or (self.mesh if train else None)
        if cfg.remat and torch.is_grad_enabled():
            out = checkpoint(self._forward, source, target,
                             use_reentrant=False)
        else:
            out = self._forward(source, target)
        if cfg.bidir:
            y_source, y_target, _, preint = out
            sim = 0.5 * (self._sim(y_source, target, mesh)
                         + self._sim(y_target, source, mesh))
        else:
            y_source, _, preint = out
            sim = self._sim(y_source, target, mesh)
        smooth = grad_loss(preint, penalty="l2",
                           mesh=spatial) * cfg.lambda_smooth
        total = sim + smooth
        return total, {"sim": sim, "smooth": smooth, "total": total}

    def train_step(self, source, target, lr=None) -> Dict[str, torch.Tensor]:
        """One backward through netR and one Adam update at ``lr``
        (``cfg.lr`` when None).  Returns the metrics, detached, on the
        engine's device; data parallel, the gradients and the metrics
        averaged over the ranks."""
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics = self.loss_fn(source, target)
        total.backward()
        all_reduce_grads(self.netR.parameters(), self.mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.cfg.lr if lr is None else lr)
        self.optimizer.step()
        self.step += 1
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                  self.mesh)

    @torch.no_grad()
    def register(self, source, target):
        """(y_source, pos_flow): the inference path; on slabs, this rank's
        slabs of both."""
        return self.netR(source, target, registration=True,
                         mesh=self._spatial(source))

    @torch.no_grad()
    def eval_step(self, source, target) -> Dict[str, torch.Tensor]:
        """The metrics of the batch given; on slabs, of the global batch
        (``loss_fn``'s statistics are global there)."""
        return self.loss_fn(source, target, train=False)[1]

    @torch.no_grad()
    def flow_stats(self, source, target,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """Scalar field-health statistics of the registration flow
        (``ops.jacobian.field_stats``); with ``mesh``, the global
        batch's; on slabs always the global volume's and batch's."""
        spatial = self._spatial(source)
        return field_stats(self.register(source, target)[1],
                           spatial or mesh)
