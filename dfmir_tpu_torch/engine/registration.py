"""The registration model: netG translates A to B, netR registers A to B,
netF projects the generator's features for PatchNCE.

Two paths are ported:

- inference, ``register`` (the path ``test.py`` serves): the generator on
  real_A and real_B stacked as one batch, then VxmDense in
  ``registration=True`` mode;
- training, ``loss_fn`` / ``train_step`` (the step ``train.py`` loops
  over): translate, register, warp, PatchNCE x3 + masked L1 x2 + local NCE
  + smoothness, one backward through netG, netF and netR, one Adam update
  of all three.  ``eval_step`` and ``compute_visuals`` run the same loss
  without an update.

The step follows the JAX package's default branch (``fuse_nce_encodes``
without flip equivariance): the NCE keys are the forward pass's taps, and
the three query images go through one encoder pass.  With
``fuse_nce_encodes=False`` the JAX package re-encodes the keys; the result
is the same (the generator's ops are per-sample, and the JAX suite holds
the two equal), so the port takes the same path for both settings.

Not ported (they raise NotImplementedError): ``flip_equivariance``,
``lambda_GAN > 0`` (the discriminator phase), dropout in training
(``no_dropout=False``), ``netF`` other than ``mlp_sample`` / ``sample``,
``compute_dtype="bfloat16"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.losses import masked_l1, patch_nce_loss, smoothness_loss
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator, nce_feature_dims
from dfmir_tpu_torch.nets.vxm import VxmDense
from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det
from dfmir_tpu_torch.ops.warp import warp

NETF_CHOICES = ("mlp_sample", "sample")


def resnet_blocks(netG: str) -> int:
    """Block count of a ``resnet_<n>blocks`` generator name."""
    if not (netG.startswith("resnet_") and netG.endswith("blocks")):
        raise NotImplementedError(
            f"netG {netG!r}: only the resnet_<n>blocks generators are ported")
    return int(netG[len("resnet_"):-len("blocks")])


def grid_image(size: int, spacing: int = 16, thickness: int = 1):
    """Procedural grid image in [-1, 1], (1, 1, size, size): what the
    ``dvf`` visual warps (it stands in for the reference's deform256.jpg)."""
    img = torch.ones(size, size)
    for start in range(0, size, spacing):
        img[start:start + thickness, :] = -1.0
        img[:, start:start + thickness] = -1.0
    return img[None, None]


class RegistrationModel:
    """Builds netG, netR and netF on ``device`` (CUDA unless the caller
    names another), initialised from ``generator`` (seed 0 when None), and
    one Adam over the three.  The weights are drawn on the CPU, so one
    generator seed gives the same weights on every device."""

    def __init__(self, cfg: RegistrationConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported")
        if cfg.netR != "vxm":
            raise NotImplementedError(f"netR {cfg.netR!r}: only 'vxm' is ported")
        if cfg.netF not in NETF_CHOICES:
            raise NotImplementedError(
                f"netF {cfg.netF!r}: only {NETF_CHOICES} are ported")
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        gen_kwargs = dict(
            input_nc=cfg.input_nc, output_nc=cfg.output_nc, ngf=cfg.ngf,
            n_blocks=resnet_blocks(cfg.netG),
            no_antialias=cfg.no_antialias, no_antialias_up=cfg.no_antialias_up)
        self.netG = ResnetGenerator(
            **gen_kwargs, norm=cfg.normG, use_dropout=not cfg.no_dropout,
            init_type=cfg.init_type, init_gain=cfg.init_gain,
            generator=generator,
        ).to(self.device).eval()
        self.netR = VxmDense(
            ndims=cfg.ndims, nb_features=(tuple(cfg.vxm_enc),
                                          tuple(cfg.vxm_dec)),
            int_steps=cfg.int_steps, int_downsize=cfg.int_downsize,
            bidir=True, compute_dtype=cfg.compute_dtype, generator=generator,
        ).to(self.device).eval()
        self.netF = PatchSampleF(
            nce_feature_dims(cfg.nce_layers, **gen_kwargs), nc=cfg.netF_nc,
            use_mlp=cfg.netF == "mlp_sample", init_type=cfg.init_type,
            init_gain=cfg.init_gain, generator=generator,
        ).to(self.device)
        # patch ids are drawn from this when a step is given neither ids
        # nor a generator
        self.patch_generator = torch.Generator().manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=generator)))
        self.optimizer = torch.optim.Adam(
            self.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
            eps=1e-8)

    def parameters(self) -> List[torch.nn.Parameter]:
        """The trained parameters: netG's, netF's and netR's."""
        return [p for net in (self.netG, self.netF, self.netR)
                for p in net.parameters()]

    # ------------------------------------------------------------ inference

    @torch.no_grad()
    def register(self, real_A, real_B):
        """Inference: translation, then registration=True.

        real_A, real_B: (B, C, H, W).  Returns (fake_B, idt_B, y_source,
        pos_flow)."""
        B = real_A.shape[0]
        fake = self.netG(torch.cat([real_A, real_B], dim=0))
        y_source, pos_flow = self.netR(real_A, real_B, registration=True)
        return fake[:B], fake[B:], y_source, pos_flow

    @torch.no_grad()
    def registration_metrics(self, real_A, real_B) -> Dict[str, torch.Tensor]:
        """Jacobian-determinant map (B, H, W) and folding fraction (B,)."""
        pos_flow = self.register(real_A, real_B)[3]
        return {"jac_det": jacobian_det(pos_flow),
                "folding_fraction": folding_fraction(pos_flow)}

    @torch.no_grad()
    def flow_stats(self, real_A, real_B) -> Dict[str, torch.Tensor]:
        """Scalar field-health statistics of the registration flow."""
        pos_flow = self.register(real_A, real_B)[3]
        det = jacobian_det(pos_flow)
        return {"fold": folding_fraction(pos_flow).mean(),
                "jac_min": det.min(), "jac_max": det.max(),
                "jac_mean": det.mean(), "flow_max": pos_flow.abs().max()}

    # ------------------------------------------------------------- training

    def _check_trainable(self):
        cfg = self.cfg
        for unported, what in (
            (cfg.flip_equivariance, "flip_equivariance=True"),
            (cfg.lambda_GAN > 0, f"lambda_GAN={cfg.lambda_GAN} (the "
                                 f"discriminator phase)"),
            (not cfg.no_dropout, "dropout in training (no_dropout=False)"),
        ):
            if unported:
                raise NotImplementedError(f"{what} is not ported")

    def _nce(self, feat_q, feat_k, patch_ids, generator):
        """The NCE loss of one (query, key) pair of tapped feature lists,
        averaged over the layers."""
        cfg = self.cfg
        k_pool, ids = self.netF(feat_k, cfg.num_patches, patch_ids,
                                generator=generator)
        q_pool, _ = self.netF(feat_q, cfg.num_patches, ids)
        total = 0.0
        for f_q, f_k in zip(q_pool, k_pool):
            per_patch = patch_nce_loss(
                f_q, f_k, nce_T=cfg.nce_T, batch_size=feat_q[0].shape[0],
                all_negatives_from_minibatch=(
                    cfg.nce_includes_all_negatives_from_minibatch))
            total = total + per_patch.mean() * cfg.lambda_NCE
        return total / len(cfg.nce_layers)

    def loss_fn(self, real_A, real_B,
                patch_ids: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None):
        """The step's losses: returns (total, metrics, aux).

        real_A, real_B: (B, C, H, W).  ``patch_ids`` gives the patch
        locations, one list per NCE call (NCE, NCE_Y when ``nce_idt``,
        local) of one (P,) index tensor per tapped layer; without it they
        are drawn from ``generator`` (a CPU generator), else from the
        model's own ``patch_generator``.  metrics: G, NCE, NCE_Y (with
        ``nce_idt``), R, smooth, local, total.  aux: fake_B, idt_B,
        registered, regA, pos_flow."""
        self._check_trainable()
        cfg = self.cfg
        B = real_A.shape[0]
        layers = tuple(cfg.nce_layers)
        if generator is None:
            generator = self.patch_generator

        fake, feats_fwd = self.netG(torch.cat([real_A, real_B], dim=0),
                                    layers=layers)
        fake_B, idt_B = fake[:B], fake[B:]
        y_source, _, pos_flow = self.netR(real_A, real_B)
        registered = warp(fake_B, pos_flow)

        # keys from the forward taps; the queries in one encoder pass
        use_idt = cfg.nce_idt and cfg.lambda_NCE > 0
        q_imgs = [fake_B] + ([idt_B] if use_idt else []) + [y_source]
        q_feats = self.netG(torch.cat(q_imgs, dim=0), layers=layers,
                            encode_only=True)
        feats_A = [f[:B] for f in feats_fwd]
        feats_B = [f[B:] for f in feats_fwd]
        k_chunks = [feats_A] + ([feats_B] if use_idt else []) + [feats_B]
        if patch_ids is None:
            patch_ids = [None] * len(q_imgs)
        if len(patch_ids) != len(q_imgs):
            raise ValueError(f"patch_ids holds {len(patch_ids)} lists, the "
                             f"step makes {len(q_imgs)} NCE calls")
        nce_vals = [
            self._nce([f[i * B:(i + 1) * B] for f in q_feats], k_chunks[i],
                      patch_ids[i], generator)
            for i in range(len(q_imgs))]

        loss_NCE = nce_vals[0]
        if use_idt:
            loss_NCE_Y = nce_vals[1]
            loss_G = (loss_NCE + loss_NCE_Y) * 0.5
        else:
            loss_NCE_Y = torch.zeros((), device=real_A.device)
            loss_G = loss_NCE

        # R losses; the masks are ORs of foreground tests
        mask = (real_B > -0.95) | (registered > -0.95)
        mask2 = (idt_B > -0.95) | (registered > -0.95)
        loss_local = nce_vals[-1] * cfg.local_weight
        loss_R = (masked_l1(registered, real_B, mask)
                  + masked_l1(idt_B, registered, mask2) + loss_local)
        loss_smooth = smoothness_loss(pos_flow) * cfg.smooth_weight

        total = loss_R + loss_G + loss_smooth
        metrics = {"G": loss_G, "NCE": loss_NCE, "R": loss_R,
                   "smooth": loss_smooth, "local": loss_local,
                   "total": total}
        if cfg.nce_idt:
            metrics["NCE_Y"] = loss_NCE_Y
        aux = {"fake_B": fake_B, "idt_B": idt_B, "registered": registered,
               "regA": y_source, "pos_flow": pos_flow}
        return total, metrics, aux

    def train_step(self, real_A, real_B, lr: float,
                   patch_ids: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimisation step: one backward through netG, netF and netR,
        then one Adam update of all three at learning rate ``lr`` (the
        update of ``optax.scale_by_adam`` followed by ``-lr * u``).
        Returns the metrics, detached, on the model's device."""
        self.optimizer.zero_grad(set_to_none=True)
        total, metrics, _ = self.loss_fn(real_A, real_B, patch_ids, generator)
        total.backward()
        self.apply_gradients(lr)
        return {k: v.detach() for k, v in metrics.items()}

    def apply_gradients(self, lr: float) -> None:
        """One Adam update from the parameters' ``.grad`` at rate ``lr``."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        self.optimizer.step()

    @torch.no_grad()
    def eval_step(self, real_A, real_B, patch_ids=None, generator=None):
        """Losses and outputs without an update: (metrics, aux)."""
        _, metrics, aux = self.loss_fn(real_A, real_B, patch_ids, generator)
        return metrics, aux

    @torch.no_grad()
    def compute_visuals(self, real_A, real_B, patch_ids=None,
                        generator=None):
        """The reference's visual set, (visuals, metrics): real_A, fake_B,
        real_B, dvf (the grid image warped by pos_flow), registered, regA,
        and idt_B with ``nce_idt``."""
        _, metrics, aux = self.loss_fn(real_A, real_B, patch_ids, generator)
        grid = grid_image(self.cfg.crop_size).to(real_A.device)
        dvf = warp(grid.expand(real_A.shape[0], -1, -1, -1).contiguous(),
                   aux["pos_flow"])
        visuals = {"real_A": real_A, "fake_B": aux["fake_B"],
                   "real_B": real_B, "dvf": dvf,
                   "registered": aux["registered"], "regA": aux["regA"]}
        if self.cfg.nce_idt:
            visuals["idt_B"] = aux["idt_B"]
        return visuals, metrics
