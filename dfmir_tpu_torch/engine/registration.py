"""The registration model: netG translates A to B, netR registers A to B.

This slice ports inference, ``register`` (the path ``test.py`` serves):
the generator on real_A and real_B stacked as one batch, then VxmDense in
``registration=True`` mode.  netF, the losses, Adam and the train step come
with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from dfmir_tpu_torch.nets.vxm import VxmDense
from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det


def resnet_blocks(netG: str) -> int:
    """Block count of a ``resnet_<n>blocks`` generator name."""
    if not (netG.startswith("resnet_") and netG.endswith("blocks")):
        raise NotImplementedError(
            f"netG {netG!r}: only the resnet_<n>blocks generators are ported")
    return int(netG[len("resnet_"):-len("blocks")])


class RegistrationModel:
    """Builds netG and netR on ``device`` (CUDA unless the caller names
    another), initialised from ``generator`` (seed 0 when None).  The
    weights are drawn on the CPU, so one generator seed gives the same
    weights on every device."""

    def __init__(self, cfg: RegistrationConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: only float32 is ported")
        if cfg.netR != "vxm":
            raise NotImplementedError(f"netR {cfg.netR!r}: only 'vxm' is ported")
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.netG = ResnetGenerator(
            input_nc=cfg.input_nc, output_nc=cfg.output_nc, ngf=cfg.ngf,
            n_blocks=resnet_blocks(cfg.netG), norm=cfg.normG,
            use_dropout=not cfg.no_dropout, no_antialias=cfg.no_antialias,
            no_antialias_up=cfg.no_antialias_up, init_type=cfg.init_type,
            init_gain=cfg.init_gain, generator=generator,
        ).to(self.device).eval()
        self.netR = VxmDense(
            ndims=cfg.ndims, nb_features=(tuple(cfg.vxm_enc),
                                          tuple(cfg.vxm_dec)),
            int_steps=cfg.int_steps, int_downsize=cfg.int_downsize,
            bidir=True, compute_dtype=cfg.compute_dtype, generator=generator,
        ).to(self.device).eval()

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
