"""Network factories (the JAX package's ``nets/factory.py``): ``define_D``,
the ``--netD`` choices.  netG, netF and netR are built by
``engine/registration.py`` directly (one family each is ported)."""

from __future__ import annotations

import torch

from dfmir_tpu_torch.nets.discriminators import (NLayerDiscriminator,
                                                 PatchDiscriminator,
                                                 PixelDiscriminator)

STYLEGAN2_D = ("stylegan2", "patchstylegan2", "smallpatchstylegan2",
               "tilestylegan2")


def define_D(input_nc: int = 1, ndf: int = 64, netD: str = "basic",
             n_layers_D: int = 3, norm: str = "instance",
             init_type: str = "xavier", init_gain: float = 0.02,
             no_antialias: bool = False, *, generator: torch.Generator):
    """The discriminator ``netD`` names, initialised from ``generator``."""
    if netD in STYLEGAN2_D:
        raise NotImplementedError(
            f"netD {netD!r}: the StyleGAN2 discriminators are not ported "
            f"(ROADMAP A13b)")
    init = dict(init_type=init_type, init_gain=init_gain,
                generator=generator)
    if netD in ("basic", "n_layers"):
        return NLayerDiscriminator(
            input_nc, ndf, 3 if netD == "basic" else n_layers_D, norm,
            no_antialias, **init)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm, **init)
    if netD == "patch":
        return PatchDiscriminator(input_nc, ndf, norm, no_antialias, **init)
    raise NotImplementedError(
        f"Discriminator model name [{netD}] is not recognized")
