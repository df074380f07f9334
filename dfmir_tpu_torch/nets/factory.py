"""Network factories (the JAX package's ``nets/factory.py``): a
``--netG`` / ``--netF`` / ``--netD`` name -> a module initialised from an
explicit ``torch.Generator``.  Unknown names raise NotImplementedError."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dfmir_tpu_torch.nets.discriminators import (NLayerDiscriminator,
                                                 PatchDiscriminator,
                                                 PixelDiscriminator)
from dfmir_tpu_torch.nets.feature_nets import (PoolingF, ReshapeF,
                                               StridedConvF)
from dfmir_tpu_torch.nets.munit import GResnet
from dfmir_tpu_torch.nets.patch_sample import PatchSampleF
from dfmir_tpu_torch.nets.resnet_gen import ResnetGenerator
from dfmir_tpu_torch.nets.stylegan2 import (StyleGAN2Discriminator,
                                            StyleGAN2Generator,
                                            TileStyleGAN2Discriminator)
from dfmir_tpu_torch.nets.unet_gen import UnetGenerator


def g_family(netG: str) -> str:
    """The family of a ``--netG`` name: resnet, unet, munit or
    stylegan2."""
    if netG.startswith("resnet_") and netG.endswith("blocks"):
        return "resnet"
    if netG in ("unet_128", "unet_256"):
        return "unet"
    if netG == "resnet_cat":
        return "munit"
    if netG in ("stylegan2", "smallstylegan2"):
        return "stylegan2"
    raise NotImplementedError(
        f"Generator model name [{netG}] is not recognized")


def resnet_blocks(netG: str) -> int:
    """Block count of a ``resnet_<n>blocks`` generator name."""
    return int(netG[len("resnet_"):-len("blocks")])


def define_G(input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
             netG: str = "resnet_9blocks", norm: str = "instance",
             use_dropout: bool = False, init_type: str = "xavier",
             init_gain: float = 0.02, no_antialias: bool = False,
             no_antialias_up: bool = False, size: int = 256,
             stylegan2_num_downsampling: int = 1, ndims: int = 2, *,
             generator: torch.Generator):
    """``ndims``: the rank of the images (3 for volumes); the resnet and
    unet families are built for 3-D, the others (2-D convs in JAX too)
    are refused there."""
    family = g_family(netG)
    if family == "resnet":
        return ResnetGenerator(
            input_nc, output_nc, ngf, resnet_blocks(netG), norm, use_dropout,
            no_antialias, no_antialias_up, init_type=init_type,
            init_gain=init_gain, ndims=ndims, generator=generator)
    if family == "unet":
        return UnetGenerator(
            input_nc, output_nc, 7 if netG == "unet_128" else 8, ngf, norm,
            use_dropout, init_type, init_gain, ndims=ndims,
            generator=generator)
    if ndims != 2:
        raise NotImplementedError(f"netG {netG} at ndims={ndims}")
    if family == "munit":
        return GResnet(input_nc, output_nc, nz=0, num_downs=2, n_res=4,
                       ngf=ngf, generator=generator)
    return StyleGAN2Generator(
        input_nc, output_nc, ngf, 8 if netG == "smallstylegan2" else 9, size,
        stylegan2_num_downsampling, small=netG == "smallstylegan2",
        generator=generator)


def define_F(netF: str = "mlp_sample", netF_nc: int = 256,
             feature_dims: Optional[Sequence[int]] = None,
             strided_specs: Optional[Sequence[Tuple[int, int]]] = None,
             init_type: str = "xavier", init_gain: float = 0.02,
             ndims: int = 2, *, generator: torch.Generator):
    """``ndims`` sizes StridedConvF's convs and EMA; the other heads take
    the rank from their input."""
    if netF == "global_pool":
        return PoolingF()
    if netF == "reshape":
        return ReshapeF()
    if netF in ("sample", "mlp_sample"):
        return PatchSampleF(tuple(feature_dims or ()), nc=netF_nc,
                            use_mlp=netF == "mlp_sample",
                            init_type=init_type, init_gain=init_gain,
                            generator=generator)
    if netF == "strided_conv":
        return StridedConvF(tuple(strided_specs or ()), init_type, init_gain,
                            ndims=ndims, generator=generator)
    raise NotImplementedError(
        f"projection model name [{netF}] is not recognized")


def define_D(input_nc: int = 1, ndf: int = 64, netD: str = "basic",
             n_layers_D: int = 3, norm: str = "instance",
             init_type: str = "xavier", init_gain: float = 0.02,
             no_antialias: bool = False, size: int = 256,
             D_patch_size: int = 64, in_size: Optional[int] = None,
             ndims: int = 2, *, generator: torch.Generator):
    """The discriminator ``netD`` names.  ``size`` and ``D_patch_size``
    are the StyleGAN2 discriminators' (JAX's engine leaves them at their
    defaults); ``in_size``, the side of the images netD scores, sets the
    plain StyleGAN2 discriminator's linear width.  ``ndims=3`` builds the
    NLayer and pixel discriminators for volumes; the others (2-D in JAX
    too) are refused there."""
    if ndims != 2 and netD not in ("basic", "n_layers", "pixel"):
        raise NotImplementedError(f"netD {netD} at ndims={ndims}")
    if netD in ("stylegan2", "patchstylegan2", "smallpatchstylegan2"):
        return StyleGAN2Discriminator(
            input_nc, ndf, size, patch="patch" in netD,
            small_patch="smallpatch" in netD, in_size=in_size,
            generator=generator)
    if netD == "tilestylegan2":
        return TileStyleGAN2Discriminator(input_nc, ndf, D_patch_size,
                                          generator=generator)
    init = dict(init_type=init_type, init_gain=init_gain,
                generator=generator)
    if netD in ("basic", "n_layers"):
        return NLayerDiscriminator(
            input_nc, ndf, 3 if netD == "basic" else n_layers_D, norm,
            no_antialias, ndims=ndims, **init)
    if netD == "pixel":
        return PixelDiscriminator(input_nc, ndf, norm, ndims=ndims, **init)
    if netD == "patch":
        return PatchDiscriminator(input_nc, ndf, norm, no_antialias, **init)
    raise NotImplementedError(
        f"Discriminator model name [{netD}] is not recognized")
