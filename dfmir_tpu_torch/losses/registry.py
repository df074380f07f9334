"""Name -> loss (the JAX package's ``losses/registry.py``, from the
reference's DICT_LOSSES): the same 13 names, each the port's function."""

from __future__ import annotations

import functools

from dfmir_tpu_torch.losses.gan import gan_loss, gradient_penalty
from dfmir_tpu_torch.losses.nce import patch_nce_loss
from dfmir_tpu_torch.losses.regularizers import grad_loss
from dfmir_tpu_torch.losses.similarity import (cross_entropy_loss, dice_loss,
                                              masked_l1, masked_l2, ncc_loss,
                                              nll_loss, nmi_loss,
                                              tukey_biweight)

DICT_LOSSES = {
    "L1": masked_l1,
    "L2": masked_l2,
    "TukeyBiweight": tukey_biweight,
    "PatchNCE": patch_nce_loss,
    "Grad": grad_loss,
    "NCC": ncc_loss,
    "NMI": nmi_loss,
    "CrossEntropy": cross_entropy_loss,
    "NLL": nll_loss,
    "Dice": dice_loss,
    "WGAN": functools.partial(gan_loss, gan_mode="wgangp"),
    "LSGAN": functools.partial(gan_loss, gan_mode="lsgan"),
    "GradPenGAN": gradient_penalty,
}


def get_loss(name: str):
    if name not in DICT_LOSSES:
        raise KeyError(
            f"unknown loss {name!r}; available: {sorted(DICT_LOSSES)}")
    return DICT_LOSSES[name]
