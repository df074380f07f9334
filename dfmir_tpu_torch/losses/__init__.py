from dfmir_tpu_torch.losses.contrastive import nt_xent_loss, smooth_loss_3d
from dfmir_tpu_torch.losses.gan import gan_loss, gradient_penalty
from dfmir_tpu_torch.losses.nce import patch_nce_loss
from dfmir_tpu_torch.losses.registry import DICT_LOSSES, get_loss
from dfmir_tpu_torch.losses.regularizers import grad_loss, smoothness_loss
from dfmir_tpu_torch.losses.similarity import (cross_entropy_loss, dice_loss,
                                              masked_l1, masked_l2, mse_loss,
                                              ncc_loss, ncc_map, nll_loss,
                                              nmi_loss, tukey_biweight)

__all__ = ["gan_loss", "gradient_penalty", "patch_nce_loss", "masked_l1",
           "masked_l2", "mse_loss", "ncc_loss", "ncc_map", "smoothness_loss",
           "grad_loss", "tukey_biweight", "cross_entropy_loss", "nll_loss",
           "dice_loss", "nmi_loss", "nt_xent_loss", "smooth_loss_3d",
           "DICT_LOSSES", "get_loss"]
