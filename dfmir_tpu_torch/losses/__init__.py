from dfmir_tpu_torch.losses.gan import gan_loss, gradient_penalty
from dfmir_tpu_torch.losses.nce import patch_nce_loss
from dfmir_tpu_torch.losses.regularizers import grad_loss, smoothness_loss
from dfmir_tpu_torch.losses.similarity import (masked_l1, masked_l2, mse_loss,
                                              ncc_loss, ncc_map)

__all__ = ["gan_loss", "gradient_penalty", "patch_nce_loss", "masked_l1", "masked_l2", "mse_loss",
           "ncc_loss", "ncc_map", "smoothness_loss", "grad_loss"]
