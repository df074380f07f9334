"""Evaluation metrics (numpy): segmentation overlap and image similarity."""

from dfmir_tpu_torch.metrics.image import ncc_metric, psnr
from dfmir_tpu_torch.metrics.segmentation import (dice_score,
                                                  hausdorff_distance,
                                                  label_dice)

__all__ = ["dice_score", "hausdorff_distance", "label_dice", "ncc_metric",
           "psnr"]
