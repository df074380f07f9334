"""Segmentation-overlap metrics on integer label maps of any
dimensionality, host-side numpy (a copy of the JAX package's
``metrics/segmentation.py``): hard Dice, per-label Dice and the
(percentile) Hausdorff distance through Euclidean distance transforms."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def dice_score(a: np.ndarray, b: np.ndarray) -> float:
    """Hard Dice of two binary masks (1.0 when both are empty)."""
    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(a, b).sum() / denom)


def label_dice(pred: np.ndarray, target: np.ndarray,
               labels: Optional[Sequence[int]] = None) -> dict:
    """Per-label hard Dice between two integer label maps; without
    ``labels``, every non-zero label present in either map."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    if labels is None:
        labels = sorted(set(np.unique(pred)) | set(np.unique(target)))
        labels = [lab for lab in labels if lab != 0]
    return {int(lab): dice_score(pred == lab, target == lab)
            for lab in labels}


def hausdorff_distance(a: np.ndarray, b: np.ndarray,
                       percentile: Optional[float] = None) -> float:
    """(Percentile-)Hausdorff distance between two binary masks;
    ``percentile=95`` gives HD95.  inf when one mask is empty, 0 when
    both are."""
    from scipy.ndimage import distance_transform_edt

    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    if not a.any() or not b.any():
        return float("inf") if a.any() != b.any() else 0.0
    dt_a = distance_transform_edt(~a)
    dt_b = distance_transform_edt(~b)
    d_ab = dt_b[a]  # distance from each voxel of a to b
    d_ba = dt_a[b]
    if percentile is not None:
        return float(max(np.percentile(d_ab, percentile),
                         np.percentile(d_ba, percentile)))
    return float(max(d_ab.max(), d_ba.max()))
