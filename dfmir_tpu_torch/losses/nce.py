"""PatchNCE (InfoNCE over sampled patches), the reference PatchNCELoss.

Positive logit ``<q_i, k_i>``; negatives are the per-image ``q @ k^T`` with
the diagonal masked to -10; logits over ``nce_T``; cross-entropy against
class 0, one value per patch (the caller means over patches).  ``feat_k``
is detached: the key encoder is not updated through this loss.

feat_q, feat_k: (B * P, dim), P patches per image.  ``batch_size`` is the
number of images; ``all_negatives_from_minibatch`` folds them into one.
"""

from __future__ import annotations

import torch


def patch_nce_loss(feat_q, feat_k, nce_T: float = 0.07, batch_size: int = 1,
                   all_negatives_from_minibatch: bool = False):
    """Per-patch InfoNCE loss, shape (B * P,)."""
    dim = feat_q.shape[-1]
    feat_k = feat_k.detach()
    l_pos = (feat_q * feat_k).sum(dim=-1, keepdim=True)        # (N, 1)

    b = 1 if all_negatives_from_minibatch else batch_size
    q = feat_q.reshape(b, -1, dim)
    k = feat_k.reshape(b, -1, dim)
    npatches = q.shape[1]
    l_neg = torch.bmm(q, k.transpose(1, 2))                    # (b, P, P)
    eye = torch.eye(npatches, dtype=torch.bool, device=q.device)
    l_neg = l_neg.masked_fill(eye[None], -10.0).reshape(-1, npatches)

    logits = torch.cat([l_pos, l_neg], dim=1) / nce_T
    return torch.logsumexp(logits, dim=1) - logits[:, 0]
