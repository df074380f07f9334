"""PatchNCE (InfoNCE over sampled patches), the reference PatchNCELoss.

Positive logit ``<q_i, k_i>``; negatives are the per-image ``q @ k^T`` with
the diagonal masked to -10; logits over ``nce_T``; cross-entropy against
class 0, one value per patch (the caller means over patches).  ``feat_k``
is detached: the key encoder is not updated through this loss.

feat_q, feat_k: (B * P, dim), P patches per image.  ``batch_size`` is the
number of images; ``all_negatives_from_minibatch`` folds them into one.

``mesh`` (data parallelism, ``parallel/mesh.py``): feat_q and feat_k are
this rank's slice of the global batch.  With
``all_negatives_from_minibatch`` the negatives are the keys of every
image of the global batch: the keys are all-gathered (they carry no
gradient), this rank's queries meet all B * P of them, and the masked
diagonal sits at the rank's offset.  The mean over the ranks of the mean
of the returned losses is then the global batch's.  Without it each
image's negatives are its own, and the mesh changes nothing.  On slabs
(a mesh with a spatial axis) every spatial rank of a data rank holds that
data rank's whole samples (``nets/patch_sample.py``), so the keys are
gathered over the data ranks alone (``all_gather_data``), and the offset
is the data rank's.
"""

from __future__ import annotations

import torch

from dfmir_tpu_torch.parallel.mesh import all_gather_data


def patch_nce_loss(feat_q, feat_k, nce_T: float = 0.07, batch_size: int = 1,
                   all_negatives_from_minibatch: bool = False, mesh=None):
    """Per-patch InfoNCE loss, shape (B * P,) of this rank's patches."""
    dim = feat_q.shape[-1]
    feat_k = feat_k.detach()
    l_pos = (feat_q * feat_k).sum(dim=-1, keepdim=True)        # (N, 1)

    b = 1 if all_negatives_from_minibatch else batch_size
    q = feat_q.reshape(b, -1, dim)
    offset = 0
    if all_negatives_from_minibatch and mesh is not None:
        feat_k = all_gather_data(feat_k, mesh)
        offset = q.shape[1] * mesh.data_rank
    k = feat_k.reshape(b, -1, dim)
    l_neg = torch.bmm(q, k.transpose(1, 2))                    # (b, P, K)
    eye = torch.eye(q.shape[1], k.shape[1], dtype=torch.bool,
                    device=q.device)
    if offset:
        eye = eye.roll(offset, 1)
    l_neg = l_neg.masked_fill(eye[None], -10.0).reshape(-1, k.shape[1])

    logits = torch.cat([l_pos, l_neg], dim=1) / nce_T
    return torch.logsumexp(logits, dim=1) - logits[:, 0]
