"""SimCLR's NT-Xent contrastive loss and a 3-D smoothness penalty (the JAX
package's ``losses/contrastive.py``, from the reference's
networks_contrastive_learning side library)."""

from __future__ import annotations

import torch


def nt_xent_loss(z_i, z_j, temperature: float = 0.5,
                 use_cosine_similarity: bool = True):
    """NT-Xent over two views z_i, z_j (B, D): the positive of sample i is
    its other view, the negatives every other sample of the 2B; the summed
    cross entropy over 2B."""
    B = z_i.shape[0]
    z = torch.cat([z_i, z_j], dim=0)                    # (2B, D)
    if use_cosine_similarity:
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-8)
    n = 2 * B
    sim = (z @ z.T) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    pos = torch.cat([torch.arange(B) + B, torch.arange(B)]).to(z.device)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp[torch.arange(n, device=z.device), pos].sum() / n


def smooth_loss_3d(flow, penalty: str = "l2"):
    """The mean finite-difference penalty of a (B, 3, D, H, W) flow over
    its three spatial axes, / 3."""
    d = 0.0
    for axis in (2, 3, 4):
        diff = flow.diff(dim=axis).abs()
        if penalty == "l2":
            diff = diff * diff
        d = d + diff.mean()
    return d / 3.0
