"""What ``test.py`` computes for one pair, on tensors and with no file I/O.

``register_pair_outputs`` runs ``RegistrationModel.register`` and the
per-pair outputs test.py derives from it: the nearest-mode label warp, the
Jacobian-determinant map and the folding fraction.  The PNG/HTML command
line is ROADMAP item A10.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dfmir_tpu_torch.ops.jacobian import folding_fraction, jacobian_det
from dfmir_tpu_torch.ops.warp import warp


@torch.no_grad()
def register_pair_outputs(model, real_A, real_B,
                          label: Optional[torch.Tensor] = None
                          ) -> Dict[str, torch.Tensor]:
    """real_A, real_B (B, C, H, W); ``label`` (B, C_l, H, W), scaled as
    test.py scales it (uint8 / 255).  Returns fake_B, idt_B, y_source,
    pos_flow, jac_det (B, H, W), folding_fraction (B,) and, with a label,
    label_warped (nearest)."""
    fake_B, idt_B, y_source, pos_flow = model.register(real_A, real_B)
    out = {"fake_B": fake_B, "idt_B": idt_B, "y_source": y_source,
           "pos_flow": pos_flow, "jac_det": jacobian_det(pos_flow),
           "folding_fraction": folding_fraction(pos_flow)}
    if label is not None:
        out["label_warped"] = warp(label, pos_flow, mode="nearest")
    return out
