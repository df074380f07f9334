"""Flow regularizers on NCHW / NCDHW flows (B, nd, *spatial).

- ``smoothness_loss``: the paper model's flow smoothness, the mean squared
  finite difference of the integrated full-resolution flow, averaged over
  the spatial axes.
- ``grad_loss``: the reference Grad_Loss, l1 or l2, 2-D or 3-D.
"""

from __future__ import annotations


def _axis_diffs(flow):
    """|forward difference| along each spatial axis."""
    return [flow.diff(dim=axis).abs() for axis in range(2, flow.ndim)]


def smoothness_loss(flow):
    diffs = _axis_diffs(flow)
    return sum((d * d).mean() for d in diffs) / len(diffs)


def grad_loss(flow, penalty: str = "l2"):
    if penalty not in ("l1", "l2"):
        raise ValueError(f"penalty must be 'l1' or 'l2', got {penalty!r}")
    diffs = _axis_diffs(flow)
    if penalty == "l2":
        diffs = [d * d for d in diffs]
    return sum(d.mean() for d in diffs) / len(diffs)
