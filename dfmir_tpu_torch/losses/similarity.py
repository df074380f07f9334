"""Image-similarity losses: windowed NCC, masked L1 / L2, MSE, Tukey's
biweight, cross entropy, NLL, Dice and NMI.

- ``ncc_map`` / ``ncc_loss``: the reference NCC_Loss.  Local sums of I, J,
  I^2, J^2 and IJ over a window, either by one depthwise conv with a mean or
  gaussian window (``_local_sums``) or by summed-area tables, one cumsum per
  axis and a shifted difference (``_local_sums_integral``, mean windows
  only: O(1) work a voxel instead of O(prod(win))); then ``cc = cross^2 /
  (I_var * J_var + eps)`` and a masked ``-sqrt(mean)`` reduction.
  ``method="auto"`` takes the tables for an odd mean window and the conv
  otherwise: torch's pad=k//2 'same' conv gives n+1 outputs for an even
  window, and that reference behaviour is kept.
- ``masked_l1``: the reference calculate_L1_loss, ``sum(|a - b| * mask) /
  sum(mask)``, 0 for an empty mask, the plain mean without a mask.
- ``masked_l2``: the same reduction of the squared difference.
- ``mse_loss``.
- ``tukey_biweight``: the reference TukeyBiweight, clamped to its
  saturation value c^2 / 6, with the masked mean.
- ``cross_entropy_loss`` / ``nll_loss``: softmax cross entropy of logits,
  and the NLL of log-probabilities, against one-hot targets; the class
  axis is dim 1 (the JAX package's is the last), a (B, 1, ...) mask is
  taken as (B, ...).
- ``dice_loss``: 1 - the mean soft Dice over batch and channels, each
  reduced over dims 2.. (the JAX package's spatial axes 1..ndim-2).
- ``nmi_loss``: the negative global mutual information, Parzen-windowed
  with gaussian bins; each item's values flattened in one order for both
  images, so that the joint histogram pairs the same pixels.

``mesh`` (data parallelism, ``parallel/mesh.py``): the masked means and
NCC reduce their sums over the global batch (``global_sum`` /
``global_mean``), so that their value is the global batch's and their
gradient, averaged over the ranks, the global gradient.  A mean of the
whole batch (``mse_loss``) needs nothing: each rank's own is its share;
with ``mesh`` it is the global mean (``global_mean``).  A mesh that splits
the volumes along D (``parallel.mesh.is_spatial``): NCC's inputs are
slabs, which take a halo of the window's half (k // 2 planes of I and J
each side, zeros past the volume's ends: the zero padding there) before
the sums; its mean is the global volume's and batch's, every slab the
same size.

Tensors are NCHW / NCDHW.  Plain PyTorch: none of this is a kernel in the
JAX package either.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dfmir_tpu_torch.parallel.mesh import (global_mean, global_sum,
                                           halo_exchange, is_spatial)


def _masked_mean(res, mask, mesh=None):
    if mask is None:
        return global_mean(res.mean(), mesh)
    mask = mask.to(res.dtype)
    denom = global_sum(mask.sum(), mesh)
    val = global_sum((res * mask).sum(), mesh) / denom.clamp_min(1.0)
    return torch.where(denom == 0, torch.zeros_like(val), val)


def masked_l1(src, tgt, mask=None, mesh=None):
    return _masked_mean((src - tgt).abs(), mask, mesh)


def masked_l2(src, tgt, mask=None):
    return _masked_mean((src - tgt).square(), mask)


def mse_loss(prediction, target, mesh=None):
    return global_mean((prediction - target).square().mean(), mesh)


def _window_kernel(kernel_type: str, kernel_var, nd: int) -> np.ndarray:
    """The window as a float32 array: ones, or a gaussian of sigma
    ``kernel_var[0]`` over an odd size of about 3 sigma."""
    if kernel_type == "mean":
        return np.ones(tuple(kernel_var), np.float32)
    if kernel_type == "gaussian":
        sigma = kernel_var[0]
        size = sigma * 3
        size += (size + 1) % 2
        coords = np.arange(size) - (size - 1) / 2.0
        grids = np.meshgrid(*([coords] * nd), indexing="ij")
        sq = sum(g ** 2 for g in grids)
        k = (1.0 / (np.sqrt(2 * np.pi) * sigma)) * np.exp(
            -sq / (2 * sigma ** 2))
        return k.astype(np.float32)
    raise NotImplementedError(f"kernel {kernel_type} not implemented")


def _stack(I, J):
    return torch.cat([I, J, I * I, J * J, I * J], dim=1)


def _local_sums(I, J, filt_np, halo: int = 0):
    """Windowed sums of I, J, I^2, J^2, IJ by one depthwise conv, zero
    padded by the window's last size // 2 on every axis; ``halo``: I and J
    carry that many planes of the neighbouring slabs on each side of D,
    which stand in for the padding there (the sums are the slab's own)."""
    nd = I.ndim - 2
    stack = _stack(I, J)
    C = stack.shape[1]
    w = torch.as_tensor(filt_np, dtype=I.dtype, device=I.device)
    w = w.reshape(1, 1, *filt_np.shape).expand(C, 1,
                                               *filt_np.shape).contiguous()
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    pad = filt_np.shape[-1] // 2
    out = conv(stack, w, padding=(0, pad, pad) if halo else pad, groups=C)
    return out.split(I.shape[1], dim=1)


def _local_sums_integral(I, J, win, halo: int = 0):
    """Windowed (zero-padded 'same') box sums by summed-area tables: per
    axis, a cumsum over the padded stack (one extra leading zero for
    S[i-1]) and the difference of two shifted slices, in float32 at least.
    ``halo``: as ``_local_sums``'s, D then padded by the leading zero
    alone."""
    nd = I.ndim - 2
    stack = _stack(I, J)
    stack = stack.to(torch.promote_types(stack.dtype, torch.float32))
    for axis, k in zip(range(2, 2 + nd), win):
        pads = [0] * (2 * (stack.ndim - axis))
        n = I.shape[axis]
        if axis == 2 and halo:
            pads[-2:] = [1, 0]
            n -= 2 * halo
        else:
            pads[-2:] = [k // 2 + 1, k - 1 - k // 2]
        s = torch.cumsum(F.pad(stack, pads), dim=axis)
        stack = s.narrow(axis, k, n) - s.narrow(axis, 0, n)
    return stack.split(I.shape[1], dim=1)


def ncc_map(prediction, target, kernel_var=None, kernel_type="mean",
            eps: float = 1e-5, method: str = "auto", mesh=None):
    """Pointwise windowed-NCC map ``cc = cross^2 / (I_var * J_var + eps)``.

    method: 'conv' (depthwise window conv), 'integral' (summed-area tables,
    mean window only), or 'auto' (integral for an odd mean window).
    ``mesh`` splitting the volumes along D: this rank's slab of the map."""
    nd = prediction.ndim - 2
    if kernel_var is None:
        kernel_var = [3] * nd if kernel_type == "gaussian" else [9] * nd
    if method == "auto":
        method = ("integral" if kernel_type == "mean"
                  and all(k % 2 == 1 for k in kernel_var) else "conv")
    filt = (None if method == "integral"
            else _window_kernel(kernel_type, kernel_var, nd))
    halo = 0
    if is_spatial(mesh):
        k = kernel_var[0] if filt is None else filt.shape[0]
        if k % 2 == 0 or (filt is not None and len(set(filt.shape)) > 1):
            raise ValueError(f"NCC on slabs takes an odd cubic window, got "
                             f"{kernel_var}")
        halo = k // 2
        both = halo_exchange(torch.cat([prediction, target], dim=1), halo,
                             halo, mesh)
        prediction, target = both.split(prediction.shape[1], dim=1)
    if method == "integral":
        if kernel_type != "mean":
            raise ValueError("integral method requires a mean kernel")
        sums = _local_sums_integral(prediction, target, kernel_var, halo)
        win_size = float(np.prod(kernel_var))
    else:
        sums = _local_sums(prediction, target, filt, halo)
        win_size = float(filt.sum())
    I_sum, J_sum, I2_sum, J2_sum, IJ_sum = sums
    u_I = I_sum / win_size
    u_J = J_sum / win_size
    cross = IJ_sum - u_J * I_sum - u_I * J_sum + u_I * u_J * win_size
    I_var = I2_sum - 2 * u_I * I_sum + u_I * u_I * win_size
    J_var = J2_sum - 2 * u_J * J_sum + u_J * u_J * win_size
    return cross * cross / (I_var * J_var + eps)


def ncc_loss(prediction, target, mask=None, kernel_var=None,
             kernel_type="mean", eps: float = 1e-5, method: str = "auto",
             mesh=None):
    """``-sqrt(mean(cc))``, over ``mask`` where one is given (0 for an
    empty mask)."""
    cc = ncc_map(prediction, target, kernel_var, kernel_type, eps, method,
                 mesh)
    if mask is None:
        return -1.0 * torch.sqrt(global_mean(cc.mean(), mesh))
    mask = mask.to(cc.dtype)
    denom = global_sum(mask.sum(), mesh)
    val = -1.0 * torch.sqrt(global_sum((cc * mask).sum(), mesh)
                            / denom.clamp_min(1.0))
    return torch.where(denom == 0, torch.zeros_like(val), val)


def tukey_biweight(prediction, target, c: float = 0.8, mask=None):
    """Tukey's biweight of the error, clamped to [0, c^2 / 6]."""
    max_loss = c ** 2 / 6.0
    loss = max_loss * (1.0 - (1.0 - ((prediction - target) / c).square())
                       ** 3)
    return _masked_mean(loss.clamp(0.0, max_loss), mask)


def _class_mask(mask, ce):
    """A (B, 1, ...) mask of a (B, ...) per-pixel loss as (B, ...)."""
    if mask is not None and mask.ndim == ce.ndim + 1:
        mask = mask.squeeze(1)
    return mask


def cross_entropy_loss(logits, target_onehot, mask=None):
    """Softmax cross entropy over the class axis, dim 1."""
    ce = -(target_onehot * torch.log_softmax(logits, dim=1)).sum(dim=1)
    return _masked_mean(ce, _class_mask(mask, ce))


def nll_loss(log_probs, target_onehot, mask=None):
    """Negative log likelihood of log-probabilities over dim 1."""
    ce = -(target_onehot * log_probs).sum(dim=1)
    return _masked_mean(ce, _class_mask(mask, ce))


def dice_loss(prediction, target, eps: float = 1e-5):
    """Soft Dice over the spatial dims; returns 1 - mean Dice."""
    dims = tuple(range(2, prediction.ndim))
    inter = (prediction * target).sum(dim=dims)
    denom = prediction.sum(dim=dims) + target.sum(dim=dims)
    return 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()


def nmi_loss(prediction, target, num_bins: int = 32, vmin: float = -1.0,
             vmax: float = 1.0, sigma_ratio: float = 0.5):
    """Negative global mutual information via Parzen windowing."""
    centers = torch.linspace(vmin, vmax, num_bins, dtype=prediction.dtype,
                             device=prediction.device)
    sigma = (centers[1] - centers[0]) * sigma_ratio
    preterm = 1.0 / (2 * sigma ** 2)

    def soft_bin(x):
        x = x.reshape(x.shape[0], -1, 1)
        w = torch.exp(-preterm * (x - centers.reshape(1, 1, -1)).square())
        return w / (w.sum(dim=-1, keepdim=True) + 1e-10)

    pa = soft_bin(prediction)                       # (B, N, bins)
    pb = soft_bin(target)
    pab = torch.bmm(pa.transpose(1, 2), pb) / pa.shape[1]
    papb = pa.mean(dim=1)[:, :, None] * pb.mean(dim=1)[:, None, :]
    mi = (pab * torch.log((pab + 1e-10) / (papb + 1e-10))).sum(dim=(1, 2))
    return -mi.mean()
