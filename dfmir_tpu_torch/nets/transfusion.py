"""The transformer-fusion registration nets (the JAX package's
``nets/transfusion.py``): ``--netR vxm_transformer`` (``fuse="gpt"``) and
``vxm_dual`` (``fuse="none"``).

One strided-conv encoder a modality.  At the levels that fuse, both
streams are average-pooled to an ``anchors`` x ``anchors`` token grid, the
tokens are fused (a joint GPT over both streams' tokens, or cross
attention), resized back to the level's size and added.  The decoder is
VxmDense's, on the concatenated pairs of skips.  Then the flow head, the
half-resolution scaling and squaring and the warps, as the port's
VxmDense runs them: pos and neg integrate as one batch-stacked ``vecint``
call (every op of the chain is per item), and ``registration=True``
computes the pos chain and ``y_source`` alone (JAX returns only those).

Numerics are flax's: LayerNorm with eps 1e-6; attention with
``query`` / ``key`` / ``value`` projections to (heads, C / heads), logits
scaled by 1/sqrt(C / heads), a float32 softmax and an ``out`` projection
(each an ``nn.Linear`` here, over the flattened heads); the token resize
is ``jax.image.resize(..., "bilinear")``, which is antialiased when it
shrinks (``resize_weights``).  Module and parameter names are flax's
(``fusion_<i>.block_<j>.MultiHeadDotProductAttention_0.query``, ...);
the convs are the port's ``VxmConvBlock`` (``down_x_<i>.main``).

JAX cannot run this module at ``ndims=3`` (its pooling unpacks four
dims), so neither does the port.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.feature_nets import adaptive_pool
from dfmir_tpu_torch.nets.layers import conv_nd, upsample_nearest
from dfmir_tpu_torch.nets.vxm import VxmConvBlock
from dfmir_tpu_torch.ops.integrate import resize_flow, vecint
from dfmir_tpu_torch.ops.warp import warp

FUSE_MODES = ("gpt", "bottleneck", "cross", "none")
LN_EPS = 1e-6


def adaptive_avg_pool(x, out: int):
    """(B, C, H, W) -> (B, C, out, out), torch's bins."""
    B, C, H, W = x.shape
    if H % out == 0 and W % out == 0:
        return x.reshape(B, C, out, H // out, out, W // out).mean(dim=(3, 5))
    return adaptive_pool(x, out, "mean")


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize``'s bilinear (triangle)
    kernel along one axis, antialiased: when shrinking, the kernel is
    widened by n_in / n_out.  Half-pixel centres, each row normalised."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return torch.from_numpy(w.T.astype(np.float32))


def bilinear_resize(x, h: int, w: int):
    """(B, C, H, W) -> (B, C, h, w), ``jax.image.resize(..., "bilinear")``."""
    for axis, n_out in ((2, h), (3, w)):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        M = resize_weights(n_in, n_out).to(x.device, x.dtype)
        x = (x.movedim(axis, -1) @ M.T).movedim(-1, axis)
    return x


def _dense(c_in: int, c_out: int, generator: torch.Generator) -> nn.Linear:
    """An nn.Linear initialised as the JAX module's: N(0, 0.02) weights,
    zero bias."""
    lin = skip_init(nn.Linear, c_in, c_out)
    with torch.no_grad():
        lin.weight.normal_(0.0, 0.02, generator=generator)
        lin.bias.zero_()
    return lin


def layer_norm(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=LN_EPS)


class MultiHeadDotProductAttention(nn.Module):
    """flax's MultiHeadDotProductAttention(num_heads, qkv_features=C)."""

    def __init__(self, c: int, n_head: int, *, generator: torch.Generator):
        super().__init__()
        if c % n_head:
            raise ValueError(f"{c} features do not split into {n_head} heads")
        self.n_head = n_head
        self.query = _dense(c, c, generator)
        self.key = _dense(c, c, generator)
        self.value = _dense(c, c, generator)
        self.out = _dense(c, c, generator)

    def forward(self, q_in, kv_in):
        B, Tq, C = q_in.shape
        d = C // self.n_head

        def heads(t):
            return t.reshape(B, -1, self.n_head, d).transpose(1, 2)

        q = heads(self.query(q_in)) / math.sqrt(d)
        k, v = heads(self.key(kv_in)), heads(self.value(kv_in))
        logits = q @ k.transpose(-1, -2)                   # (B, h, Tq, Tk)
        attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, Tq, C)
        return self.out(out)


class TransformerBlock(nn.Module):
    """Pre-LN self-attention + MLP."""

    def __init__(self, c: int, n_head: int = 4, block_exp: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.LayerNorm_0 = layer_norm(c)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            c, n_head, generator=generator)
        self.LayerNorm_1 = layer_norm(c)
        self.Dense_0 = _dense(c, c * block_exp, generator)
        self.Dense_1 = _dense(c * block_exp, c, generator)

    def forward(self, tokens):
        h = self.LayerNorm_0(tokens)
        tokens = tokens + self.MultiHeadDotProductAttention_0(h, h)
        h = self.Dense_1(torch.relu(self.Dense_0(self.LayerNorm_1(tokens))))
        return tokens + h


def _tokens(x):
    """(B, C, P, P) -> (B, P * P, C), JAX's row order."""
    return x.flatten(2).transpose(1, 2)


def _grid(t, P: int):
    """(B, P * P, C) -> (B, C, P, P)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], P, P)


class GPTFusion(nn.Module):
    """A joint transformer over both streams' pooled tokens."""

    def __init__(self, c: int, n_head: int = 4, n_layer: int = 8,
                 block_exp: int = 4, anchors: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_layer = n_layer
        self.pos_emb = nn.Parameter(torch.zeros(1, 2 * anchors * anchors, c))
        for i in range(n_layer):
            setattr(self, f"block_{i}", TransformerBlock(
                c, n_head, block_exp, generator=generator))
        self.ln_f = layer_norm(c)

    def forward(self, xa, xb):
        P = xa.shape[2]
        tok = torch.cat([_tokens(xa), _tokens(xb)], dim=1) + self.pos_emb
        for i in range(self.n_layer):
            tok = getattr(self, f"block_{i}")(tok)
        tok = self.ln_f(tok)
        n = P * P
        return _grid(tok[:, :n], P), _grid(tok[:, n:], P)


class CrossAttentionFusion(nn.Module):
    """Each stream attends over the other's tokens; residual add."""

    def __init__(self, c: int, n_head: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        self.a_from_b = MultiHeadDotProductAttention(c, n_head,
                                                     generator=generator)
        self.b_from_a = MultiHeadDotProductAttention(c, n_head,
                                                     generator=generator)
        for i in range(4):
            setattr(self, f"LayerNorm_{i}", layer_norm(c))

    def forward(self, ta, tb):
        P = ta.shape[2]
        qa, qb = _tokens(ta), _tokens(tb)
        fa = qa + self.a_from_b(self.LayerNorm_0(qa), self.LayerNorm_1(qb))
        fb = qb + self.b_from_a(self.LayerNorm_2(qb), self.LayerNorm_3(qa))
        return _grid(fa, P), _grid(fb, P)


class TransFusionUnet(nn.Module):
    """The dual-encoder UNet with token fusion.  fuse: 'gpt' at every
    level, 'bottleneck' at the deepest, 'cross' attention at every level,
    'none' (plain dual encoders)."""

    def __init__(self, enc_nf: Sequence[int] = (16, 32, 32, 64, 64, 64),
                 dec_nf: Sequence[int] = (64, 64, 64, 32, 32, 32, 16),
                 n_head: int = 4, n_layer: int = 8, anchors: int = 8,
                 fuse: str = "gpt", in_ch: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        if fuse not in FUSE_MODES:
            raise ValueError(f"unknown fuse mode {fuse!r}")
        self.fuse, self.anchors = fuse, anchors
        self.n_enc = n_enc = len(enc_nf)
        block = dict(generator=generator)
        self.fused = []
        prev = in_ch
        for i, nf in enumerate(enc_nf):
            setattr(self, f"down_x_{i}", VxmConvBlock(prev, nf, 2, **block))
            setattr(self, f"down_y_{i}", VxmConvBlock(prev, nf, 2, **block))
            here = (fuse in ("gpt", "cross")
                    or (fuse == "bottleneck" and i == n_enc - 1))
            if here:
                fusion = (CrossAttentionFusion(nf, n_head, **block)
                          if fuse == "cross" else
                          GPTFusion(nf, n_head, n_layer, anchors=anchors,
                                    **block))
                setattr(self, f"fusion_{i}", fusion)
            self.fused.append(here)
            prev = nf
        skips = [2 * in_ch] + [2 * nf for nf in enc_nf[:-1]]
        prev = 2 * enc_nf[-1]
        self.n_up = len(dec_nf[:n_enc])
        for i, nf in enumerate(dec_nf[:n_enc]):
            setattr(self, f"up_{i}", VxmConvBlock(prev, nf, **block))
            prev = nf + skips.pop()
        self.n_extra = len(dec_nf) - n_enc
        for i, nf in enumerate(dec_nf[n_enc:]):
            setattr(self, f"extra_{i}", VxmConvBlock(prev, nf, **block))
            prev = nf
        self.out_channels = prev

    def forward(self, x, y):
        skips = [torch.cat([x, y], dim=1)]
        hx, hy = x, y
        for i in range(self.n_enc):
            hx = getattr(self, f"down_x_{i}")(hx)
            hy = getattr(self, f"down_y_{i}")(hy)
            if self.fused[i]:
                ta = adaptive_avg_pool(hx, self.anchors)
                tb = adaptive_avg_pool(hy, self.anchors)
                fa, fb = getattr(self, f"fusion_{i}")(ta, tb)
                H, W = hx.shape[2:]
                hx = hx + bilinear_resize(fa, H, W)
                hy = hy + bilinear_resize(fb, H, W)
            skips.append(torch.cat([hx, hy], dim=1))
        h = skips.pop()
        for i in range(self.n_up):
            h = upsample_nearest(getattr(self, f"up_{i}")(h))
            h = torch.cat([h, skips.pop()], dim=1)
        for i in range(self.n_extra):
            h = getattr(self, f"extra_{i}")(h)
        return h


class VxmDenseTransformer(nn.Module):
    """TransFusionUnet -> flow head -> half-resolution scaling and squaring
    -> the warps.  Returns what the port's VxmDense returns: (y_source,
    y_target, pos_flow) bidir, (y_source, pos_flow) with
    ``registration=True``, (y_source, preint_flow) unidir."""

    def __init__(self, ndims: int = 2,
                 nb_features: Tuple[Sequence[int], Sequence[int]] = (
                     (16, 32, 32, 64, 64, 64), (64, 64, 64, 32, 32, 32, 16)),
                 int_steps: int = 7, int_downsize: int = 2, bidir: bool = True,
                 fuse: str = "gpt", n_head: int = 4, n_layer: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        if ndims != 2:
            raise NotImplementedError(
                f"the transformer-fusion netR at ndims={ndims}: the JAX "
                f"package cannot run it there (its token pooling unpacks "
                f"four dims), so there is nothing to port")
        enc_nf, dec_nf = nb_features
        self.int_steps, self.int_downsize, self.bidir = (int_steps,
                                                         int_downsize, bidir)
        self.unet = TransFusionUnet(tuple(enc_nf), tuple(dec_nf), n_head,
                                    n_layer, fuse=fuse, generator=generator)
        self.flow = conv_nd(self.unet.out_channels, ndims, 3, 1, 1, True,
                            init_type="normal", init_gain=1e-5,
                            generator=generator)

    def forward(self, source, target, registration: bool = False):
        flow_field = self.flow(self.unet(source, target))
        do_resize = self.int_steps > 0 and self.int_downsize > 1
        pos_flow = flow_field
        if do_resize:
            pos_flow = resize_flow(pos_flow, 1.0 / self.int_downsize)
        preint_flow = pos_flow
        if self.bidir and not registration:
            b = source.shape[0]
            both = torch.cat([pos_flow, -pos_flow], dim=0)
            if self.int_steps > 0:
                both = vecint(both, self.int_steps)
                if do_resize:
                    both = resize_flow(both, float(self.int_downsize))
            warped = warp(torch.cat([source, target], dim=0), both)
            return warped[:b], warped[b:], both[:b]
        if self.int_steps > 0:
            pos_flow = vecint(pos_flow, self.int_steps)
            if do_resize:
                pos_flow = resize_flow(pos_flow, float(self.int_downsize))
        y_source = warp(source, pos_flow)
        if registration:
            return y_source, pos_flow
        return y_source, preint_flow


def VxmDenseDual(**kwargs):
    """The dual-encoder VxmDense without token fusion."""
    kwargs.setdefault("fuse", "none")
    return VxmDenseTransformer(**kwargs)
