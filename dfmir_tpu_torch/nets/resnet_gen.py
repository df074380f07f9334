"""CUT-style ResNet generator with indexed feature taps.

``model`` is an nn.Sequential whose indices are the reference
ResnetGenerator's, so the state_dict keys are the reference's
(``model.<i>.weight``) and ``layers=(0, 4, 8, 12, 16)`` taps the same
activations.  Default indexing (resnet_9blocks, antialias on):

  0 pad3 | 1 conv7(ngf) | 2 norm | 3 relu
  4 conv3(2ngf) | 5 norm | 6 relu | 7 blur_down
  8 conv3(4ngf) | 9 norm | 10 relu | 11 blur_down
  12..20 resblock(4ngf) x9
  21 blur_up | 22 conv3(2ngf) | 23 norm | 24 relu
  25 blur_up | 26 conv3(ngf) | 27 norm | 28 relu
  29 pad3 | 30 conv7(output_nc) | 31 tanh

``ndims`` (2 or 3) is the rank of the maps: every conv, transposed conv
and blur is built for it (the JAX modules infer it from their input), so
the 3-D joint model takes (B, C, D, H, W) volumes.

Dropout (``use_dropout``, the reference's ``--no_dropout false``) sits
after the first conv-norm-relu of each ResnetBlock.  It is active only in
a ``train=True`` forward, and its masks come from the explicit
``generator`` given there (a generator on the activations' device), not
from torch's global RNG.

On slabs (``mesh`` splitting the first spatial axis over ranks,
``parallel/mesh.py``) each op runs its slab form: a pad takes a halo and
pads at the global ends only (``nets/layers.py::pad_nd``), so the
unpadded conv after it runs as it is; a zero-padded conv takes a halo
(``conv_slab``); the norms take the whole image's statistics; the blurs
their halos.  A tap of a pad's output (tap 0) is cut to the rows this
rank owns: its slab's, and at a global end the pad's rows too, so that
the ranks' taps lie end to end along the split axis
(``parallel.mesh.slab_rows``).  A transposed conv (``no_antialias_up``)
takes one row of halo above and cuts its output to the slab's rows
(``conv_transpose_slab``).  Dropout draws the whole map's mask from the
generator on every spatial rank, which keeps its own rows: the ranks of
one data rank, each given the same generator state, hold one process's
masks bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dfmir_tpu_torch.nets.layers import (BlurDown, BlurUp, InstanceNorm, Pad,
                                         conv_nd, conv_slab,
                                         conv_transpose_nd,
                                         conv_transpose_slab, norm_layer)
from dfmir_tpu_torch.parallel.mesh import is_spatial


def resnet_generator_specs(
    input_nc: int = 1,
    output_nc: int = 1,
    ngf: int = 64,
    n_blocks: int = 9,
    no_antialias: bool = False,
    no_antialias_up: bool = False,
) -> List[Dict[str, Any]]:
    """Op list with the reference Sequential's indices.

    Each spec: {'kind', 'channels' (output channel count), ...kind args}.
    """
    specs: List[Dict[str, Any]] = []

    def add(kind, channels, **kw):
        specs.append(dict(kind=kind, channels=channels, **kw))

    add("pad", input_nc, pad=3)
    add("conv", ngf, kernel=7, stride=1, padding=0)
    add("norm", ngf)
    add("relu", ngf)
    n_down = 2
    for i in range(n_down):
        mult = 2 ** i
        if no_antialias:
            add("conv", ngf * mult * 2, kernel=3, stride=2, padding=1)
            add("norm", ngf * mult * 2)
            add("relu", ngf * mult * 2)
        else:
            add("conv", ngf * mult * 2, kernel=3, stride=1, padding=1)
            add("norm", ngf * mult * 2)
            add("relu", ngf * mult * 2)
            add("blur_down", ngf * mult * 2)
    mult = 2 ** n_down
    for _ in range(n_blocks):
        add("resblock", ngf * mult)
    for i in range(n_down):
        mult = 2 ** (n_down - i)
        if no_antialias_up:
            add("convT", ngf * mult // 2, kernel=3, stride=2, padding=1,
                output_padding=1)
            add("norm", ngf * mult // 2)
            add("relu", ngf * mult // 2)
        else:
            add("blur_up", ngf * mult)
            add("conv", ngf * mult // 2, kernel=3, stride=1, padding=1)
            add("norm", ngf * mult // 2)
            add("relu", ngf * mult // 2)
    add("pad", ngf, pad=3)
    add("conv", output_nc, kernel=7, stride=1, padding=0, final=True)
    add("tanh", output_nc)
    return specs


def _on_slab(op: nn.Module, h, mesh):
    """One op of the generator (or a ResnetBlock's conv block) on this
    rank's slab ``h``."""
    if isinstance(op, (Pad, InstanceNorm, BlurDown, BlurUp)):
        return op(h, mesh)
    if isinstance(op, (nn.Conv2d, nn.Conv3d)):
        # an unpadded conv follows a pad, which took its halo
        return conv_slab(op, h, mesh) if op.padding[0] else op(h)
    if isinstance(op, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        return conv_transpose_slab(op, h, mesh)
    return op(h)


def nce_feature_dims(nce_layers: Sequence[int], **gen_kwargs) -> List[int]:
    """Channel count of each tapped activation (feeds PatchSampleF MLPs)."""
    specs = resnet_generator_specs(**gen_kwargs)
    return [specs[l]["channels"] if l < len(specs) else specs[-1]["channels"]
            for l in nce_layers]


class Dropout(nn.Module):
    """Dropout at ``rate`` whose masks come from an explicit generator:
    each element is kept with probability 1 - rate and scaled by
    1 / (1 - rate) (exactly 2 at the reference's 0.5), as flax's
    ``nn.Dropout`` does.  Parameterless, so it keeps the reference's
    Sequential indices.  On slabs (``mesh`` splitting axis 2) ``x`` is
    this rank's slab, and the mask is the whole map's, drawn as one process
    draws it, cut to the slab's rows."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None,
                mesh=None):
        if generator is None:
            return x
        shape = list(x.shape)
        if is_spatial(mesh):
            shape[2] *= mesh.n_spatial
        keep = torch.rand(shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.rate
        if is_spatial(mesh):
            keep = keep.narrow(2, mesh.spatial_rank * x.shape[2], x.shape[2])
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class ResnetBlock(nn.Module):
    """pad-conv-norm-relu-[dropout]-pad-conv-norm with a residual skip;
    ``conv_block`` indices are the reference's."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True, init_type: str = "xavier",
                 init_gain: float = 0.02, ndims: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        p = 1 if padding_type == "zero" else 0

        def conv():
            return conv_nd(dim, dim, 3, 1, p, use_bias, init_type=init_type,
                           init_gain=init_gain, ndims=ndims,
                           generator=generator)

        def pad():
            return [Pad(1, padding_type)] if p == 0 else []

        layers = pad() + [conv(), norm_layer(norm), nn.ReLU()]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += pad() + [conv(), norm_layer(norm)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                mesh=None):
        """``generator``: the dropout masks' source; None runs without
        dropout.  ``mesh``: ``x`` is this rank's slab."""
        h = x
        for op in self.conv_block:
            if isinstance(op, Dropout):
                h = op(h, generator, mesh)
            else:
                h = _on_slab(op, h, mesh) if is_spatial(mesh) else op(h)
        return x + h


def _owned(h, pad: int, mesh):
    """The rows of a pad's output on a slab (the slab and ``pad`` rows of
    halo each side) that this rank owns: its slab's, and the pad's at a
    global end."""
    lo = 0 if mesh.spatial_rank == 0 else pad
    hi = 0 if mesh.spatial_rank == mesh.n_spatial - 1 else pad
    return h.narrow(2, lo, h.shape[2] - lo - hi)


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "instance",
                 use_dropout: bool = False, no_antialias: bool = False,
                 no_antialias_up: bool = False, padding_type: str = "reflect",
                 init_type: str = "xavier", init_gain: float = 0.02,
                 ndims: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.specs = resnet_generator_specs(input_nc, output_nc, ngf, n_blocks,
                                            no_antialias, no_antialias_up)
        self.use_dropout = use_dropout
        self.padding_type = padding_type
        use_bias = norm == "instance"
        init = dict(init_type=init_type, init_gain=init_gain, ndims=ndims,
                    generator=generator)
        ops = []
        ch = input_nc
        for s in self.specs:
            kind = s["kind"]
            if kind == "pad":
                op = Pad(s["pad"], padding_type)
            elif kind == "conv":
                bias = True if s.get("final") else use_bias
                op = conv_nd(ch, s["channels"], s["kernel"], s["stride"],
                             s["padding"], bias, **init)
            elif kind == "convT":
                op = conv_transpose_nd(ch, s["channels"], s["kernel"],
                                       s["stride"], s["padding"],
                                       s["output_padding"], use_bias, **init)
            elif kind == "norm":
                op = norm_layer(norm)
            elif kind == "relu":
                op = nn.ReLU()
            elif kind == "blur_down":
                op = BlurDown(ch, ndims=ndims)
            elif kind == "blur_up":
                op = BlurUp(ch, ndims=ndims)
            elif kind == "resblock":
                op = ResnetBlock(ch, padding_type, norm, use_dropout, use_bias,
                                 **init)
            elif kind == "tanh":
                op = nn.Tanh()
            else:
                raise ValueError(kind)
            ops.append(op)
            ch = s["channels"]
        self.model = nn.Sequential(*ops)

    def slab_level_pads(self) -> List[int]:
        """The largest reflect or replicate pad at each level of the
        generator (level l: after l downsamplings), the rows a slab must
        exceed there (``parallel.mesh.check_joint_slabs``)."""
        pads: Dict[int, int] = {}
        level = 0
        for s in self.specs:
            kind = s["kind"]
            p = {"pad": s.get("pad", 0), "blur_down": 1, "blur_up": 1,
                 "resblock": int(self.padding_type != "zero")}.get(kind, 0)
            pads[level] = max(pads.get(level, 0), p)
            if kind == "blur_down" or (kind == "conv" and s["stride"] == 2):
                level += 1
            elif kind in ("blur_up", "convT"):
                level -= 1
        return [pads.get(level, 0) for level in range(max(pads) + 1)]

    def tap_pads(self, layers: Sequence[int]) -> List[int]:
        """The rows a pad's output tap carries past each global end (0
        for every other tap), as ``forward`` on slabs returns the taps."""
        return [self.specs[l].get("pad", 0)
                if 0 <= l < len(self.specs) and self.specs[l]["kind"] == "pad"
                else 0 for l in layers]

    def forward(self, x, layers: Tuple[int, ...] = (), encode_only: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None):
        """Forward; with ``layers`` (Sequential indices) also returns the
        tapped activations: ``encode_only`` stops after ``layers[-1]`` and
        returns the feature list, otherwise ``(output, feats)``; with no
        layers, the output alone.  ``-1`` taps the output.

        ``train``: dropout active (where the net has it), its masks drawn
        from ``generator``, which must then be given.  ``mesh`` splitting
        the image: ``x`` and the output are this rank's slabs, and each tap
        its rows (a pad's output cut to the rows this rank owns)."""
        layers = tuple(layers)
        if not (train and self.use_dropout):
            generator = None
        elif generator is None:
            raise ValueError("a train=True forward with dropout needs a "
                             "generator for its masks")
        n = len(self.specs)
        if -1 in layers:
            layers = tuple(l for l in layers if l != -1) + (n,)
        bad = [l for l in layers if l < 0 or l > n]
        if bad:
            raise ValueError(
                f"nce_layers {bad} out of range for this generator "
                f"({n} sequential ops); the reference silently drops such "
                f"taps — here that is a loud error")
        spatial = is_spatial(mesh)
        feats = []
        h = x
        for i, op in enumerate(self.model):
            if isinstance(op, ResnetBlock):
                h = op(h, generator, mesh)
            else:
                h = _on_slab(op, h, mesh) if spatial else op(h)
            if i in layers:
                feats.append(_owned(h, op.pad, mesh)
                             if spatial and isinstance(op, Pad) else h)
            if layers and encode_only and i == layers[-1]:
                return feats
        return (h, feats) if layers else h
