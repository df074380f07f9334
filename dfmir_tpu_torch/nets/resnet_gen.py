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

Dropout (``use_dropout``, the reference's ``--no_dropout false``) sits
after the first conv-norm-relu of each ResnetBlock.  It is active only in
a ``train=True`` forward, and its masks come from the explicit
``generator`` given there (a generator on the activations' device), not
from torch's global RNG.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from dfmir_tpu_torch.nets.layers import (BlurDown, BlurUp, Pad, conv_nd,
                                         conv_transpose_nd, norm_layer)


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
    Sequential indices."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if generator is None:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device,
                          dtype=torch.float32) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class ResnetBlock(nn.Module):
    """pad-conv-norm-relu-[dropout]-pad-conv-norm with a residual skip;
    ``conv_block`` indices are the reference's."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "instance", use_dropout: bool = False,
                 use_bias: bool = True, init_type: str = "xavier",
                 init_gain: float = 0.02, *, generator: torch.Generator):
        super().__init__()
        p = 1 if padding_type == "zero" else 0

        def conv():
            return conv_nd(dim, dim, 3, 1, p, use_bias, init_type=init_type,
                           init_gain=init_gain, generator=generator)

        def pad():
            return [Pad(1, padding_type)] if p == 0 else []

        layers = pad() + [conv(), norm_layer(norm), nn.ReLU()]
        if use_dropout:
            layers.append(Dropout(0.5))
        layers += pad() + [conv(), norm_layer(norm)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        """``generator``: the dropout masks' source; None runs without
        dropout."""
        h = x
        for op in self.conv_block:
            h = op(h, generator) if isinstance(op, Dropout) else op(h)
        return x + h


class ResnetGenerator(nn.Module):
    def __init__(self, input_nc: int = 1, output_nc: int = 1, ngf: int = 64,
                 n_blocks: int = 9, norm: str = "instance",
                 use_dropout: bool = False, no_antialias: bool = False,
                 no_antialias_up: bool = False, padding_type: str = "reflect",
                 init_type: str = "xavier", init_gain: float = 0.02, *,
                 generator: torch.Generator):
        super().__init__()
        self.specs = resnet_generator_specs(input_nc, output_nc, ngf, n_blocks,
                                            no_antialias, no_antialias_up)
        self.use_dropout = use_dropout
        use_bias = norm == "instance"
        init = dict(init_type=init_type, init_gain=init_gain,
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
                op = BlurDown(ch)
            elif kind == "blur_up":
                op = BlurUp(ch)
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

    def forward(self, x, layers: Tuple[int, ...] = (), encode_only: bool = False,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Forward; with ``layers`` (Sequential indices) also returns the
        tapped activations: ``encode_only`` stops after ``layers[-1]`` and
        returns the feature list, otherwise ``(output, feats)``; with no
        layers, the output alone.  ``-1`` taps the output.

        ``train``: dropout active (where the net has it), its masks drawn
        from ``generator``, which must then be given."""
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
        feats = []
        h = x
        for i, op in enumerate(self.model):
            h = op(h, generator) if isinstance(op, ResnetBlock) else op(h)
            if i in layers:
                feats.append(h)
            if layers and encode_only and i == layers[-1]:
                return feats
        return (h, feats) if layers else h
