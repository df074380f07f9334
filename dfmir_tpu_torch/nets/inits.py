"""Weight initialisers with the reference's init_weights semantics, plus
torch's default conv init, drawing from an explicit ``torch.Generator``.

Fans follow the kernel's roles, as in the JAX package: fan_in =
in_channels * prod(kernel), fan_out = out_channels * prod(kernel), for a
conv ``(out, in, *k)`` and a transposed conv ``(in, out, *k)`` alike.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal", "torch_default")


def _fans(module):
    w = module.weight
    rf = math.prod(w.shape[2:])
    if isinstance(module, nn.modules.conv._ConvTransposeNd):
        c_in, c_out = w.shape[0], w.shape[1]
    else:
        c_out, c_in = w.shape[0], w.shape[1]
    return c_in * rf, c_out * rf


@torch.no_grad()
def init_conv_(module, init_type: str, init_gain: float,
               generator: torch.Generator):
    """Initialise a conv's weight by ``init_type`` (the reference's
    --init_type) and its bias: zeros, or U(+-1/sqrt(fan_in)) for
    ``torch_default``.  The module must lie on the generator's device."""
    w = module.weight
    fan_in, fan_out = _fans(module)
    if init_type == "normal":
        w.normal_(0.0, init_gain, generator=generator)
    elif init_type == "xavier":
        w.normal_(0.0, init_gain * math.sqrt(2.0 / (fan_in + fan_out)),
                  generator=generator)
    elif init_type == "kaiming":
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    elif init_type == "orthogonal":
        nn.init.orthogonal_(w, gain=init_gain, generator=generator)
    elif init_type == "torch_default":
        bound = 1.0 / math.sqrt(fan_in)
        w.uniform_(-bound, bound, generator=generator)
    else:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    if module.bias is not None:
        if init_type == "torch_default":
            module.bias.uniform_(-bound, bound, generator=generator)
        else:
            module.bias.zero_()


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at 2 standard
    deviations, of variance 1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)
