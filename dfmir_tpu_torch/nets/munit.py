"""The MUNIT-style content/style generator family (the JAX package's
``nets/munit.py``): ``--netG resnet_cat`` is ``GResnet(nz=0)``, a content
encoder and a decoder, with the encoder's ops as NCE taps.

``Conv2dBlock`` is pad -> VALID conv (bias) -> norm -> activation.  Its
``"ln"`` norm is flax's LayerNorm over the channels alone (eps 1e-6, a
scale and a bias a channel), as the JAX package has it, not MUNIT's layer
norm over (C, H, W).  Convs and linear layers start from flax's default
init (LeCun normal, zero bias).  Module names are flax's, auto-generated
ones included (``Conv2dBlock_0``, ``Conv_0``, ``LayerNorm_0``), so a JAX
tree converts by name (``compat/convert.py``).

On slabs (``mesh`` splitting H over ranks, ``parallel/mesh.py``) the
content encoder and the decoder run on this rank's rows: a block's pad
takes a halo and pads at the image's ends alone (``nets/layers.py::
pad_nd``), which leaves each rank the window of the padded map that its
VALID conv reads for its own output rows (k - stride = 2 * pad for every
block of ``resnet_cat``: the 7x7, 3x3 and 5x5 convs at stride 1, the 4x4
ones at stride 2); the instance norms take the whole map's statistics
(``instance_norm``'s mesh); the channel LayerNorm, the activations and
the nearest upsampling are per pixel and run on the slab as they are,
and so does the decoder's fold of a style vector (``nz > 0``: one vector
an image, a 1x1 block).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from dfmir_tpu_torch.nets.inits import lecun_normal_
from dfmir_tpu_torch.nets.layers import instance_norm, pad_nd, upsample_nearest
from dfmir_tpu_torch.parallel.mesh import is_spatial

ACTS = {"none": lambda x: x, None: lambda x: x, "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.2), "tanh": torch.tanh}


def _flax_conv(c_in: int, c_out: int, k: int, stride: int,
               generator: torch.Generator) -> nn.Conv2d:
    conv = skip_init(nn.Conv2d, c_in, c_out, k, stride=stride)
    lecun_normal_(conv.weight, c_in * k * k, generator)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


def _flax_dense(c_in: int, c_out: int,
                generator: torch.Generator) -> nn.Linear:
    lin = skip_init(nn.Linear, c_in, c_out)
    lecun_normal_(lin.weight, c_in, generator)
    with torch.no_grad():
        lin.bias.zero_()
    return lin


class ChannelLayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm()`` on an NHWC map: over the channels alone,
    in float32 at least (flax's reductions and affine are float32 for a
    bfloat16 input), the result in the input's dtype."""

    def __init__(self, c: int):
        super().__init__(c, eps=1e-6)

    def forward(self, x):
        f = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.movedim(1, -1).to(f), self.normalized_shape,
                            self.weight.to(f), self.bias.to(f),
                            self.eps).movedim(-1, 1).to(x.dtype)


class Conv2dBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int = 0, norm: str = "none",
                 activation: str = "relu", pad_type: str = "reflect", *,
                 generator: torch.Generator):
        super().__init__()
        if norm not in ("none", None, "instance", "in", "ln", "layer"):
            raise NotImplementedError(f"norm {norm}")
        if activation not in ACTS:
            raise NotImplementedError(f"activation {activation}")
        self.padding, self.pad_type = padding, pad_type
        self.norm, self.activation = norm, activation
        self.Conv_0 = _flax_conv(in_ch, features, kernel, stride, generator)
        if norm in ("ln", "layer"):
            self.LayerNorm_0 = ChannelLayerNorm(features)

    @property
    def stride(self) -> int:
        return self.Conv_0.stride[0]

    def forward(self, x, mesh=None):
        """``mesh`` splitting H: ``x`` is this rank's slab, and the output
        its rows of the whole map's."""
        if is_spatial(mesh):
            k = self.Conv_0.kernel_size[0]
            if k - self.stride != 2 * self.padding:
                raise NotImplementedError(
                    f"Conv2dBlock on slabs: a {k}x{k} conv at stride "
                    f"{self.stride} after a pad of {self.padding} does not "
                    f"keep the slab's rows (k - stride != 2 * pad)")
        if self.padding:
            x = pad_nd(x, self.padding, self.pad_type, mesh)
        x = self.Conv_0(x)
        if self.norm in ("ln", "layer"):
            x = self.LayerNorm_0(x)
        elif self.norm in ("instance", "in"):
            x = instance_norm(x, mesh=mesh)
        return ACTS[self.activation](x)


class MunitResBlock(nn.Module):
    def __init__(self, dim: int, norm: str = "instance",
                 activation: str = "relu", pad_type: str = "reflect", *,
                 generator: torch.Generator):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(dim, dim, 3, 1, 1, norm, activation,
                                         pad_type, generator=generator)
        self.Conv2dBlock_1 = Conv2dBlock(dim, dim, 3, 1, 1, norm, "none",
                                         pad_type, generator=generator)

    def forward(self, x, mesh=None):
        return x + self.Conv2dBlock_1(self.Conv2dBlock_0(x, mesh), mesh)

    def blocks(self) -> List[Conv2dBlock]:
        return [self.Conv2dBlock_0, self.Conv2dBlock_1]


class ContentEncoder(nn.Module):
    """ops: 0 in_conv, then ``n_downsample`` down convs, then ``n_res``
    residual blocks; ``nce_layers`` index them."""

    def __init__(self, n_downsample: int = 2, n_res: int = 4, dim: int = 64,
                 norm: str = "instance", activation: str = "relu",
                 pad_type: str = "reflect", input_nc: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.in_conv = Conv2dBlock(input_nc, dim, 7, 1, 3, norm, activation,
                                   "reflect", **g)
        self.names = ["in_conv"]
        for i in range(n_downsample):
            setattr(self, f"down_{i}", Conv2dBlock(
                dim, dim * 2, 4, 2, 1, norm, activation, "reflect", **g))
            self.names.append(f"down_{i}")
            dim *= 2
        for i in range(n_res):
            setattr(self, f"res_{i}", MunitResBlock(dim, norm, activation,
                                                    pad_type, **g))
            self.names.append(f"res_{i}")
        self.out_channels = dim

    def forward(self, x, nce_layers: Sequence[int] = (),
                encode_only: bool = False, mesh=None):
        n_ops = len(self.names)
        if nce_layers and (min(nce_layers) < 0 or max(nce_layers) >= n_ops):
            raise ValueError(
                f"nce_layers {tuple(nce_layers)} out of range for "
                f"ContentEncoder ({n_ops} ops); pass e.g. --nce_layers "
                + ",".join(str(i) for i in range(n_ops)))
        feats = []
        h = x
        for i, name in enumerate(self.names):
            h = getattr(self, name)(h, mesh)
            if i in nce_layers:
                feats.append(h)
            if encode_only and nce_layers and i == max(nce_layers):
                return None, feats
        return h, feats


class Decoder(nn.Module):
    def __init__(self, n_upsample: int = 2, n_res: int = 4, dim: int = 256,
                 output_nc: int = 1, activation: str = "relu",
                 pad_type: str = "reflect", style_dim: int = 0, *,
                 generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.n_res, self.n_up = n_res, n_upsample
        if style_dim:
            self.style_fold = Conv2dBlock(dim + style_dim, dim, 1, 1, 0,
                                          "none", activation, **g)
        for i in range(n_res):
            setattr(self, f"res_{i}", MunitResBlock(dim, "instance",
                                                    activation, pad_type, **g))
        for i in range(n_upsample):
            setattr(self, f"up_{i}", Conv2dBlock(dim, dim // 2, 5, 1, 2, "ln",
                                                 activation, "reflect", **g))
            dim //= 2
        self.out_conv = Conv2dBlock(dim, output_nc, 7, 1, 3, "none", "tanh",
                                    "reflect", **g)

    def forward(self, x, style=None, mesh=None):
        h = x
        if style is not None:
            s = style[:, :, None, None].expand(-1, -1, *h.shape[2:])
            h = self.style_fold(torch.cat([h, s], dim=1), mesh)
        for i in range(self.n_res):
            h = getattr(self, f"res_{i}")(h, mesh)
        for i in range(self.n_up):
            h = getattr(self, f"up_{i}")(upsample_nearest(h), mesh)
        return self.out_conv(h, mesh)


class StyleEncoder(nn.Module):
    def __init__(self, n_downsample: int = 4, dim: int = 64,
                 style_dim: int = 8, activation: str = "relu",
                 vae: bool = False, input_nc: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g = dict(generator=generator)
        self.vae = vae
        self.Conv2dBlock_0 = Conv2dBlock(input_nc, dim, 7, 1, 3, "none",
                                         activation, **g)
        self.n_keep = n_downsample - 2
        for i in range(2):
            setattr(self, f"down_{i}", Conv2dBlock(dim, dim * 2, 4, 2, 1,
                                                   "none", activation, **g))
            dim *= 2
        for i in range(self.n_keep):
            setattr(self, f"keep_{i}", Conv2dBlock(dim, dim, 4, 2, 1, "none",
                                                   activation, **g))
        if vae:
            self.fc_mean = _flax_dense(dim, style_dim, generator)
            self.fc_var = _flax_dense(dim, style_dim, generator)
        else:
            self.fc = _flax_dense(dim, style_dim, generator)

    def forward(self, x):
        h = self.down_1(self.down_0(self.Conv2dBlock_0(x)))
        for i in range(self.n_keep):
            h = getattr(self, f"keep_{i}")(h)
        h = h.mean(dim=(2, 3))
        if self.vae:
            return self.fc_mean(h), self.fc_var(h)
        return self.fc(h)


class E_adaIN(nn.Module):
    def __init__(self, style_dim: int = 8, nef: int = 64, n_layers: int = 4,
                 vae: bool = False, input_nc: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.enc_style = StyleEncoder(n_layers, nef, style_dim, vae=vae,
                                      input_nc=input_nc, generator=generator)

    def forward(self, x):
        return self.enc_style(x)


class GResnet(nn.Module):
    """Content encoder + decoder (``resnet_cat``), with the style
    conditioning of ``nz > 0``.  ``train`` and ``generator`` are taken and
    ignored: the net has no dropout."""

    def __init__(self, input_nc: int = 1, output_nc: int = 1, nz: int = 0,
                 num_downs: int = 2, n_res: int = 4, ngf: int = 64, *,
                 generator: torch.Generator):
        super().__init__()
        self.nz = nz
        self.enc_content = ContentEncoder(num_downs, n_res, ngf,
                                          input_nc=input_nc,
                                          generator=generator)
        self.dec = Decoder(num_downs, n_res, ngf * 2 ** num_downs, output_nc,
                           style_dim=nz, generator=generator)

    def forward(self, image, style=None, layers: Sequence[int] = (),
                encode_only: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None, mesh=None):
        """``mesh`` splitting H: ``image``, the output and each tap are
        this rank's rows of the whole image's."""
        layers = tuple(layers)
        content, feats = self.enc_content(image, layers, encode_only, mesh)
        if encode_only:
            return feats
        out = self.dec(content, style if self.nz else None, mesh)
        return (out, feats) if layers else out

    def slab_level_pads(self) -> List[int]:
        """The largest reflect pad at each level of the generator (level
        l: after l stride-2 convs), the rows a slab must exceed there
        (``parallel.mesh.check_joint_slabs``)."""
        pads: Dict[int, int] = {}
        level = 0

        def take(*blocks):
            for b in blocks:
                pads[level] = max(pads.get(level, 0), b.padding)
        enc, dec = self.enc_content, self.dec
        for name in enc.names:
            block = getattr(enc, name)
            if isinstance(block, MunitResBlock):
                take(*block.blocks())
            else:
                take(block)
                level += block.stride == 2
        for i in range(dec.n_res):
            take(*getattr(dec, f"res_{i}").blocks())
        for i in range(dec.n_up):
            level -= 1
            take(getattr(dec, f"up_{i}"))
        take(dec.out_conv)
        return [pads[level] for level in range(max(pads) + 1)]

    def tap_pads(self, layers: Sequence[int]) -> List[int]:
        """0 for every tap: each is a block's output, whose rows on a
        slab are the slab's own."""
        return [0] * len(layers)
