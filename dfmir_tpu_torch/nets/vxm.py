"""VoxelMorph-style dense registration network (2-D and 3-D).

The reference VxmDense + Unet: a strided-conv encoder (LeakyReLU 0.2), a
nearest-upsample decoder with skip concats, extra full-resolution convs, a
3x3 flow head initialised N(0, 1e-5) with zero bias, half-resolution
scaling-and-squaring integration (int_downsize=2, int_steps=7), a resize to
full size and the dense warps.  Parameter names are the reference's
(``unet_model.{downarm,uparm,extras}.<i>.main.*``, ``flow.*``).

The UNet convs use torch's default init, as the reference does (it never
passes netR through init_net).  With ``compute_dtype="bfloat16"`` the UNet
and the flow head take their input in bfloat16 and the flow head's output
comes back to float32; every flow op after it (resize, integrate, warp)
stays float32.  The parameters are the caller's to cast
(``nets.layers.call_in``), as the JAX engine's ``_cast_params`` does.  At 3-D the convs are ``nn.Conv3d``: the JAX
package's ``Conv3DZ`` is a TPU lowering of the same conv, with the same
parameters.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfmir_tpu_torch.nets.layers import conv_nd, conv_slab, upsample_nearest
from dfmir_tpu_torch.ops.integrate import (resize_flow_slab,
                                           resize_flow_to_slab, vecint)
from dfmir_tpu_torch.ops.warp import warp
from dfmir_tpu_torch.parallel.mesh import (first_whole_level, gather_slabs,
                                           is_spatial, slab_slice)


def default_unet_features():
    return [[16, 32, 32, 32], [32, 32, 32, 32, 32, 16, 16]]


class VxmConvBlock(nn.Module):
    """3x3(x3) conv (torch default init) + LeakyReLU(0.2)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, *,
                 ndims: int = 2, generator: torch.Generator):
        super().__init__()
        self.main = conv_nd(in_ch, out_ch, 3, stride, 1, True,
                            init_type="torch_default", ndims=ndims,
                            generator=generator)

    def forward(self, x, mesh=None):
        return F.leaky_relu(conv_slab(self.main, x, mesh), negative_slope=0.2)


class VxmUnet(nn.Module):
    def __init__(self, enc_nf: Sequence[int], dec_nf: Sequence[int],
                 in_ch: int = 2, *, ndims: int = 2,
                 generator: torch.Generator):
        super().__init__()
        n_enc = len(enc_nf)
        block = dict(ndims=ndims, generator=generator)
        self.downarm = nn.ModuleList()
        prev = in_ch
        for nf in enc_nf:
            self.downarm.append(VxmConvBlock(prev, nf, 2, **block))
            prev = nf
        skips = [in_ch] + list(enc_nf[:-1])      # popped from the end
        self.uparm = nn.ModuleList()
        for nf in dec_nf[:n_enc]:
            self.uparm.append(VxmConvBlock(prev, nf, **block))
            prev = nf + skips.pop()
        self.extras = nn.ModuleList()
        for nf in dec_nf[n_enc:]:
            self.extras.append(VxmConvBlock(prev, nf, **block))
            prev = nf
        self.out_channels = prev

    def forward(self, x, mesh=None):
        """``mesh`` splitting the image along axis 2 (D at 3-D, H at 2-D):
        ``x`` is this rank's slab.  A level that splits over the spatial
        ranks (``parallel.mesh.first_whole_level``: n_spatial divides its
        rows) runs on the slabs, each conv with a halo (``conv_slab``).  The
        first level that does not, and every coarser one, runs on the
        gathered map, whole on every spatial rank: the strided conv into it
        takes the finer level's map gathered, and on the way up the decoder
        takes this rank's rows of the upsampled map again, before the skip
        concat, at the first level that splits."""
        depth = len(self.downarm)
        whole = None
        if is_spatial(mesh):
            whole = first_whole_level(x.shape[2] * mesh.n_spatial,
                                      mesh.n_spatial, depth)

        def at(level):
            return mesh if whole is None or level < whole else None
        x_enc = [x]
        for level, layer in enumerate(self.downarm):
            h = x_enc[-1]
            if level + 1 == whole:
                h = gather_slabs(h, mesh)
            x_enc.append(layer(h, at(level + 1)))
        h = x_enc.pop()
        for level, layer in zip(range(depth, 0, -1), self.uparm):
            h = upsample_nearest(layer(h, at(level)))
            if level == whole:
                h = slab_slice(h, mesh.spatial_rank, mesh.n_spatial)
            h = torch.cat([h, x_enc.pop()], dim=1)
        for layer in self.extras:
            h = layer(h, mesh)
        return h


class VxmDense(nn.Module):
    """Returns (bidir, training): (y_source, y_target, pos_flow_fullres);
    (registration=True): (y_source, pos_flow_fullres);
    (unidir, training): (y_source, preint_flow).
    ``return_preint`` appends the pre-integration flow."""

    def __init__(self, ndims: int = 2,
                 nb_features: Tuple[Sequence[int], Sequence[int]] = (
                     (16, 32, 32, 64, 64, 64), (64, 64, 64, 32, 32, 32, 16)),
                 int_steps: int = 7, int_downsize: int = 2, bidir: bool = True,
                 compute_dtype: str = "float32", *,
                 generator: torch.Generator):
        super().__init__()
        if ndims not in (2, 3):
            raise ValueError(f"ndims must be 2 or 3, got {ndims}")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or "
                             f"bfloat16")
        self.compute_dtype = getattr(torch, compute_dtype)
        enc_nf, dec_nf = nb_features
        self.ndims = ndims
        self.int_steps, self.int_downsize, self.bidir = (int_steps,
                                                         int_downsize, bidir)
        self.unet_model = VxmUnet(enc_nf, dec_nf, ndims=ndims,
                                  generator=generator)
        # N(0, 1e-5) weights, zero bias
        self.flow = conv_nd(self.unet_model.out_channels, ndims, 3, 1, 1, True,
                            init_type="normal", init_gain=1e-5, ndims=ndims,
                            generator=generator)

    def forward(self, source, target, registration: bool = False,
                return_preint: bool = False, mesh=None):
        """``mesh`` splitting a 3-D volume along D or a 2-D image along H:
        ``source`` and ``target`` are this rank's slabs, and so
        is each field and image of the tuple (the half-resolution SVF its
        slab of the half-resolution image).  The UNet (its coarse levels
        gathered where they do not split, ``VxmUnet.forward``) and the flow
        head run on the slabs with halos; the SVF is gathered whole on every
        spatial rank, integrated there by the unchanged chain, and each rank
        resizes its own rows of the result; the warps sample the gathered
        source (and target) at the slab's global rows, forward and backward
        (B3 / B4 with ``z0``, B1 / B2 with ``y0``; the data warps' source
        takes no gradient).  Without it each of these steps is the whole
        image's op.  In bfloat16 the UNet, its halos and its gathered
        levels carry bfloat16 (``parallel/mesh.py`` sends their bits), and
        the flow head's output comes back to float32 before the SVF is
        gathered, as on the whole image."""
        z0 = None
        if is_spatial(mesh):
            z0 = mesh.spatial_rank * source.shape[2]
        x = torch.cat([source, target], dim=1)
        low = self.compute_dtype != torch.float32
        if low:
            x = x.to(self.compute_dtype)
        flow_field = conv_slab(self.flow, self.unet_model(x, mesh), mesh)
        if low:
            flow_field = flow_field.float()

        do_resize = self.int_steps > 0 and self.int_downsize > 1
        up = float(self.int_downsize) if do_resize else 1.0
        pos_flow = flow_field
        if do_resize:
            pos_flow = resize_flow_slab(pos_flow, 1.0 / self.int_downsize,
                                        mesh)
        preint_flow = pos_flow

        y_target = None
        if self.int_steps > 0 and self.bidir and not registration:
            # pos and neg SVFs integrate as one batch: every op in the chain
            # is per-sample, so this is exact and halves the serial warps
            b = source.shape[0]
            both = vecint(gather_slabs(torch.cat([pos_flow, -pos_flow]),
                                       mesh), self.int_steps)
            both = resize_flow_to_slab(both, up, mesh)
            pos_flow = both[:b]
            warped = warp(gather_slabs(torch.cat([source, target]), mesh),
                          both, z0=z0)
            y_source, y_target = warped[:b], warped[b:]
        else:
            # registration=True computes the pos chain only: its outputs
            # never use the neg one
            if self.int_steps > 0:
                pos_flow = resize_flow_to_slab(
                    vecint(gather_slabs(pos_flow, mesh), self.int_steps), up,
                    mesh)
            y_source = warp(gather_slabs(source, mesh), pos_flow, z0=z0)
            if self.bidir and not registration:
                # int_steps == 0 here, so the neg flow is -preint_flow
                y_target = warp(gather_slabs(target, mesh), -preint_flow,
                                z0=z0)

        if registration:
            out = (y_source, pos_flow)
        elif self.bidir:
            out = (y_source, y_target, pos_flow)
        else:
            out = (y_source, preint_flow)
        if return_preint:
            out = out + (preint_flow,)
        return out
