"""The registration model: netG translates A to B, netR registers A to B,
netF projects the generator's features for PatchNCE, and with
``lambda_GAN > 0`` netD scores fake_B.

Two paths are ported:

- inference, ``register`` (the path ``test.py`` serves): the generator on
  real_A and real_B stacked as one batch, then VxmDense in
  ``registration=True`` mode;
- training, ``loss_fn`` / ``train_step`` (the step ``train.py`` loops
  over): translate, register, warp, PatchNCE x3 + masked L1 x2 + local NCE
  + smoothness, one backward through netG, netF and netR, one Adam update
  of all three.  ``eval_step`` and ``compute_visuals`` run the same loss
  without an update (dropout active, as in JAX's, whose ``_loss_fn``
  runs netG in training mode).

The step follows the JAX package's ``fuse_nce_encodes`` branches.  Without
flip equivariance the NCE keys are the forward pass's taps, and the query
images go through one encoder pass.  With ``fuse_nce_encodes=False`` the
JAX package re-encodes the keys; the result is the same (the generator's
ops are per-sample, and the JAX suite holds the two equal), so the port
takes the same path for both settings.

The training options (the JAX engine's, ``dfmir_tpu/engine/
registration.py``):

- ``flip_equivariance`` (FastCUT): on a coin, the stacked generator input
  is flipped along W; the keys are then a fresh encode of the unflipped
  real_A / real_B, batched with the queries in one encoder pass, and
  every query's feature maps are flipped back (the local NCE's too, as
  the reference does).  ``registered`` warps the flipped fake_B by the
  unflipped field, as in JAX.
- dropout (``no_dropout=False``): active in the generator passes of the
  loss (the steps, ``eval_step``, ``compute_visuals``), its masks drawn
  from ``dropout_generator`` (on the model's device); ``register`` runs
  without it.  With the taps reused, the keys carry the forward pass's
  masks and the query encode draws fresh ones.
- ``compute_dtype="bfloat16"``: netG and netR run on bfloat16 copies of
  their float32 parameters (``nets.layers.call_in``) with bfloat16 inputs,
  and hand back float32 (netG's output and taps, netR's flow head); netF,
  the losses, the flow math and the warps stay float32, and so do the
  master parameters and Adam's state.  No ``torch.autocast``: it keeps
  another set of ops in float32.  The same for every zoo family, as
  JAX's ``_cast_params`` casts every float32 leaf of netG and netR: the
  transformer netRs take float32 inputs, so they compute in float32 on
  bfloat16-rounded weights (flax's promotion); netF and netD are not
  cast and see float32 maps.
- ``lambda_GAN > 0``: ``train_step`` is two phases on one generator pass.
  It updates netD on the detached fake_B with its own Adam, then adds
  ``gan_loss(netD(fake_B), True) * lambda_GAN`` against the updated netD
  (whose parameters get no gradient) to G's loss.

Data parallelism (``data_parallel``, the JAX package's sharded step):
each rank holds the whole model and steps on its slice of the global
batch.  The training loss (``loss_fn(train=True)``, ``train_step``) is
then the global batch's: the masked L1's sums are the global batch's
(``parallel.mesh.global_sum``) and with
``nce_includes_all_negatives_from_minibatch`` the keys of every rank's
images are the negatives; the other terms are each rank's own mean.  The
gradients of netG, netF and netR (and netD's in ``d_step``) are averaged
over the ranks before Adam, and ``train_step``'s metrics too.  The patch
ids and FastCUT's coin come from ``patch_generator``, equal on every rank
(one seed); the dropout masks are each data rank's own.  ``eval_step`` and
``compute_visuals`` score the batch they are given.

The networks come from the factories (``nets/factory.py``), as in JAX:
every ``netG`` (``resnet_<n>blocks``, ``unet_256`` / ``unet_128``,
``resnet_cat``, ``stylegan2`` / ``smallstylegan2``), ``netF``
(``mlp_sample``, ``sample``, ``global_pool``, ``reshape``,
``strided_conv``), ``netR`` (``vxm``, ``vxm_transformer``, ``vxm_dual``)
and ``netD``.  netF maps the list of tapped maps to (one (B * P, C)
embedding list, ids): ``global_pool`` gives one row an image (of W * C
at 3-D: JAX pools D and H only), ``reshape`` 16 and ``strided_conv``
every output location (its EMA stays at zero, as JAX's
``update_ema=False``).  Outside the resnet family, PatchSampleF's MLP
widths and StridedConvF's (C, side) specs come from the taps' shapes,
traced on the meta device at construction, as JAX's ``jax.eval_shape``
traces them.  Only the resnet and unet generators take the dropout
``train`` flag.

At ``ndims=3`` the model takes (B, C, D, H, W) volumes: netG (resnet or
unet), netF, netR (VxmDense or ``vxm_dual``) and netD (NLayer or pixel)
are built for 3-D, netF flattens D * H * W locations in JAX's order, and
FastCUT flips along H (JAX's axis 2 of (B, D, H, W, C)).  bfloat16 is
ported at both ranks and with every zoo choice.

The spatial axis (``data_parallel`` with a mesh of ``make_mesh(mesh,
n_data, n_spatial)``, n_spatial > 1; JAX's ``shard_batch(...,
shard_spatial=True)``): each rank holds its data rank's items and, of
those, its spatial rank's slab along axis 2 (H at 2-D, D at 3-D), and
every entry point returns this rank's rows of the whole image's results.
netG runs on the slabs (halos, reflect pads at the global ends only, the
norms' statistics over the spatial group: ``nets/resnet_gen.py``, and at
2-D ``resnet_cat``'s ``nets/munit.py``; zero-padded halos, FIR blurs and
the upsampling's transposed conv cut to the slab's rows:
``stylegan2`` / ``smallstylegan2``'s ``nets/stylegan2.py``), netR as
the 3-D engine's (``nets/vxm.py``: its levels that do not split over the
spatial ranks run gathered), PatchSampleF takes the whole map's ids and
gathers the samples on every spatial rank (``nets/patch_sample.py``),
``registered`` warps the gathered fake_B (``ops.warp.warp_slabs``: B5 on
the slab at 3-D, B2 at 2-D), and the masked L1s and the smoothness are the
whole image's.  ``register`` and the step (``loss_fn``, ``train_step``,
``eval_step``) run at 2-D and 3-D.  The image's extent must pass
``parallel.mesh.check_joint_slabs``: JAX's ``shard_batch`` splits it and
the whole-image model takes it, and netG's levels and the SVF split (the
graft's crop 64 over 2 ranks gathers netR's sixth level).

The training options on slabs, each the whole image's computation:
bfloat16 (netG and netR in bfloat16 on the slabs, their halos and
gathered levels carrying bfloat16, ``parallel/mesh.py``; fake_B and the
flow reach ``warp_slabs`` in float32); FastCUT (its flip is along W at
2-D and H at 3-D, an axis every slab holds whole, so it is local, and the
patch ids stay the whole map's); dropout (the spatial ranks of a data rank
share one generator stream and each keeps its rows of the whole mask,
``nets/resnet_gen.py::Dropout``; the data ranks have streams of their
own); ``no_antialias_up`` (``nets/layers.py::conv_transpose_slab``);
all-negatives PatchNCE (the keys gathered over the data ranks alone,
``losses/nce.py``); the GAN phase (``nets/discriminators.py::
discriminate``: the pixel netD on the slab, every other on the gathered
fake_B, whole on every spatial rank, the StyleGAN2 netDs and ``patch``
too; the losses the whole map's, netD's gradient and Adam state the same
on every rank).  The choices in ``SLAB_REFUSALS`` (netG ``unet_*``, the
netF heads, the transformer netRs, ``num_patches=0``) have no slab form
and raise, each by name.

Refused (NotImplementedError): at ``ndims=3`` the choices the JAX package
cannot build there (``JAX_2D_ONLY``: ``jax.eval_shape`` of its
``init_state`` and ``_loss_fn`` at 16^3 fails), unknown names, and on
slabs ``SLAB_REFUSALS``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.losses import (gan_loss, masked_l1, patch_nce_loss,
                                    smoothness_loss)
from dfmir_tpu_torch.nets.discriminators import discriminate
from dfmir_tpu_torch.nets.factory import (define_D, define_F, define_G,
                                          g_family, resnet_blocks)
from dfmir_tpu_torch.nets.feature_nets import channels_last_rows
from dfmir_tpu_torch.nets.layers import call_in
from dfmir_tpu_torch.nets.resnet_gen import nce_feature_dims
from dfmir_tpu_torch.nets.transfusion import VxmDenseTransformer
from dfmir_tpu_torch.nets.vxm import VxmDense
from dfmir_tpu_torch.ops.jacobian import (field_stats, folding_fraction,
                                          jacobian_det)
from dfmir_tpu_torch.ops.warp import warp, warp_slabs
from dfmir_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                           all_reduce_metrics,
                                           check_joint_slabs, is_spatial,
                                           replicate, state_tensors)

NETR_CHOICES = ("vxm", "vxm_transformer", "vxm_dual")
# the choices the JAX package cannot build at ndims=3: munit's residual
# adds, StyleGAN2's and the StyleGAN2 netDs' 2-D convs, and the 4-D
# unpacking of the reshape head, the transformer netR, the tile netD and
# the patch netD (``B, H, W, C = x.shape``)
JAX_2D_ONLY = {"netG": ("resnet_cat", "stylegan2", "smallstylegan2"),
               "netF": ("reshape",), "netR": ("vxm_transformer",),
               "netD": ("stylegan2", "patchstylegan2", "smallpatchstylegan2",
                        "tilestylegan2", "patch")}


# the choices that have no slab form (a spatial mesh refuses each by name):
# (choice, the test on the config)
SLAB_REFUSALS = (
    ("netG unet_128 / unet_256", lambda c: g_family(c.netG) == "unet"),
    ("netF other than mlp_sample / sample",
     lambda c: c.netF not in ("mlp_sample", "sample")),
    ("netR other than vxm (the transformer netRs)",
     lambda c: c.netR != "vxm"),
    ("num_patches=0 (every location)", lambda c: c.num_patches <= 0),
)


def grid_image(size: int, spacing: int = 16, thickness: int = 1):
    """Procedural grid image in [-1, 1], (1, 1, size, size): what the
    ``dvf`` visual warps (it stands in for the reference's deform256.jpg)."""
    img = torch.ones(size, size)
    for start in range(0, size, spacing):
        img[start:start + thickness, :] = -1.0
        img[:, start:start + thickness] = -1.0
    return img[None, None]


class RegistrationModel:
    """Builds netG, netR and netF (and netD with ``lambda_GAN > 0``) on
    ``device`` (CUDA unless the caller names another), initialised from
    ``generator`` (seed 0 when None), one Adam over netG, netF and netR and
    one over netD.  The weights are drawn on the CPU, so one generator seed
    gives the same weights on every device."""

    def __init__(self, cfg: RegistrationConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: float32 "
                             f"or bfloat16")
        if cfg.netR not in NETR_CHOICES:
            raise NotImplementedError(f"netR {cfg.netR}")
        if cfg.ndims != 2:
            self._refuse_3d(cfg)
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # built on the CPU, where the taps are probed, then moved
        netG = define_G(
            input_nc=cfg.input_nc, output_nc=cfg.output_nc, ngf=cfg.ngf,
            netG=cfg.netG, norm=cfg.normG, use_dropout=not cfg.no_dropout,
            init_type=cfg.init_type, init_gain=cfg.init_gain,
            no_antialias=cfg.no_antialias, no_antialias_up=cfg.no_antialias_up,
            size=cfg.crop_size,
            stylegan2_num_downsampling=cfg.stylegan2_G_num_downsampling,
            ndims=cfg.ndims, generator=generator)
        if g_family(cfg.netG) == "resnet" and cfg.netF != "strided_conv":
            dims = nce_feature_dims(
                cfg.nce_layers, input_nc=cfg.input_nc,
                output_nc=cfg.output_nc, ngf=cfg.ngf,
                n_blocks=resnet_blocks(cfg.netG),
                no_antialias=cfg.no_antialias,
                no_antialias_up=cfg.no_antialias_up)
            specs = None
        else:
            shapes = self._tap_shapes(netG)
            dims = [s[1] for s in shapes]
            specs = [(s[1], s[2]) for s in shapes]
        self.netG = netG.to(self.device).eval()
        if cfg.netR == "vxm":
            self.netR = VxmDense(
                ndims=cfg.ndims, nb_features=(tuple(cfg.vxm_enc),
                                              tuple(cfg.vxm_dec)),
                int_steps=cfg.int_steps, int_downsize=cfg.int_downsize,
                bidir=True, compute_dtype=cfg.compute_dtype,
                generator=generator)
        else:
            self.netR = VxmDenseTransformer(
                ndims=cfg.ndims, nb_features=(tuple(cfg.vxm_enc),
                                              tuple(cfg.vxm_dec)),
                int_steps=cfg.int_steps, int_downsize=cfg.int_downsize,
                bidir=True,
                fuse="gpt" if cfg.netR == "vxm_transformer" else "none",
                generator=generator)
        self.netR = self.netR.to(self.device).eval()
        self.netF = define_F(
            netF=cfg.netF, netF_nc=cfg.netF_nc, feature_dims=dims,
            strided_specs=specs, init_type=cfg.init_type,
            init_gain=cfg.init_gain, ndims=cfg.ndims,
            generator=generator).to(self.device)
        # patch ids (and FastCUT's coin) are drawn from this when a step is
        # given neither ids nor a generator
        self.patch_generator = torch.Generator().manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=generator)))
        # the dropout masks, on the model's device
        self.dropout_generator = torch.Generator(
            device=self.device).manual_seed(
                int(torch.randint(2 ** 62, (1,), generator=generator)))
        self.optimizer = torch.optim.Adam(
            self.parameters(), lr=cfg.lr, betas=(cfg.beta1, cfg.beta2),
            eps=1e-8)
        self.netD = self.optimizer_D = None
        self.mesh: Optional[Mesh] = None
        if cfg.lambda_GAN > 0:
            self.netD = define_D(
                input_nc=cfg.output_nc, ndf=cfg.ndf, netD=cfg.netD,
                n_layers_D=cfg.n_layers_D, norm=cfg.normD,
                init_type=cfg.init_type, init_gain=cfg.init_gain,
                no_antialias=cfg.no_antialias, in_size=cfg.crop_size,
                ndims=cfg.ndims, generator=generator,
            ).to(self.device)
            self.optimizer_D = torch.optim.Adam(
                self.netD.parameters(), lr=cfg.lr,
                betas=(cfg.beta1, cfg.beta2), eps=1e-8)

    @staticmethod
    def _refuse_3d(cfg: RegistrationConfig) -> None:
        """At ndims=3: refuse the choices JAX cannot build there."""
        chosen = {"netG": cfg.netG, "netF": cfg.netF, "netR": cfg.netR,
                  "netD": cfg.netD if cfg.lambda_GAN > 0 else None}
        jax_fails = [f"{k}={v!r}" for k, v in chosen.items()
                     if v in JAX_2D_ONLY[k]]
        if jax_fails:
            raise NotImplementedError(
                f"{', '.join(jax_fails)} at ndims={cfg.ndims}: the JAX "
                f"package cannot run these networks in 3-D, so there is "
                f"nothing to port")

    def parameters(self) -> List[torch.nn.Parameter]:
        """The parameters of the main update: netG's, netF's and netR's."""
        return [p for net in (self.netG, self.netF, self.netR)
                for p in net.parameters()]

    def state_tensors(self) -> List[torch.Tensor]:
        """Every network's parameters and every Adam state tensor."""
        nets = [self.netG, self.netF, self.netR]
        opts = [self.optimizer]
        if self.netD is not None:
            nets.append(self.netD)
            opts.append(self.optimizer_D)
        return state_tensors(nets, opts)

    def data_parallel(self, mesh: Mesh) -> None:
        """Step as rank ``mesh.rank`` of ``mesh.world``: check that every
        rank holds rank 0's parameters and Adam state (one seed, or one
        checkpoint), broadcast them from rank 0 (JAX's ``replicate``), and
        draw this rank's dropout masks from a generator of its own, seeded
        from a draw of the model's and the data rank (the spatial ranks of
        one data rank share it, each keeping its rows of the same masks;
        without a spatial axis the data rank is the rank).  A mesh with
        n_spatial > 1 (``make_mesh``) splits the images along axis 2 too:
        the config must have a slab form (``SLAB_REFUSALS``) and
        ``cfg.crop_size`` pass ``check_joint_slabs``, and every call takes
        this rank's slabs."""
        if is_spatial(mesh):
            self._check_slabs(self.cfg.crop_size, mesh)
        replicate(self.state_tensors(), mesh)
        base = int(torch.randint(2 ** 62, (1,),
                                 generator=self.dropout_generator,
                                 device=self.dropout_generator.device))
        seed = np.random.SeedSequence([base, mesh.data_rank]).generate_state(
            1, np.uint64)[0]
        self.dropout_generator.manual_seed(int(seed))
        self.mesh = mesh

    def _check_slabs(self, extent: int, mesh: Mesh) -> None:
        """Raise unless the config has a slab form and an image of
        ``extent`` rows splits over ``mesh``'s spatial ranks."""
        cfg = self.cfg
        refused = [name for name, test in SLAB_REFUSALS if test(cfg)]
        if refused:
            raise NotImplementedError(
                f"{', '.join(refused)}: no slab form, so a mesh that splits "
                f"the images (n_spatial {mesh.n_spatial}) refuses it")
        check_joint_slabs(extent, mesh.n_spatial, len(cfg.vxm_enc),
                          cfg.int_downsize, self.netG.slab_level_pads())

    def _spatial(self, x) -> Optional[Mesh]:
        """The mesh when it splits the images (``x`` then a slab, whose
        whole extent must pass ``check_joint_slabs``), else None."""
        if not is_spatial(self.mesh):
            return None
        self._check_slabs(x.shape[2] * self.mesh.n_spatial, self.mesh)
        return self.mesh

    def _tap_shapes(self, netG) -> List[torch.Size]:
        """The (1, C, *spatial) shapes of netG's taps: one encode traced on
        the meta device, shapes without arithmetic (JAX's ``_tap_shapes``
        traces abstractly too)."""
        cfg = self.cfg
        x0 = torch.empty((1, cfg.input_nc) + (cfg.crop_size,) * cfg.ndims,
                         device="meta")
        state = {k: torch.empty_like(v, device="meta") for k, v in
                 [*netG.named_parameters(), *netG.named_buffers()]}
        feats = torch.func.functional_call(
            netG, state, (x0,), {"layers": tuple(cfg.nce_layers),
                                 "encode_only": True})
        return [f.shape for f in feats]

    # ------------------------------------------------- the networks' calls

    def _G(self, x, dropout: Optional[torch.Generator] = None, mesh=None,
           **kw):
        """netG in the compute dtype: its output (or taps) in float32.
        ``dropout``: the masks' generator of a training pass; None runs
        without dropout.  ``mesh``: on slabs."""
        if mesh is not None:
            kw["mesh"] = mesh
        low = self.compute_dtype != torch.float32
        out = call_in(self.compute_dtype, self.netG,
                      x.to(self.compute_dtype) if low else x,
                      train=dropout is not None, generator=dropout, **kw)
        if not low:
            return out
        if isinstance(out, list):
            return [f.float() for f in out]
        if isinstance(out, tuple):
            return out[0].float(), [f.float() for f in out[1]]
        return out.float()

    def _R(self, *args, **kw):
        """netR with its parameters in the compute dtype.  VxmDense casts
        its input to it; the transformer netRs take float32 inputs, which
        flax promotes against the cast kernels, so they compute in float32
        on rounded weights."""
        return call_in(self.compute_dtype, self.netR, *args,
                       round_only=not isinstance(self.netR, VxmDense), **kw)

    # ------------------------------------------------------------ inference

    @torch.no_grad()
    def register(self, real_A, real_B):
        """Inference: translation, then registration=True.

        real_A, real_B: (B, C, *spatial), 2-D or 3-D.  Returns (fake_B,
        idt_B, y_source, pos_flow); on slabs, this rank's slabs of each."""
        B = real_A.shape[0]
        mesh = self._spatial(real_A)
        fake = self._G(torch.cat([real_A, real_B], dim=0), mesh=mesh)
        kw = {"mesh": mesh} if mesh is not None else {}
        y_source, pos_flow = self._R(real_A, real_B, registration=True, **kw)
        return fake[:B], fake[B:], y_source, pos_flow

    @torch.no_grad()
    def registration_metrics(self, real_A, real_B) -> Dict[str, torch.Tensor]:
        """Jacobian-determinant map (B, H, W) and folding fraction (B,)."""
        if is_spatial(self.mesh):
            raise NotImplementedError("registration_metrics on slabs: use "
                                      "flow_stats, the whole image's")
        pos_flow = self.register(real_A, real_B)[3]
        return {"jac_det": jacobian_det(pos_flow),
                "folding_fraction": folding_fraction(pos_flow)}

    @torch.no_grad()
    def flow_stats(self, real_A, real_B,
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """Scalar field-health statistics of the registration flow
        (``ops.jacobian.field_stats``); with ``mesh``, the global
        batch's; on slabs always the whole image's and global batch's."""
        return field_stats(self.register(real_A, real_B)[3],
                           self._spatial(real_A) or mesh)

    # ------------------------------------------------------------- training

    def _F(self, feats, patch_ids, generator=None, mesh=None):
        """netF on a list of tapped maps: (list of (B * P, C) embeddings,
        the patch ids; None for the heads that sample no patches).
        ``mesh``: the maps are this rank's rows (netG's taps on slabs)."""
        cfg = self.cfg
        if cfg.netF in ("sample", "mlp_sample"):
            kw = {} if mesh is None else {
                "mesh": mesh, "tap_pads": self.netG.tap_pads(cfg.nce_layers)}
            return self.netF(feats, cfg.num_patches, patch_ids,
                             generator=generator, **kw)
        if cfg.netF == "strided_conv":
            return [channels_last_rows(o) for o in self.netF(feats)], None
        return [self.netF(f) for f in feats], None

    def _nce(self, feat_q, feat_k, patch_ids, generator, flip: bool, mesh):
        """The NCE loss of one (query, key) pair of tapped feature lists,
        averaged over the layers; ``flip`` flips the queries back along
        W first.  On slabs (``mesh`` splitting the images) the samples are
        gathered on every spatial rank, and so the loss is the data rank's
        on each of them."""
        cfg = self.cfg
        if flip:
            feat_q = [f.flip(3) for f in feat_q]
        spatial = mesh if is_spatial(mesh) else None
        k_pool, ids = self._F(feat_k, patch_ids, generator, spatial)
        q_pool, _ = self._F(feat_q, ids, mesh=spatial)
        total = 0.0
        for f_q, f_k in zip(q_pool, k_pool):
            per_patch = patch_nce_loss(
                f_q, f_k, nce_T=cfg.nce_T, batch_size=feat_q[0].shape[0],
                all_negatives_from_minibatch=(
                    cfg.nce_includes_all_negatives_from_minibatch),
                mesh=mesh)
            total = total + per_patch.mean() * cfg.lambda_NCE
        return total / len(cfg.nce_layers)

    def _forward(self, real_A, real_B, flip: Optional[bool], generator,
                 dropout: Optional[torch.Generator], mesh=None):
        """The step's network passes before any loss: the generator (on
        the flipped input when the coin says so), the registration net and
        the warp of fake_B.  Returns a dict of what the losses read.
        ``mesh``: on slabs."""
        cfg = self.cfg
        B = real_A.shape[0]
        if cfg.flip_equivariance:
            if flip is None:
                flip = bool(torch.rand((), generator=generator) < 0.5)
        else:
            flip = False
        real = torch.cat([real_A, real_B], dim=0)
        if flip:
            real = real.flip(3)
        layers = tuple(cfg.nce_layers)
        feats_fwd = None
        if cfg.flip_equivariance:
            fake = self._G(real, dropout, mesh)
        else:
            fake, feats_fwd = self._G(real, dropout, mesh, layers=layers)
        fake_B, idt_B = fake[:B], fake[B:]
        if mesh is not None:
            y_source, _, pos_flow = self._R(real_A, real_B, mesh=mesh)
            registered = warp_slabs(fake_B, pos_flow, mesh)
        else:
            y_source, _, pos_flow = self._R(real_A, real_B)
            registered = warp(fake_B, pos_flow)
        return {"fake_B": fake_B, "idt_B": idt_B, "y_source": y_source,
                "pos_flow": pos_flow, "registered": registered,
                "feats_fwd": feats_fwd, "flip": flip}

    def _nce_losses(self, fwd, real_A, real_B, patch_ids, generator,
                    dropout, mesh):
        """The NCE calls' losses (NCE, NCE_Y when ``nce_idt``, local)."""
        cfg = self.cfg
        B = real_A.shape[0]
        layers = tuple(cfg.nce_layers)
        use_idt = cfg.nce_idt and cfg.lambda_NCE > 0
        queries = ([fwd["fake_B"]] + ([fwd["idt_B"]] if use_idt else [])
                   + [fwd["y_source"]])
        if fwd["feats_fwd"] is not None:
            # keys from the forward taps; the queries in one encoder pass
            feats_A = [f[:B] for f in fwd["feats_fwd"]]
            feats_B = [f[B:] for f in fwd["feats_fwd"]]
            k_chunks = [feats_A] + ([feats_B] if use_idt else []) + [feats_B]
            q_feats = self._G(torch.cat(queries, dim=0), dropout,
                              mesh if is_spatial(mesh) else None,
                              layers=layers, encode_only=True)
            q_chunks = [[f[i * B:(i + 1) * B] for f in q_feats]
                        for i in range(len(queries))]
        else:
            # flip equivariance: the keys (the unflipped real_A / real_B)
            # and the queries in one encoder pass, pair by pair
            keys = [real_A] + ([real_B] if use_idt else []) + [real_B]
            stacked = torch.cat([x for q, k in zip(queries, keys)
                                 for x in (q, k)], dim=0)
            feats = self._G(stacked, dropout,
                            mesh if is_spatial(mesh) else None,
                            layers=layers, encode_only=True)
            chunks = [[f[i * B:(i + 1) * B] for f in feats]
                      for i in range(2 * len(queries))]
            q_chunks, k_chunks = chunks[0::2], chunks[1::2]
        if patch_ids is None:
            patch_ids = [None] * len(queries)
        if len(patch_ids) != len(queries):
            raise ValueError(f"patch_ids holds {len(patch_ids)} lists, the "
                             f"step makes {len(queries)} NCE calls")
        return [self._nce(q, k, ids, generator, fwd["flip"], mesh)
                for q, k, ids in zip(q_chunks, k_chunks, patch_ids)]

    def _losses(self, fwd, nce_vals, real_B, with_D: bool, mesh):
        """(total, metrics, aux) from the passes and the NCE losses."""
        cfg = self.cfg
        use_idt = cfg.nce_idt and cfg.lambda_NCE > 0
        fake_B, idt_B = fwd["fake_B"], fwd["idt_B"]
        registered, pos_flow = fwd["registered"], fwd["pos_flow"]
        loss_NCE = nce_vals[0]
        if use_idt:
            loss_NCE_Y = nce_vals[1]
            loss_G = (loss_NCE + loss_NCE_Y) * 0.5
        else:
            loss_NCE_Y = torch.zeros((), device=real_B.device)
            loss_G = loss_NCE

        # G's GAN term against netD, whose parameters get no gradient
        loss_G_GAN = torch.zeros((), device=real_B.device)
        if with_D and self.netD is not None:
            frozen = {n: p.detach() for n, p in self.netD.named_parameters()}
            loss_G_GAN = self._gan_loss(fake_B, True, mesh,
                                        frozen) * cfg.lambda_GAN
        loss_G = loss_G + loss_G_GAN

        # R losses; the masks are ORs of foreground tests
        mask = (real_B > -0.95) | (registered > -0.95)
        mask2 = (idt_B > -0.95) | (registered > -0.95)
        loss_local = nce_vals[-1] * cfg.local_weight
        loss_R = (masked_l1(registered, real_B, mask, mesh)
                  + masked_l1(idt_B, registered, mask2, mesh) + loss_local)
        loss_smooth = smoothness_loss(
            pos_flow, mesh if is_spatial(mesh) else None) * cfg.smooth_weight

        total = loss_R + loss_G + loss_smooth
        metrics = {"G": loss_G, "NCE": loss_NCE, "R": loss_R,
                   "smooth": loss_smooth, "local": loss_local,
                   "total": total}
        if cfg.nce_idt:
            metrics["NCE_Y"] = loss_NCE_Y
        if cfg.lambda_GAN > 0:
            metrics["G_GAN"] = loss_G_GAN
        aux = {"fake_B": fake_B, "idt_B": idt_B, "registered": registered,
               "regA": fwd["y_source"], "pos_flow": pos_flow}
        return total, metrics, aux

    def _step_generators(self, generator, dropout, train: bool):
        if generator is None:
            generator = self.patch_generator
        if not train or self.cfg.no_dropout:
            dropout = None
        elif dropout is None:
            dropout = self.dropout_generator
        return generator, dropout

    def loss_fn(self, real_A, real_B,
                patch_ids: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                generator: Optional[torch.Generator] = None,
                flip: Optional[bool] = None,
                dropout_generator: Optional[torch.Generator] = None,
                train: bool = True):
        """The step's losses: returns (total, metrics, aux).

        real_A, real_B: (B, C, *spatial).  ``patch_ids`` gives the patch
        locations, one list per NCE call (NCE, NCE_Y when ``nce_idt``,
        local) of one (P,) index tensor per tapped layer; without it they
        are drawn from ``generator`` (a CPU generator), else from the
        model's own ``patch_generator``.  ``flip``: FastCUT's coin (with
        ``flip_equivariance``); None draws it from that generator first.
        ``train``: dropout active (with ``no_dropout=False``), its masks
        from ``dropout_generator``, else the model's own.  metrics: G, NCE,
        NCE_Y (with ``nce_idt``), R, smooth, local, total, and with
        ``lambda_GAN > 0`` G_GAN, 0 here as in the JAX package's loss
        without netD's parameters (``train_step`` adds it against the
        updated netD).  aux: fake_B, idt_B, registered, regA, pos_flow.
        Data parallel, with ``train``: this rank's part of the global
        batch's loss (its mean over the ranks is the global loss, and its
        gradient, averaged over them, the global gradient).  On slabs
        (train or not): the whole image's and global batch's loss, with
        this rank's share of its gradient."""
        return self._loss(real_A, real_B, patch_ids, generator, flip,
                          dropout_generator, train,
                          self.mesh if train else None)

    def _step_mesh(self, real_A, mesh):
        """(the losses' mesh, the networks' mesh on slabs or None)."""
        spatial = self._spatial(real_A)
        return spatial or mesh, spatial

    def _loss(self, real_A, real_B, patch_ids, generator, flip,
              dropout_generator, train: bool, mesh):
        mesh, spatial = self._step_mesh(real_A, mesh)
        generator, dropout = self._step_generators(
            generator, dropout_generator, train)
        fwd = self._forward(real_A, real_B, flip, generator, dropout,
                            spatial)
        nce_vals = self._nce_losses(fwd, real_A, real_B, patch_ids,
                                    generator, dropout, mesh)
        return self._losses(fwd, nce_vals, real_B, False, mesh)

    def train_step(self, real_A, real_B, lr: float,
                   patch_ids: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                   generator: Optional[torch.Generator] = None,
                   flip: Optional[bool] = None,
                   dropout_generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimisation step: one backward through netG, netF and netR,
        then one Adam update of all three at learning rate ``lr`` (the
        update of ``optax.scale_by_adam`` followed by ``-lr * u``).  With
        ``lambda_GAN > 0`` netD is updated first, on the detached fake_B of
        the same generator pass, and G's loss is taken against the updated
        netD.  Returns the metrics, detached, on the model's device (with
        netD: D, D_fake and D_real too); data parallel, averaged over the
        ranks."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.netD is None:
            total, metrics, _ = self.loss_fn(real_A, real_B, patch_ids,
                                             generator, flip,
                                             dropout_generator)
        else:
            generator, dropout = self._step_generators(
                generator, dropout_generator, True)
            fwd = self._forward(real_A, real_B, flip, generator, dropout,
                                self._step_mesh(real_A, self.mesh)[1])
            d_metrics = self.d_step(fwd["fake_B"].detach(), real_B, lr)
            nce_vals = self._nce_losses(fwd, real_A, real_B, patch_ids,
                                        generator, dropout, self.mesh)
            total, metrics, _ = self._losses(fwd, nce_vals, real_B, True,
                                             self.mesh)
            metrics.update(d_metrics)
        total.backward()
        self.apply_gradients(lr)
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()},
                                  self.mesh)

    def _gan_loss(self, x, target_is_real: bool, mesh=None, params=None):
        """``gan_loss`` of netD's prediction on ``x`` (on slabs, when
        ``mesh`` splits the images: this rank's slab, and the loss the
        whole map's, ``nets.discriminators.discriminate``)."""
        pred, split = discriminate(self.netD, x,
                                   mesh if is_spatial(mesh) else None, params)
        return gan_loss(pred, target_is_real, self.cfg.gan_mode, mesh=split)

    def d_step(self, fake_B, real_B, lr: float) -> Dict[str, torch.Tensor]:
        """netD's update (phase 1 of a GAN step): (D(fake) loss + D(real)
        loss) / 2, one Adam step at ``lr``.  Returns D, D_fake, D_real.
        On slabs ``fake_B`` and ``real_B`` are this rank's slabs and the
        losses the whole images'."""
        self.optimizer_D.zero_grad(set_to_none=True)
        l_fake = self._gan_loss(fake_B, False, self.mesh)
        l_real = self._gan_loss(real_B, True, self.mesh)
        loss_D = (l_fake + l_real) * 0.5
        loss_D.backward()
        all_reduce_grads(self.netD.parameters(), self.mesh)
        for group in self.optimizer_D.param_groups:
            group["lr"] = float(lr)
        self.optimizer_D.step()
        return {"D": loss_D.detach(), "D_fake": l_fake.detach(),
                "D_real": l_real.detach()}

    def apply_gradients(self, lr: float) -> None:
        """One Adam update from the parameters' ``.grad`` at rate ``lr``;
        data parallel, of their mean over the ranks (one flat all-reduce
        a network)."""
        for net in (self.netG, self.netF, self.netR):
            all_reduce_grads(net.parameters(), self.mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = float(lr)
        self.optimizer.step()

    @torch.no_grad()
    def eval_step(self, real_A, real_B, patch_ids=None, generator=None,
                  flip=None, dropout_generator=None):
        """Losses and outputs without an update: (metrics, aux).  The
        loss of the training step on the batch given (not the global
        batch's when data parallel; on slabs the whole image's and global
        batch's), with dropout active as in JAX's ``eval_step`` (with
        ``no_dropout=False``; its masks from ``dropout_generator``, else the
        model's own)."""
        _, metrics, aux = self._loss(real_A, real_B, patch_ids, generator,
                                     flip, dropout_generator, True, None)
        if is_spatial(self.mesh):
            metrics = all_reduce_metrics(metrics, self.mesh)
        return metrics, aux

    @torch.no_grad()
    def compute_visuals(self, real_A, real_B, patch_ids=None,
                        generator=None, flip=None, dropout_generator=None):
        """The reference's visual set, (visuals, metrics), from
        ``eval_step``'s loss (dropout active as there): real_A, fake_B,
        real_B, dvf (the grid image warped by pos_flow), registered,
        regA, and idt_B with ``nce_idt``."""
        if is_spatial(self.mesh):
            raise NotImplementedError("compute_visuals on slabs: the visuals "
                                      "are the whole image's; gather them")
        metrics, aux = self.eval_step(real_A, real_B, patch_ids, generator,
                                      flip, dropout_generator)
        grid = grid_image(self.cfg.crop_size).to(real_A.device)
        dvf = warp(grid.expand(real_A.shape[0], -1, -1, -1).contiguous(),
                   aux["pos_flow"])
        visuals = {"real_A": real_A, "fake_B": aux["fake_B"],
                   "real_B": real_B, "dvf": dvf,
                   "registered": aux["registered"], "regA": aux["regA"]}
        if self.cfg.nce_idt:
            visuals["idt_B"] = aux["idt_B"]
        return visuals, metrics
