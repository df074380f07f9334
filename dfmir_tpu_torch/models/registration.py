"""The paper's model as a task of the command line (the JAX package's
``models/registration.py::RegistrationTask``): the CUT flags,
option-driven construction, the LR schedule, checkpoints in the
reference's file names with ``--continue_train`` / ``--pretrained_name``,
and the losses and visuals the Visualizer reads.  The compute is
``engine.RegistrationModel``'s.

Randomness comes from ``torch.Generator``s seeded from ``--seed``: the
weights, the patch ids (and FastCUT's coin) through the engine's
``patch_generator``, the dropout masks through its ``dropout_generator``.
The port cannot draw JAX's streams, so one seed gives different weights in
the two packages.  A checkpoint carries the generators' states beside
Adam's (and netD's Adam with ``--lambda_GAN > 0``), so a resumed run draws
what an uninterrupted one would.

With ``--lambda_GAN > 0`` ``net_D`` is saved and loaded with the others.
The JAX package reads the port's ``net_G`` / ``net_F`` / ``net_R`` ``.pth``
but not ``net_D.pth``: its ``_pth_converter`` has no discriminator branch
and raises ``KeyError``.  The port reads the JAX package's ``net_D``
``.msgpack`` and its two-optimizer state.  A zoo network's ``.pth``
holds the port's own names (flax's, ``compat/convert.py::state_from_flax``);
the port reads a zoo model's JAX ``.msgpack`` too.

Data parallel (``parallelize(mesh)``, one process a card): every rank
builds the same weights from ``--seed`` (or reads the same checkpoint),
takes its slice of each global batch, and steps with the gradients and
losses of the global batch.  Rank 0 alone writes checkpoints.  A rank's
dropout masks are its own, so a resumed data-parallel run draws masks
other than an uninterrupted one would.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from dfmir_tpu_torch.compat import convert
from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine import checkpoints as ckpt
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.engine.schedules import LRSchedule
from dfmir_tpu_torch.parallel.mesh import barrier, check_share
from dfmir_tpu_torch.utils.util import str2bool


def dequant_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [-1, 1] on their device (ToTensor +
    Normalize(0.5, 0.5)); within 1 ulp of the host float path."""
    return x.float() / 255.0 * 2.0 - 1.0


class RegistrationTask:
    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        """The CUT flag block, with the CUT / FastCUT defaults."""
        parser.add_argument("--CUT_mode", type=str, default="CUT",
                            choices=["CUT", "cut", "FastCUT", "fastcut"])
        parser.add_argument("--lambda_GAN", type=float, default=0.0)
        parser.add_argument("--lambda_NCE", type=float, default=0.25)
        parser.add_argument("--nce_idt", type=str2bool, nargs="?",
                            const=True, default=False)
        parser.add_argument("--nce_layers", type=str, default="0,4,8,12,16")
        parser.add_argument("--nce_includes_all_negatives_from_minibatch",
                            type=str2bool, nargs="?", const=True,
                            default=False)
        parser.add_argument("--netF", type=str, default="mlp_sample",
                            choices=["sample", "reshape", "mlp_sample"])
        parser.add_argument("--netF_nc", type=int, default=256)
        parser.add_argument("--nce_T", type=float, default=0.07)
        parser.add_argument("--num_patches", type=int, default=256)
        parser.add_argument("--flip_equivariance", type=str2bool, nargs="?",
                            const=True, default=False)
        parser.add_argument("--netR", type=str, default="vxm",
                            choices=["vxm", "vxm_transformer", "vxm_dual"],
                            help="registration net variant")
        parser.set_defaults(pool_size=0)
        opt, _ = parser.parse_known_args()
        if opt.CUT_mode.lower() == "cut":
            parser.set_defaults(nce_idt=True, lambda_NCE=0.25)
        elif opt.CUT_mode.lower() == "fastcut":
            parser.set_defaults(nce_idt=False, lambda_NCE=10.0,
                                flip_equivariance=True,
                                n_epochs=150, n_epochs_decay=50)
        else:
            raise ValueError(opt.CUT_mode)
        return parser

    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", False)
        self.cfg = RegistrationConfig.from_opt(opt)
        self.device = resolve_device(getattr(opt, "device", None))
        seed = int(getattr(opt, "seed", 0) or 0)
        self.engine = RegistrationModel(
            self.cfg, device=self.device,
            generator=torch.Generator().manual_seed(seed))
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)

        self.loss_names = ["G", "NCE", "R", "smooth", "local"]
        self.visual_names = ["real_A", "fake_B", "real_B", "dvf",
                             "registered", "regA"]
        if opt.nce_idt and self.isTrain:
            self.loss_names += ["NCE_Y"]
            self.visual_names += ["idt_B"]
        self.model_names = ["G", "F", "R"] if self.isTrain else ["G", "R"]
        if self.cfg.lambda_GAN > 0 and self.isTrain:
            self.loss_names += ["G_GAN", "D"]
            self.model_names += ["D"]

        self.step = 0
        self.mesh = None
        self.schedule = LRSchedule(opt) if self.isTrain else None
        self.metric = 0.0  # plateau-policy input
        self._losses = {}
        self._batch = None
        self._visuals_cache = None
        self.image_paths = None

    def _nets(self):
        return {name: getattr(self.engine, attr)
                for name, attr in convert.ALL_NETS.items()
                if getattr(self.engine, attr) is not None}

    # ---------------------------------------------------------- lifecycle

    def data_dependent_initialize(self, data=None):
        """A no-op: the networks are built with their shapes in
        ``__init__``; kept for the command line's two-phase setup."""

    def setup(self, opt):
        """Loads a checkpoint when resuming (``--continue_train``) or
        testing."""
        self.data_dependent_initialize()
        if (self.isTrain and getattr(opt, "continue_train", False)) \
                or not self.isTrain:
            self.load_networks(opt.epoch)

    def parallelize(self, mesh=None):
        """Data parallel as rank ``mesh.rank`` of ``mesh.world`` (the JAX
        package's sharded batch; ``options`` gives more than one device
        only when ``--batch_size`` divides over them): the engine checks
        that every rank holds the same weights and Adam state and
        broadcasts rank 0's.  Without a mesh, one device."""
        if mesh is None:
            return
        self.mesh = mesh
        self.engine.data_parallel(mesh)

    def eval(self):
        """A no-op: ``register`` runs without dropout already, and
        ``eval_step`` / ``compute_visuals`` draw it (with
        ``--no_dropout False``) as the JAX package's do, whose losses run
        netG in training mode; instance norm runs the same in training and
        evaluation."""

    # -------------------------------------------------------------- steps

    def set_input(self, batch):
        """Moves the batch's NCHW arrays to the device; uint8 pixels are
        normalized there.  Data parallel, this rank's share of the global
        batch, as the sliced loader gives it."""
        AtoB = self.opt.direction == "AtoB"
        A, B = (torch.as_tensor(np.asarray(batch[k]))
                for k in (("A", "B") if AtoB else ("B", "A")))
        check_share(len(A), self.opt.batch_size, self.mesh)
        if A.dtype == torch.uint8:
            A, B = (dequant_u8(x.to(self.device)) for x in (A, B))
        else:
            A, B = (x.to(self.device, torch.float32) for x in (A, B))
        self._batch = (A, B)
        self.image_paths = batch.get("A_paths")

    def optimize_parameters(self):
        A, B = self._batch
        self._losses = self.engine.train_step(A, B,
                                              self.schedule.current_lr())
        self.step += 1
        self._visuals_cache = None

    def test(self):
        A, B = self._batch
        _, self._aux = self.engine.eval_step(A, B)
        self._visuals_cache = None

    def register_pair(self, A=None, B=None):
        """Inference: (fake_B, idt_B, y_source, pos_flow) on the device."""
        if A is None:
            A, B = self._batch
        return self.engine.register(A, B)

    def registration_stats(self):
        """Scalar deformation-health statistics of the current batch
        (folding fraction, |J| range, max displacement), for
        ``--jac_freq``; data parallel, the global batch's (every rank
        calls it)."""
        A, B = self._batch
        stats = self.engine.flow_stats(A, B, self.mesh)
        return OrderedDict((k, float(v)) for k, v in stats.items())

    # ---------------------------------------------------------- accessors

    def get_current_losses(self) -> OrderedDict:
        """The last step's losses as floats (this waits for the step)."""
        return OrderedDict((name, float(self._losses[name]))
                           for name in self.loss_names
                           if name in self._losses)

    def compute_visuals(self):
        if self._visuals_cache is None and self._batch is not None:
            A, B = self._batch
            self._visuals_cache, _ = self.engine.compute_visuals(A, B)

    def get_current_visuals(self) -> OrderedDict:
        """The visuals as NCHW tensors on the device."""
        self.compute_visuals()
        return OrderedDict((name, self._visuals_cache[name])
                           for name in self.visual_names
                           if self._visuals_cache
                           and name in self._visuals_cache)

    def get_image_paths(self):
        return self.image_paths

    # -------------------------------------------------------- checkpoints

    def save_networks(self, epoch):
        """Rank 0 writes (every rank calls it); the others wait for it."""
        if self.mesh is None or self.mesh.rank == 0:
            self._save(epoch)
        barrier(self.mesh)

    def _save(self, epoch):
        nets = {name: net.state_dict() for name, net in self._nets().items()
                if name in self.model_names}
        eng = self.engine
        extras = {"optimizer": eng.optimizer.state_dict(), "step": self.step,
                  "patch_generator": eng.patch_generator.get_state()}
        if not self.cfg.no_dropout:
            extras["dropout_generator"] = eng.dropout_generator.get_state()
            extras["dropout_device"] = eng.device.type
        if eng.optimizer_D is not None:
            extras["optimizer_D"] = eng.optimizer_D.state_dict()
        ckpt.save_networks(self.save_dir, epoch, nets, opt_extras=extras)

    def _optim_from_jax(self, tree):
        return dict(convert.adam_states_from_jax(tree["opt_state"],
                                                 self.engine),
                    step=int(np.asarray(tree["step"])))

    def load_networks(self, epoch):
        """The reference's load semantics, with ``--pretrained_name`` (a
        warm start from another experiment); Adam's state, the step and the
        patch generator are restored when every network was loaded.  Data
        parallel, every rank reads the files, and ``parallelize`` then
        checks that they read the same."""
        pretrained = getattr(self.opt, "pretrained_name", None)
        load_dir = (os.path.join(self.opt.checkpoints_dir, pretrained)
                    if pretrained else self.save_dir)
        nets = self._nets()
        loaded = ckpt.load_networks(
            load_dir, epoch, self.model_names,
            msgpack_converter=lambda name, tree: convert.net_state_from_jax(
                self.engine, name, tree),
            verbose=getattr(self.opt, "verbose", False))
        for name, sd in loaded.items():
            convert.load_strict(nets[name], sd)
        optim = ckpt.load_optim(load_dir, epoch,
                                msgpack_converter=self._optim_from_jax)
        if optim is not None and set(self.model_names) >= set(nets):
            eng = self.engine
            eng.optimizer.load_state_dict(optim["optimizer"])
            if eng.optimizer_D is not None:
                eng.optimizer_D.load_state_dict(optim["optimizer_D"])
            self.step = int(optim["step"])
            if "patch_generator" in optim:
                eng.patch_generator.set_state(optim["patch_generator"])
            # a CUDA generator's state means nothing to a CPU one: a run
            # resumed on another device type draws fresh masks
            if optim.get("dropout_device") == eng.device.type:
                eng.dropout_generator.set_state(optim["dropout_generator"])

    # ----------------------------------------------------------------- lr

    def update_learning_rate(self):
        old = self.schedule.current_lr()
        new = self.schedule.step(self.metric)
        print(f"learning rate {old:.7f} -> {new:.7f}")
