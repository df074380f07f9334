"""Pure volumetric registration as a task of the command line (``--model
vxm``; the JAX package's ``models/vxm.py::VxmTask``): classic VoxelMorph
training over paired 3-D volumes (``--dataset_mode volume``), with the
lifecycle of the paper's model, so that ``train.py`` drives it unchanged.
The compute is ``engine.VxmEngine``'s.

netR's weights are drawn from ``--seed`` (``torch.Generator``); the port
cannot draw JAX's streams, so one seed gives different weights in the two
packages.  Checkpoints are ``{epoch}_net_R.pth`` and ``{epoch}_optim.pth``
(Adam's state and the step); where no ``.pth`` exists, the JAX package's
``.msgpack`` is read through ``compat/convert.py``.

Data parallel (``parallelize(mesh)``), as ``models/registration.py``:
each rank steps on its slice of the global batch, rank 0 alone writes.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from dfmir_tpu_torch.compat import convert
from dfmir_tpu_torch.device import resolve_device
from dfmir_tpu_torch.engine import checkpoints as ckpt
from dfmir_tpu_torch.engine.schedules import LRSchedule
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine
from dfmir_tpu_torch.parallel.mesh import barrier, check_share
from dfmir_tpu_torch.utils.util import str2bool


class VxmTask:
    @staticmethod
    def modify_commandline_options(parser, is_train=True):
        parser.add_argument("--ndims", type=int, default=3)
        parser.add_argument("--image_loss", type=str, default="ncc",
                            choices=["ncc", "mse"])
        parser.add_argument("--ncc_win", type=int, default=9)
        parser.add_argument("--lambda_smooth", type=float, default=0.01)
        parser.add_argument("--int_steps", type=int, default=7)
        parser.add_argument("--int_downsize", type=int, default=2)
        parser.add_argument("--bidir", type=str2bool, nargs="?", const=True,
                            default=False)
        parser.add_argument("--remat", type=str2bool, nargs="?", const=True,
                            default=False,
                            help="rematerialize the UNet in backward "
                                 "(O(1) activation memory for 160^3)")
        parser.add_argument("--enc", type=str, default="16,32,32,32")
        parser.add_argument("--dec", type=str,
                            default="32,32,32,32,32,16,16")
        parser.set_defaults(dataset_mode="volume", lr=1e-4)
        return parser

    def __init__(self, opt):
        self.opt = opt
        self.isTrain = getattr(opt, "isTrain", False)
        self.cfg = VxmConfig.from_opt(opt)
        self.device = resolve_device(getattr(opt, "device", None))
        self.engine = VxmEngine(self.cfg, device=self.device,
                                seed=int(getattr(opt, "seed", 0) or 0))
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.loss_names = ["sim", "smooth", "total"]
        self.visual_names = ["source", "target", "registered"]
        self.model_names = ["R"]
        self.schedule = LRSchedule(opt) if self.isTrain else None
        self.mesh = None
        self.metric = 0.0  # plateau-policy input
        self._losses = {}
        self._batch = None
        self.image_paths = None

    @property
    def step(self) -> int:
        return self.engine.step

    def _nets(self):
        return {"R": self.engine.netR}

    # ---------------------------------------------------------- lifecycle

    def data_dependent_initialize(self, data=None):
        """A no-op: netR is built with its shapes in ``__init__``."""

    def setup(self, opt):
        """Loads a checkpoint when resuming (``--continue_train``) or
        testing."""
        self.data_dependent_initialize()
        if (self.isTrain and getattr(opt, "continue_train", False)) \
                or not self.isTrain:
            self.load_networks(opt.epoch)

    def parallelize(self, mesh=None):
        """Data parallel as rank ``mesh.rank`` of ``mesh.world`` (see
        ``models/registration.py``); without a mesh, one device."""
        if mesh is None:
            return
        self.mesh = mesh
        self.engine.data_parallel(mesh)

    def eval(self):
        """A no-op: VxmDense has no dropout or batch norm."""

    # -------------------------------------------------------------- steps

    def set_input(self, batch):
        """Moves the batch's (B, 1, D, H, W) float volumes to the device;
        data parallel, this rank's share of the global batch, as the sliced
        loader gives it."""
        A, B = (torch.as_tensor(np.asarray(batch[k], np.float32))
                for k in ("A", "B"))
        check_share(len(A), self.opt.batch_size, self.mesh)
        self._batch = (A.to(self.device), B.to(self.device))
        self.image_paths = batch.get("A_paths")

    def optimize_parameters(self):
        A, B = self._batch
        self._losses = self.engine.train_step(A, B,
                                              self.schedule.current_lr())

    def test(self):
        A, B = self._batch
        self._losses = self.engine.eval_step(A, B)

    def register_pair(self, A=None, B=None):
        """Inference: (y_source, pos_flow) on the device."""
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
        return OrderedDict((k, float(self._losses[k]))
                           for k in self.loss_names if k in self._losses)

    def compute_visuals(self):
        """A no-op: ``get_current_visuals`` registers the batch itself."""

    def get_current_visuals(self) -> OrderedDict:
        """Mid-depth slices (B, 1, H, W) on the device, mapped from [0, 1]
        to [-1, 1] for ``tensor2im``."""
        A, B = self._batch
        y_source, _ = self.register_pair()

        def mid_slice(v):
            if self.cfg.ndims == 3:
                v = v[:, :, v.shape[2] // 2]
            return v * 2.0 - 1.0

        return OrderedDict([("source", mid_slice(A)),
                            ("target", mid_slice(B)),
                            ("registered", mid_slice(y_source))])

    def get_image_paths(self):
        return self.image_paths

    # -------------------------------------------------------- checkpoints

    def save_networks(self, epoch):
        """Rank 0 writes (every rank calls it); the others wait for it."""
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save_networks(
                self.save_dir, epoch, {"R": self.engine.netR.state_dict()},
                opt_extras={"optimizer": self.engine.optimizer.state_dict(),
                            "step": self.engine.step})
        barrier(self.mesh)

    def _optim_from_jax(self, tree):
        return {"optimizer": convert.vxm_adam_state_from_jax(
                    tree["opt_state"], self.engine),
                "step": int(np.asarray(tree["step"]))}

    def load_networks(self, epoch):
        """netR, Adam's state and the step from ``{epoch}_*.pth``, else
        from the JAX package's ``.msgpack``.  Data parallel, every rank
        reads the files, and ``parallelize`` then checks that they read the
        same."""
        cfg = self.cfg
        loaded = ckpt.load_networks(
            self.save_dir, epoch, self.model_names,
            msgpack_converter=lambda name, tree: convert.netR_state_from_jax(
                tree, cfg.enc, cfg.dec),
            verbose=getattr(self.opt, "verbose", False))
        convert.load_strict(self.engine.netR, loaded["R"])
        optim = ckpt.load_optim(self.save_dir, epoch,
                                msgpack_converter=self._optim_from_jax)
        if optim is not None:
            self.engine.optimizer.load_state_dict(optim["optimizer"])
            self.engine.step = int(optim["step"])

    # ----------------------------------------------------------------- lr

    def update_learning_rate(self):
        old = self.schedule.current_lr()
        new = self.schedule.step(self.metric)
        print(f"learning rate {old:.7f} -> {new:.7f}")
