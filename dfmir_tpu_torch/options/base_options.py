"""Shared command-line flags and two-pass registry-driven parsing (the JAX
package's ``options/base_options.py``): the same flags, names, defaults
and choices, so that a command line of the JAX package is one of the port.

The devices: ``--gpu_ids -1`` runs on the CPU, one id ``N`` on
``cuda:N`` (which raises without a card), more than one id trains data
parallel, one process a card (``parallel/``), when ``--batch_size``
divides over them, as the JAX package shards its batch over its devices
then; otherwise on the first id alone, which ``parse`` prints.  ``parse``
sets ``opt.devices`` to that list and ``opt.device`` to its first entry,
``"cpu"`` or ``"cuda:N"``; ``test.py`` and ``evaluate.py`` run on
``opt.device``.  Parsed options are written to
``{checkpoints_dir}/{name}/{phase}_opt.txt``.
"""

from __future__ import annotations

import argparse
import os

import torch

from dfmir_tpu_torch.utils.util import mkdirs, str2bool


def device_from_gpu_ids(gpu_ids) -> str:
    """``"cpu"`` for no id, ``"cuda:N"`` for the first; raises without a
    card."""
    if not gpu_ids:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--gpu_ids {','.join(map(str, gpu_ids))}: no CUDA device is "
            f"available; pass --gpu_ids -1 to run on the CPU")
    return f"cuda:{gpu_ids[0]}"


def device_plan(gpu_ids, batch_size: int):
    """The devices a run trains on: one rank a card when more than one id
    is given and ``batch_size`` divides over them (the JAX package's rule
    in ``parallelize``), else the first id alone, saying why."""
    first = device_from_gpu_ids(gpu_ids)
    if len(gpu_ids) < 2:
        return [first]
    ids = ",".join(map(str, gpu_ids))
    if len(set(gpu_ids)) != len(gpu_ids):
        raise ValueError(f"--gpu_ids {ids}: an id more than once")
    cards = torch.cuda.device_count()
    if max(gpu_ids) >= cards:
        raise RuntimeError(f"--gpu_ids {ids}: {cards} CUDA devices")
    if batch_size % len(gpu_ids):
        print(f"--batch_size {batch_size} does not divide over the "
              f"{len(gpu_ids)} cards of --gpu_ids {ids}: running on "
              f"{first} alone")
        return [first]
    return [f"cuda:{i}" for i in gpu_ids]


class BaseOptions:
    def __init__(self, cmd_line=None):
        """``cmd_line``: the arguments, as one string or a list (None: the
        process's own)."""
        self.initialized = False
        if isinstance(cmd_line, str):
            cmd_line = cmd_line.split()
        self.cmd_line = list(cmd_line) if cmd_line is not None else None

    def initialize(self, parser: argparse.ArgumentParser):
        # basic parameters
        parser.add_argument("--dataroot", default="placeholder",
                            help="path to images (should have subfolders "
                                 "trainA, trainB, valA, valB, etc)")
        parser.add_argument("--name", type=str, default="experiment_name",
                            help="name of the experiment")
        parser.add_argument("--easy_label", type=str,
                            default="experiment_name")
        parser.add_argument("--gpu_ids", type=str, default="0",
                            help="-1: the CPU; one id N: cuda:N; N,M,...: "
                                 "one process a card, the batch split "
                                 "over them")
        parser.add_argument("--checkpoints_dir", type=str,
                            default="./checkpoints")
        parser.add_argument("--seed", type=int, default=0,
                            help="global RNG seed (data aug + init)")
        # model parameters
        parser.add_argument("--model", type=str, default="registration")
        parser.add_argument("--input_nc", type=int, default=1)
        parser.add_argument("--output_nc", type=int, default=1)
        parser.add_argument("--ngf", type=int, default=64)
        parser.add_argument("--ndf", type=int, default=64)
        parser.add_argument("--netD", type=str, default="basic",
                            choices=["basic", "n_layers", "pixel", "patch",
                                     "stylegan2", "tilestylegan2",
                                     "patchstylegan2"])
        parser.add_argument("--netG", type=str, default="resnet_9blocks",
                            choices=["resnet_9blocks", "resnet_6blocks",
                                     "resnet_4blocks", "unet_256",
                                     "unet_128", "stylegan2",
                                     "smallstylegan2", "resnet_cat"])
        parser.add_argument("--D_patch_size", type=int, default=64,
                            help="tile size for tilestylegan2 netD")
        parser.add_argument("--n_layers_D", type=int, default=3)
        parser.add_argument("--normG", type=str, default="instance",
                            choices=["instance", "batch", "none"])
        parser.add_argument("--normD", type=str, default="instance",
                            choices=["instance", "batch", "none"])
        parser.add_argument("--init_type", type=str, default="xavier",
                            choices=["normal", "xavier", "kaiming",
                                     "orthogonal"])
        parser.add_argument("--init_gain", type=float, default=0.02)
        parser.add_argument("--no_dropout", type=str2bool, nargs="?",
                            const=True, default=True)
        parser.add_argument("--no_antialias", action="store_true")
        parser.add_argument("--no_antialias_up", action="store_true")
        parser.add_argument("--compute_dtype", type=str, default="float32",
                            choices=["float32", "bfloat16"],
                            help="conv compute dtype (flow math stays f32)")
        # dataset parameters
        parser.add_argument("--dataset_mode", type=str, default="unaligned")
        parser.add_argument("--direction", type=str, default="AtoB")
        parser.add_argument("--serial_batches", action="store_true")
        parser.add_argument("--num_threads", default=0, type=int)
        parser.add_argument("--cache_images_mb", type=float, default=512,
                            help="cache decoded images in host RAM up to "
                                 "this many MB (0 disables); epochs re-read "
                                 "the same files")
        parser.add_argument("--uint8_transfer", type=str2bool, nargs="?",
                            const=True, default=True,
                            help="ship image batches host->device as raw "
                                 "uint8 pixels and normalize on device "
                                 "(within 1 ulp of the float path, 4x less "
                                 "transfer)")
        parser.add_argument("--batch_size", type=int, default=1)
        parser.add_argument("--load_size", type=int, default=256)
        parser.add_argument("--crop_size", type=int, default=256)
        parser.add_argument("--max_dataset_size", type=int,
                            default=float("inf"))
        parser.add_argument("--preprocess", type=str,
                            default="resize_and_crop")
        parser.add_argument("--no_flip", action="store_true")
        parser.add_argument("--display_winsize", type=int, default=256)
        parser.add_argument("--random_scale_max", type=float, default=3.0)
        # additional parameters
        parser.add_argument("--stylegan2_G_num_downsampling", type=int,
                            default=1)
        parser.add_argument("--epoch", type=str, default="latest")
        parser.add_argument("--verbose", action="store_true")
        parser.add_argument("--suffix", default="", type=str)
        self.initialized = True
        return parser

    def gather_options(self):
        import sys

        from dfmir_tpu_torch import data, models

        if not self.initialized:
            parser = argparse.ArgumentParser(
                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
            parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(self.cmd_line)

        # Option setters may re-parse to branch on flags (e.g. --CUT_mode);
        # make sure they see cmd_line when one was given.
        argv_saved = sys.argv
        if self.cmd_line is not None:
            sys.argv = [argv_saved[0]] + self.cmd_line
        try:
            model_option_setter = models.get_option_setter(opt.model)
            parser = model_option_setter(parser, self.isTrain)
            opt, _ = parser.parse_known_args(self.cmd_line)

            dataset_option_setter = data.get_option_setter(opt.dataset_mode)
            parser = dataset_option_setter(parser, self.isTrain)
        finally:
            sys.argv = argv_saved

        self.parser = parser
        return parser.parse_args(self.cmd_line)

    def print_options(self, opt) -> None:
        message = "----------------- Options ---------------\n"
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = f"\t[default: {default}]"
            message += f"{str(k):>25}: {str(v):<30}{comment}\n"
        message += "----------------- End -------------------"
        print(message)
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        mkdirs(expr_dir)
        file_name = os.path.join(expr_dir, f"{opt.phase}_opt.txt")
        try:
            with open(file_name, "w") as f:
                f.write(message + "\n")
        except PermissionError as err:
            print(f"permission error {err}")

    def parse(self):
        opt = self.gather_options()
        opt.isTrain = self.isTrain
        if opt.suffix:
            opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
        self.print_options(opt)
        str_ids = str(opt.gpu_ids).split(",")
        opt.gpu_ids = [int(i) for i in str_ids if int(i) >= 0]
        opt.devices = device_plan(opt.gpu_ids, opt.batch_size)
        opt.device = opt.devices[0]
        self.opt = opt
        return opt
