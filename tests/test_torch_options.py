"""The port's command line (dfmir_tpu_torch/options/) against the JAX
package's: the same argv gives the same ``vars(opt)`` for Train and Test
options, CUT and FastCUT, but for the devices (the port adds
``opt.device``, "cpu" for --gpu_ids -1, and ``opt.devices``, its data
parallel plan); ``RegistrationConfig.from_opt``
equals JAX's field by field; so do the 3-D command line's options (--model
vxm, --dataset_mode volume) and ``VxmConfig.from_opt``; the device rules
and the modes the port does not have yet raise."""

import argparse
import contextlib
import dataclasses
import io

import pytest

from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.vxm_engine import VxmConfig as JaxVxmConfig
from dfmir_tpu.options import TestOptions as JaxTestOptions
from dfmir_tpu.options import TrainOptions as JaxTrainOptions
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig
from dfmir_tpu_torch.options import TestOptions, TrainOptions

# the only keys that differ, and why: the port resolves its devices once,
# where the JAX package hands device choice to jax.config
PORT_ONLY = {"device", "devices"}


def parse(cls, argv):
    """The JAX package takes its command line as one string."""
    if cls in (JaxTrainOptions, JaxTestOptions):
        argv = " ".join(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        return cls(argv).parse()


def base_argv(tmp_path, *extra):
    return ["--dataroot", str(tmp_path / "data"), "--name", "exp",
            "--checkpoints_dir", str(tmp_path / "ck"), "--gpu_ids", "-1",
            *extra]


ARGVS = {
    "cut_defaults": (),
    "cut_small": ("--crop_size", "64", "--ngf", "8", "--netG",
                  "resnet_4blocks", "--num_patches", "64", "--batch_size",
                  "2", "--nce_layers", "0,4,8"),
    "fastcut": ("--CUT_mode", "FastCUT"),
    "fastcut_overrides": ("--CUT_mode", "fastcut", "--lambda_NCE", "2.0",
                          "--nce_idt", "true", "--num_patches", "32"),
    "flags": ("--no_flip", "--serial_batches", "--uint8_transfer", "false",
              "--no_dropout", "--netF", "sample", "--suffix",
              "{netG}_{crop_size}", "--epoch", "3", "--direction", "BtoA"),
}


@pytest.mark.parametrize("kind", ["train", "test"])
@pytest.mark.parametrize("case", list(ARGVS))
def test_same_argv_same_options(tmp_path, case, kind):
    argv = base_argv(tmp_path, *ARGVS[case])
    mine_cls, ref_cls = ((TrainOptions, JaxTrainOptions) if kind == "train"
                         else (TestOptions, JaxTestOptions))
    mine, ref = vars(parse(mine_cls, argv)), vars(parse(ref_cls, argv))
    assert set(mine) - set(ref) == PORT_ONLY and set(ref) <= set(mine)
    differ = {k: (mine[k], ref[k]) for k in ref if mine[k] != ref[k]}
    assert differ == {}
    assert mine["device"] == "cpu" and mine["gpu_ids"] == []
    assert (tmp_path / "ck" / mine["name"] / f"{kind}_opt.txt").is_file()
    cfg = RegistrationConfig.from_opt(argparse.Namespace(**mine))
    jcfg = JaxConfig.from_opt(argparse.Namespace(**ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert {f.name for f in dataclasses.fields(cfg)} == {
        f.name for f in dataclasses.fields(jcfg)}


def test_cut_and_fastcut_defaults(tmp_path):
    cut = parse(TrainOptions, base_argv(tmp_path))
    assert (cut.nce_idt, cut.lambda_NCE, cut.flip_equivariance) == (
        True, 0.25, False)
    fast = parse(TrainOptions, base_argv(tmp_path, "--CUT_mode", "FastCUT"))
    assert (fast.nce_idt, fast.lambda_NCE, fast.flip_equivariance,
            fast.n_epochs, fast.n_epochs_decay) == (False, 10.0, True, 150,
                                                    50)
    test = parse(TestOptions, base_argv(tmp_path, "--crop_size", "128"))
    assert test.isTrain is False and test.load_size == 256
    suffix = parse(TrainOptions, base_argv(tmp_path, "--suffix", "{model}"))
    assert suffix.name == "exp_registration"


def test_a_card_is_required_unless_the_cpu_is_named(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = base_argv(tmp_path)[:-2]
    with pytest.raises(RuntimeError, match="gpu_ids -1"):
        parse(TrainOptions, argv)                      # default --gpu_ids 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert parse(TrainOptions, argv + ["--gpu_ids", "1"]).device == "cuda:1"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = parse(TrainOptions, argv + ["--gpu_ids", "0,1", "--batch_size",
                                      "2"])
    assert (two.devices, two.device) == (["cuda:0", "cuda:1"], "cuda:0")


@pytest.mark.parametrize("flags,match", [
    (("--dataset_mode", "patient_site"), "A13"),
    (("--dataset_mode", "triplet"), "A13"),
])
def test_modes_not_ported_raise(tmp_path, flags, match):
    with pytest.raises(NotImplementedError, match=match):
        parse(TrainOptions, base_argv(tmp_path, *flags))


ARGVS_3D = {
    "vxm_defaults": ("--model", "vxm"),
    "vxm_small": ("--model", "vxm", "--vol_size", "64", "--enc", "8,16",
                  "--dec", "16,16,8", "--image_loss", "mse", "--bidir",
                  "--lambda_smooth", "0.02",
                  "--compute_dtype", "bfloat16"),
    "volume_mode": ("--dataset_mode", "volume", "--vol_size", "96"),
}


@pytest.mark.parametrize("kind", ["train", "test"])
@pytest.mark.parametrize("case", list(ARGVS_3D))
def test_3d_modes_parse_as_jax(tmp_path, case, kind):
    """--model vxm and --dataset_mode volume (the 3-D command line): the
    same options as the JAX package's, and the same VxmConfig."""
    argv = base_argv(tmp_path, *ARGVS_3D[case])
    mine_cls, ref_cls = ((TrainOptions, JaxTrainOptions) if kind == "train"
                         else (TestOptions, JaxTestOptions))
    mine, ref = vars(parse(mine_cls, argv)), vars(parse(ref_cls, argv))
    assert set(mine) - set(ref) == PORT_ONLY and set(ref) <= set(mine)
    assert {k: (mine[k], ref[k]) for k in ref if mine[k] != ref[k]} == {}
    assert mine["dataset_mode"] == "volume"
    assert mine["vol_size"] == {"vxm_small": 64, "volume_mode": 96}.get(
        case, 160)
    if case != "volume_mode":
        assert mine["model"] == "vxm"
        assert mine.get("lr", 1e-4) == 1e-4   # the task's default (train)
    cfg = VxmConfig.from_opt(argparse.Namespace(**mine))
    jcfg = JaxVxmConfig.from_opt(argparse.Namespace(**ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_help_lists_the_flags(capsys):
    """As in the JAX package, --help stops at the first of the two passes,
    before the model's flags join."""
    with pytest.raises(SystemExit) as ex:
        TrainOptions(["--help"]).parse()
    assert ex.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--continue_train", "--gpu_ids", "--crop_size",
                 "--cache_images_mb", "--profile_dir", "--jac_freq"):
        assert flag in out
