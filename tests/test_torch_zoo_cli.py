"""The zoo through the port's command line on the CPU, and float32 in every
process of the port:

- ``train.main`` for 2 steps with netG stylegan2 (taps 1,2,3), netR
  vxm_transformer, netF reshape and the D phase with netD tilestylegan2,
  on scripts/make_soak_data.py pairs at 64^2; its ``.pth`` checkpoint
  reloads bit-equal (weights, both Adams, the patch generator), and
  ``test.main`` serves it;
- a JAX ``.msgpack`` of a zoo model (netG resnet_cat, netR vxm_dual),
  written by the JAX package's checkpoint code, read by the port's task,
  which registers as JAX's ``register`` does (1e-4 of max(1, |out|));
- ``train.main``, ``test.main`` and ``evaluate.main`` leave both TF32
  flags False after a caller set them True, and a spawned gloo rank
  reports them False;
- chip_smoke.py's phase zoo and its zoo command-line runs, rehearsed with
  the CPU as the card (test_torch_option_phases.py's ``cpu_card``) at the
  narrow width, on a few of the runs: every check runs, and each returns
  the launches it holds the card to.
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dfmir_tpu.engine import checkpoints as jax_ckpt
from dfmir_tpu.engine.config import RegistrationConfig as JaxConfig
from dfmir_tpu.engine.registration import RegistrationModel as JaxModel
from dfmir_tpu_torch import evaluate
from dfmir_tpu_torch import test as test_cli
from dfmir_tpu_torch import train
from dfmir_tpu_torch.compat.convert import to_nchw, to_nhwc
from dfmir_tpu_torch.models.registration import RegistrationTask
from dfmir_tpu_torch.options import TestOptions as PortTestOptions
from dfmir_tpu_torch.options import TrainOptions
from dfmir_tpu_torch.parallel import checks
from dfmir_tpu_torch.parallel.launch import launch
import chip_smoke
from test_torch_cli import few_threads  # noqa: F401 (autouse fixture)
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo_nets import random_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
ZOO = ["--crop_size", "64", "--load_size", "64", "--ngf", "8", "--ndf", "8",
       "--num_patches", "64", "--gpu_ids", "-1", "--netG", "stylegan2",
       "--nce_layers", "1,2,3", "--netR", "vxm_transformer", "--netF",
       "reshape", "--lambda_GAN", "1", "--netD", "tilestylegan2"]


def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo_cli")
    data = tmp / "data"
    subprocess.run([sys.executable, str(ROOT / "scripts/make_soak_data.py"),
                    "--out", str(data), "--size", "64", "--n_train", "2",
                    "--n_test", "1"], check=True, capture_output=True,
                   timeout=120)
    common = ["--dataroot", str(data), "--name", "zoo", "--checkpoints_dir",
              str(tmp / "ck"), *ZOO]
    saved = tf32_flags()
    tf32_on()
    try:
        trained = quiet(train.main, common + [
            "--n_epochs", "1", "--n_epochs_decay", "0", "--save_epoch_freq",
            "1", "--print_freq", "1", "--display_freq", "2"])
        flags = tf32_flags()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    return dict(tmp=tmp, data=data, common=common, trained=trained,
                train_flags=flags)


def test_train_runs_the_zoo_and_reloads_bit_equal(run):
    assert run["train_flags"] == (False, False)
    eng = run["trained"]["model"].engine
    assert type(eng.netG).__name__ == "StyleGAN2Generator"
    assert type(eng.netR).__name__ == "VxmDenseTransformer"
    assert type(eng.netD).__name__ == "TileStyleGAN2Discriminator"
    ck = run["tmp"] / "ck" / "zoo"
    assert {f"latest_net_{n}.pth" for n in "GFRD"} <= set(
        p.name for p in ck.iterdir())
    with contextlib.redirect_stdout(io.StringIO()):
        opt = TrainOptions(run["common"] + ["--continue_train"]).parse()
    opt.isTrain = True
    task = RegistrationTask(opt)
    task.load_networks("latest")
    assert task.step == 2
    for a, b in ((eng.netG, task.engine.netG), (eng.netF, task.engine.netF),
                 (eng.netR, task.engine.netR), (eng.netD, task.engine.netD)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for opt_a, opt_b in ((eng.optimizer, task.engine.optimizer),
                         (eng.optimizer_D, task.engine.optimizer_D)):
        sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
        assert sa.keys() == sb.keys() and len(sa) > 0
        assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa
                   for k in sa[i])
    assert torch.equal(eng.patch_generator.get_state(),
                       task.engine.patch_generator.get_state())


def test_test_main_serves_the_zoo_in_float32(run):
    tf32_on()
    quiet(test_cli.main, ["--dataroot", str(run["data"]), "--name", "zoo",
                          "--checkpoints_dir", str(run["tmp"] / "ck"),
                          "--results_dir", str(run["tmp"] / "res"), *ZOO])
    assert tf32_flags() == (False, False)
    assert any((run["tmp"] / "res").rglob("*.png"))


def test_evaluate_main_and_a_spawned_rank_compute_in_float32(tmp_path):
    tf32_on()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        quiet(evaluate.main, ["--dataroot", str(tmp_path), "--name", "none",
                              "--checkpoints_dir", str(tmp_path),
                              "--gpu_ids", "-1"])
    assert tf32_flags() == (False, False)
    tf32_on()
    (rank,) = launch(checks.run_cases, ["cpu"],
                     args=([("flags", "tf32_flags", {})],), timeout=120)
    assert rank["flags"] == {"cudnn": False, "matmul": False}
    assert tf32_flags() == (True, True)      # the parent's own are its own
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


# a narrow netR integrating in 2 steps: a cheaper JAX compile
ZOO_JAX = dict(crop_size=64, ngf=8, netG="resnet_cat",
               nce_layers=(0, 1, 2, 3), netR="vxm_dual", int_steps=2,
               vxm_enc=(8, 16, 16, 16), vxm_dec=(16, 16, 16, 16, 16, 8, 8))


def test_port_reads_a_jax_msgpack_of_a_zoo_model(tmp_path):
    jm = JaxModel(JaxConfig(**ZOO_JAX))
    shapes = jax.eval_shape(jm.init_state, jax.random.PRNGKey(0)).params
    params = {k: random_params(shapes[k], seed=i)
              for i, k in enumerate("GR")}
    params["R"]["flow"]["kernel"] *= 4.0     # displacements of pixels
    jax_ckpt.save_networks(str(tmp_path / "ck" / "jx"), "latest", params)
    argv = ["--dataroot", str(tmp_path), "--name", "jx", "--checkpoints_dir",
            str(tmp_path / "ck"), "--gpu_ids", "-1", "--crop_size", "64",
            "--ngf", "8", "--netG", "resnet_cat", "--nce_layers", "0,1,2,3",
            "--netR", "vxm_dual"]
    with contextlib.redirect_stdout(io.StringIO()):
        opt = PortTestOptions(argv).parse()
    for k in ("vxm_enc", "vxm_dec", "int_steps"):
        setattr(opt, k, ZOO_JAX[k])
    task = RegistrationTask(opt)
    with contextlib.redirect_stdout(io.StringIO()):
        task.setup(opt)
    rng = np.random.default_rng(3)
    a, b = (np.tanh(2 * rng.standard_normal((1, 64, 64, 1))).astype(
        np.float32) for _ in range(2))
    want = jm.register(jax.tree.map(jnp.asarray, params), jnp.asarray(a),
                       jnp.asarray(b))
    with torch.no_grad():
        got = task.register_pair(torch.from_numpy(to_nchw(a)),
                                 torch.from_numpy(to_nchw(b)))
    assert float(np.abs(np.asarray(want[3])).max()) > 0.5   # it deforms
    for name, g, w in zip(("fake_B", "idt_B", "y_source", "pos_flow"), got,
                          want):
        w = np.asarray(w)
        err = float(np.abs(to_nhwc(g) - w).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), (name, err)


def test_zoo_phase_on_the_cpu(cpu_card, monkeypatch, capsys):
    runs = {k: chip_smoke.ZOO_RUNS[k] for k in (
        "netG_stylegan2", "netD_tilestylegan2")}
    monkeypatch.setattr(chip_smoke, "ZOO_RUNS", runs)
    monkeypatch.setattr(chip_smoke, "ZOO_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "ZOO_REGISTER_REPS", 1)
    out = chip_smoke.phase_zoo(0, "cpu", 1.0, 1.0)
    assert out == {
        "zoo_register": chip_smoke.add_counts(
            (len(runs), chip_smoke.REGISTER_LAUNCHES)),
        "zoo_train": chip_smoke.add_counts(
            (2 * len(runs), chip_smoke.STEP_LAUNCHES))}
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    per_run = {x["run"]: x for x in lines if "run" in x}
    assert set(per_run) == set(runs)
    assert per_run["netG_stylegan2"]["register_card_vs_cpu_max_abs"][
        "pos_flow"] == 0.0
    assert per_run["netD_tilestylegan2"]["register_card_vs_cpu_max_abs"] \
        is None
    assert set(per_run["netD_tilestylegan2"]["narrow_step_card_vs_cpu"][
        "grads"]) == {"netG", "netF", "netR", "netD"}
    assert set(lines[-1]["runs"]) == set(runs)


def test_cli_zoo_runs_on_the_cpu(cpu_card, monkeypatch, tmp_path):
    data, ck_dir = str(tmp_path / "data"), str(tmp_path / "ck")
    chip_smoke.write_cli_data(data, 0, 64)
    common = ["--dataroot", data, "--checkpoints_dir", ck_dir, "--seed", "0",
              "--crop_size", "64", "--load_size", "64", "--ngf", "8",
              "--ndf", "8", "--num_patches", "16", "--netF_nc", "16"]
    # unet_256 needs a side of 2^8: its run takes resnet_cat at crop 64
    # (and the dual-encoder netR, cheaper on the CPU than the GPT one)
    monkeypatch.setitem(chip_smoke.CLI_ZOO_RUNS, "cli_zoo_unet", [
        "--netG", "resnet_cat", "--nce_layers", "0,1,2,3", "--netR",
        "vxm_dual", "--netF", "reshape"])
    with open(tmp_path / "cli.log", "w") as log, \
            contextlib.redirect_stdout(io.StringIO()):
        out = chip_smoke.cli_zoo_paths(str(tmp_path), log, common,
                                       ["--gpu_ids", "-1"], ck_dir)
    n = chip_smoke.CLI_OPTION_STEPS
    for name in chip_smoke.CLI_ZOO_RUNS:
        assert out["launches"][name] == chip_smoke.add_counts(
            (n, chip_smoke.STEP_LAUNCHES))
        assert out["launches"][f"{name}_test"] == chip_smoke.add_counts(
            (1, chip_smoke.TEST_PAIR_LAUNCHES))
        assert out["summary"][name]["reload_tensors_equal"] > 0
    assert out["summary"]["cli_zoo_stylegan2"]["reload_has_adamD"]
    assert "G_GAN" in out["summary"]["cli_zoo_stylegan2"]["losses_last"]
