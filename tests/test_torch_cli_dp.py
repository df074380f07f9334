"""The command line data parallel: ``train.main`` over 2 ``gloo`` ranks on
the CPU (the devices as ``main``'s argument) against one
process on the same flags, B=2 (1 a rank).  The 2-D model on
scripts/make_soak_data.py pairs (crop 64, ngf 8, resnet_4blocks) for 2
epochs, then ``--continue_train`` for one more; the 3-D model on volumes
(24^3, enc (8, 16)) for 1 epoch.  Each writes the one-process run's
files, each loss-log line once, every recorded loss within 1e-3 relative
of the one process's (``--jac_freq``'s field statistics within 1e-5
absolute); its ranks end with equal weights, the ones in
``latest``.  ``--gpu_ids 0,1`` plans a rank a card when the batch divides
over them, else the first card alone."""

import concurrent.futures
import contextlib
import io
import json
import math
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
from dfmir_tpu_torch import train
from dfmir_tpu_torch.options import TrainOptions
from test_torch_cli import few_threads  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMIT = 300.0
CPU2 = ["cpu", "cpu"]
FLAGS_2D = ["--crop_size", "64", "--load_size", "64", "--ngf", "8",
            "--netG", "resnet_4blocks", "--num_patches", "64"]
FLAGS_3D = ["--model", "vxm", "--dataset_mode", "volume", "--vol_size", "24",
            "--enc", "8,16", "--dec", "16,16,8"]
CADENCE = ["--gpu_ids", "-1", "--batch_size", "2", "--save_epoch_freq", "1",
           "--print_freq", "2", "--display_freq", "2", "--jac_freq", "4"]
LOSS_TOL = 1e-3
FIELD_TOL = 1e-5
FIELD_STATS = ("fold", "jac_min", "jac_max", "jac_mean", "flow_max")


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def history(ck):
    return [json.loads(line) for line in
            (ck / "loss_history.jsonl").read_text().splitlines()]


def one_and_two(common, extra):
    """The same run in one process (name ``one``) and over 2 ranks
    (``two``), side by side; (one's result, two's result)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        two = pool.submit(quiet, train.main, common + ["--name", "two"]
                          + extra, devices=CPU2,
                          timeout=LIMIT)
        one = quiet(train.main, common + ["--name", "one"] + extra)
        return one, two.result(timeout=LIMIT + 60)


def assert_runs_agree(ck_dir, two, epochs, steps):
    one_ck, two_ck = ck_dir / "one", ck_dir / "two"
    assert sorted(p.name for p in two_ck.iterdir()) == sorted(
        p.name for p in one_ck.iterdir())
    log = (two_ck / "loss_log.txt").read_text()
    ref_log = (one_ck / "loss_log.txt").read_text()
    assert log.count("Training Loss") == ref_log.count("Training Loss")
    for epoch in epochs:
        assert log.count(f"(epoch: {epoch},") == ref_log.count(
            f"(epoch: {epoch},") > 0
    mine, ref = history(two_ck), history(one_ck)
    assert [r["epoch"] for r in mine] == [r["epoch"] for r in ref]
    for m, r in zip(mine, ref):
        assert m["losses"].keys() == r["losses"].keys()
        for k, v in r["losses"].items():
            # --jac_freq's field statistics (pixels, ratios) to an
            # absolute bar: a 0.002-px flow_max moves by up to 3.2e-7 px,
            # |J| by 1.2e-7, as float32 rounding takes other Adam signs
            bar = FIELD_TOL if k in FIELD_STATS else LOSS_TOL * abs(v)
            assert math.isfinite(m["losses"][k])
            assert abs(m["losses"][k] - v) <= bar, (
                m["epoch"], k, m["losses"][k], v)
    # the replicas end equal, and `latest` holds them
    weights = [r["weights"] for r in two["ranks"]]
    for name, sd in weights[0].items():
        saved = torch.load(two_ck / f"latest_net_{name}.pth",
                           weights_only=True)
        for k, v in sd.items():
            assert torch.equal(weights[1][name][k], v), (name, k)
            assert torch.equal(saved[k], v), (name, k)
    assert len(two["step_s"]) == steps and "model" not in two


@pytest.fixture(scope="module")
def data_2d(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_dp")
    subprocess.run([sys.executable, str(ROOT / "scripts/make_soak_data.py"),
                    "--out", str(tmp / "data"), "--size", "64", "--n_train",
                    "4", "--n_test", "1"], check=True, capture_output=True,
                   timeout=120)
    return tmp


@pytest.fixture(scope="module")
def run_2d(data_2d):
    common = ["--dataroot", str(data_2d / "data"), "--checkpoints_dir",
              str(data_2d / "ck"), *FLAGS_2D, *CADENCE]
    _, two = one_and_two(common, ["--n_epochs", "1", "--n_epochs_decay",
                                  "1"])
    return common, two


def test_2d_over_two_ranks_is_one_process(data_2d, run_2d):
    assert_runs_agree(data_2d / "ck", run_2d[1], (1, 2), 4)


def test_2d_resume_over_two_ranks(data_2d, run_2d):
    common = run_2d[0]
    _, two = one_and_two(common, ["--continue_train", "--epoch_count", "3",
                                  "--n_epochs", "1", "--n_epochs_decay",
                                  "2"])
    assert_runs_agree(data_2d / "ck", two, (1, 2, 3), 2)
    assert (data_2d / "ck" / "two" / "3_net_G.pth").is_file()


def test_3d_over_two_ranks_is_one_process(tmp_path):
    chip_smoke.write_volumes(str(tmp_path / "data"), 4, 1, 24, seed=0)
    common = ["--dataroot", str(tmp_path / "data"), "--checkpoints_dir",
              str(tmp_path / "ck"), *FLAGS_3D, *CADENCE]
    _, two = one_and_two(common, ["--n_epochs", "1", "--n_epochs_decay",
                                  "0"])
    assert_runs_agree(tmp_path / "ck", two, (1,), 2)


@pytest.mark.parametrize("batch,devices", [
    (2, ["cuda:0", "cuda:1"]),      # a rank a card
    (3, ["cuda:0"]),                # 3 does not divide over 2: one card
])
def test_two_cards_plan(tmp_path, monkeypatch, batch, devices):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    argv = ["--dataroot", str(tmp_path), "--name", "plan",
            "--checkpoints_dir", str(tmp_path / "ck"), "--gpu_ids", "0,1",
            "--batch_size", str(batch)]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        opt = TrainOptions(argv).parse()
    assert (opt.devices, opt.device) == (devices, "cuda:0")
    assert ("running on cuda:0 alone" in out.getvalue()) == (batch == 3)
    with pytest.raises(RuntimeError, match="2 CUDA devices"):
        quiet(TrainOptions(argv[:-4] + ["--gpu_ids", "0,2"]).parse)
