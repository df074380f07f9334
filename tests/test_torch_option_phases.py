"""chip_smoke.py's phases of the training options (fastcut, gan, bf16,
dropout) and the command line's FastCUT and GAN runs, rehearsed on the
CPU at the CPU tests' width (crop 64, resnet_4blocks, ngf 8) with the
kernels swapped for counted plain versions: every check of each phase
runs, and each returns the launches it holds the card to."""

import contextlib
import io
import json
import os
import time

import pytest
import torch

import chip_smoke
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

STEP = chip_smoke.STEP_LAUNCHES


@pytest.fixture
def cpu_card(counted_kernels, monkeypatch):
    """The CPU standing in for the card, at the small width."""
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)

    def host_ms(fn, reps=100, warmup=10):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "time_ms", host_ms)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "N_PAIRS", 2)
    monkeypatch.setattr(chip_smoke, "WIDTH", chip_smoke.SMALL)
    return counted_kernels


def last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_fastcut_phase(cpu_card, capsys):
    launches, ms = chip_smoke.phase_fastcut(0, "cpu", 1.0)
    assert launches == chip_smoke.add_counts((3, STEP))
    line = last_line(capsys)
    assert line["phase"] == "fastcut" and line["flip_equivariance"] is True
    assert set(line["card_vs_cpu_rel_by_coin"]) == {"False", "True"}
    assert line["steps"] == 3 and "NCE_Y" not in line["metrics_last"]


def test_gan_phase(cpu_card, capsys):
    launches, _ = chip_smoke.phase_gan(0, "cpu", 1.0)
    assert launches == chip_smoke.add_counts((3, STEP))
    line = last_line(capsys)
    assert {"G_GAN", "D", "D_fake", "D_real"} <= set(
        line["first_step_card_vs_cpu_rel"])
    assert line["netD_tensors_moved"] > 0


def test_bf16_phase(cpu_card, capsys):
    reg, step, reg_ms, step_ms = chip_smoke.phase_bf16(0, "cpu", 1.0, 1.0)
    assert reg == chip_smoke.add_counts((2, chip_smoke.REGISTER_LAUNCHES))
    assert step == chip_smoke.add_counts((3, STEP))
    line = last_line(capsys)
    assert set(line["output_dtypes"].values()) == {"torch.float32"}
    assert line["register_card_vs_cpu_max_abs"]["pos_flow"] == 0.0


def test_dropout_phase(cpu_card, capsys):
    launches = chip_smoke.phase_dropout(0, "cpu")
    assert launches == chip_smoke.add_counts((2, STEP))
    line = last_line(capsys)
    assert line["reseeded_masks_equal"] is True
    assert abs(line["keep_rate"] - 0.5) <= line["keep_bound"]
    assert line["register_vs_no_dropout_max_abs"] == 0.0
    assert set(line["eval_paths_keep_rate"]) == {"eval_step",
                                                 "compute_visuals"}


def test_cli_option_runs(cpu_card, tmp_path):
    data, ck_dir = str(tmp_path / "data"), str(tmp_path / "ck")
    chip_smoke.write_cli_data(data, 0, 64)
    common = ["--dataroot", data, "--checkpoints_dir", ck_dir, "--seed", "0",
              "--crop_size", "64", "--load_size", "64", "--ngf", "8",
              "--netG", "resnet_4blocks", "--num_patches", "16",
              "--netF_nc", "16"]
    with open(tmp_path / "cli.log", "w") as log, \
            contextlib.redirect_stdout(io.StringIO()):
        out = chip_smoke.cli_option_paths(str(tmp_path), log, common,
                                          ["--gpu_ids", "-1"], ck_dir)
    n = chip_smoke.CLI_OPTION_STEPS
    for name in chip_smoke.CLI_OPTION_RUNS:
        assert out["launches"][name] == chip_smoke.add_counts((n, STEP))
        assert out["summary"][name]["steps"] == n
    assert out["launches"]["cli_gan_test"] == chip_smoke.add_counts(
        (1, chip_smoke.TEST_PAIR_LAUNCHES))
    assert "NCE_Y" not in out["summary"]["cli_fastcut"]["losses_last"]
    assert {"G_GAN", "D"} <= set(out["summary"]["cli_gan"]["losses_last"])
    assert out["summary"]["cli_gan"]["reload_tensors_equal"] > 0
    assert os.path.isfile(os.path.join(ck_dir, "cli_gan", "1_net_D.pth"))
