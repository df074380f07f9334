"""The command line on the card (needs CUDA; skips without it): chip_smoke's
cli phase at crop 64 (full-width networks, 64^2 pairs it writes itself) -
train at B=1 with exact kernel launches, a bit-equal reload, resume, card
against CPU within 1e-3, test with exact launches and label values kept,
a finite evaluate summary, 2 steps each of --CUT_mode FastCUT,
--lambda_GAN 1 and the two zoo runs with exact launches (the GAN and
zoo runs reloaded bit-equal, their tests), train at B=8; and its cli3d phase at --vol_size
64 (the 3-D task's full-width netR, 64^3 volumes it writes itself) -
train with exact launches, a bit-equal reload, resume, card against CPU
within 1e-3, evaluate --ndims 3 with exact launches and a finite summary.

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_cli_gpu.py
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cli_phase_at_crop_64(cuda, monkeypatch):
    monkeypatch.setattr(chip_smoke, "CLI_SIZE", 64)
    monkeypatch.setattr(chip_smoke, "CLI_FLAGS", [
        "--crop_size", "64", "--load_size", "64", "--num_patches", "64"])
    # unet_256 needs a side of 2^8: its run takes resnet_cat at crop 64
    monkeypatch.setitem(chip_smoke.CLI_ZOO_RUNS, "cli_zoo_unet", [
        "--netG", "resnet_cat", "--nce_layers", "0,1,2,3", "--netR",
        "vxm_transformer", "--netF", "reshape"])
    launches = chip_smoke.phase_cli(0, torch.cuda.get_device_name(0), None)
    steps = chip_smoke.CLI_MAX * 2
    assert launches["cli_train"] == chip_smoke.cli_train_launches(
        steps, 1, chip_smoke.CLI_DISPLAY, chip_smoke.CLI_PRINT,
        chip_smoke.CLI_JAC)
    assert launches["cli_test"] == chip_smoke.add_counts(
        (chip_smoke.CLI_TEST, chip_smoke.TEST_PAIR_LAUNCHES))
    for name in (*chip_smoke.CLI_OPTION_RUNS, *chip_smoke.CLI_ZOO_RUNS):
        assert launches[name] == chip_smoke.add_counts(
            (chip_smoke.CLI_OPTION_STEPS, chip_smoke.STEP_LAUNCHES))
    for name in ("cli_gan", *chip_smoke.CLI_ZOO_RUNS):
        assert launches[f"{name}_test"] == chip_smoke.add_counts(
            (1, chip_smoke.TEST_PAIR_LAUNCHES))


def test_cli3d_phase_at_vol_64(cuda, monkeypatch):
    monkeypatch.setattr(chip_smoke, "CLI3D_SIZE", 64)
    launches = chip_smoke.phase_cli3d(0, torch.cuda.get_device_name(0), None)
    assert launches["cli3d_train"] == chip_smoke.cli3d_train_launches(
        2 * chip_smoke.CLI3D_TRAIN, chip_smoke.CLI3D_DISPLAY,
        chip_smoke.CLI3D_PRINT, chip_smoke.CLI3D_JAC)
    assert launches["cli3d_eval"] == chip_smoke.add_counts(
        (chip_smoke.CLI3D_TEST, chip_smoke.EVAL3D_PAIR_LAUNCHES))
