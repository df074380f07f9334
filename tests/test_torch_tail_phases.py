"""chip_smoke.py's phases of the slice's tail (augment, affine, losses,
cli_modes), rehearsed on the CPU at small sizes with the kernels swapped
for counted plain versions: every check of each phase runs, and each
returns the launches it holds the card to."""

import contextlib
import io
import json

import pytest

import chip_smoke
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

VF, FWD = chip_smoke.VF, chip_smoke.FWD
VF3, FWD3D = chip_smoke.VF3, chip_smoke.FWD3D


@pytest.fixture
def small(cpu_card, monkeypatch):
    monkeypatch.setattr(chip_smoke, "AUG_SHAPES",
                        {"augment2d": (2, 1, 64, 64),
                         "augment3d": (1, 1, 24, 24, 24)})
    monkeypatch.setattr(chip_smoke, "AFFINE_CASES",
                        {"affine2d": ((2, 1, 64, 64), "NCC"),
                         "affine3d": ((1, 1, 24, 24, 24), "L2")})
    monkeypatch.setattr(chip_smoke, "LOSS_B", 2)
    monkeypatch.setattr(chip_smoke, "LOSS_S", 32)
    monkeypatch.setattr(chip_smoke, "LOSS_V", 16)
    monkeypatch.setattr(chip_smoke, "CLI_GPU", "-1")
    monkeypatch.setattr(chip_smoke, "CLI_SIZE", 64)
    monkeypatch.setattr(chip_smoke, "CLI_FLAGS", [
        "--crop_size", "64", "--load_size", "64", "--ngf", "8", "--netG",
        "resnet_4blocks", "--num_patches", "16", "--netF_nc", "16"])
    return cpu_card


def lines(capsys, phase):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{") and json.loads(x).get("phase") == phase]


def test_augment_phase(small, capsys):
    launches = chip_smoke.phase_augment(0, "cpu")
    zero = chip_smoke.ZERO
    assert launches == {"augment2d": dict(zero, **{VF: 1, FWD: 1}),
                        "augment3d": dict(zero, **{VF3: 1, FWD3D: 1})}
    rows = [r for r in lines(capsys, "augment") if "case" in r]
    assert [r["case"] for r in rows] == ["augment2d", "augment3d"]
    for r in rows:
        assert r["labels_kept"] and r["finite"] and r["flow_max_px"] > 1
        assert r["card_vs_cpu_max_abs"]["image"] == 0.0
        assert r["svf_size"] == [max(s // 8, 2) for s in r["shape"][2:]]


def test_affine_phase(small, capsys):
    ms = chip_smoke.phase_affine(0, "cpu")
    assert set(ms) == {"affine2d", "affine3d"}
    for r in lines(capsys, "affine"):
        assert len(r["losses"]) == chip_smoke.AFFINE_STEPS
        assert r["losses"][-1] < r["losses"][0]
        assert r["card_vs_cpu_loss_rel"] == [0.0, 0.0]
        assert r["grad_err_over_max"] == [0.0, 0.0]
        assert r["step2_tensors_with_grad"][0] == \
            r["step2_tensors_with_grad"][1] == 10
        assert r["launches"] == chip_smoke.ZERO
        cond = r["ncc_f32_vs_f64_cpu"]
        assert (cond is None) == (r["loss"] != "NCC")
        assert cond is None or set(cond) == {"integral", "conv"}


def test_losses_phase(small, capsys):
    rows = chip_smoke.phase_losses(0, "cpu")
    assert set(chip_smoke.DICT_LOSSES) < set(rows)
    assert {"smooth_loss_3d", "NMI_3d", "nt_xent", "deepsim"} <= set(rows)
    assert all(r["rel_err"] == 0.0 for r in rows.values())
    assert lines(capsys, "losses")[0]["tol"] == chip_smoke.LOSS_TOL


def test_cli_modes_phase(small, capsys):
    with contextlib.redirect_stderr(io.StringIO()):
        launches = chip_smoke.phase_cli_modes(0, "cpu")
    step = chip_smoke.add_counts((2, chip_smoke.STEP_LAUNCHES))
    assert launches == {
        "cli_patient_site": step, "cli_triplet": step,
        "cli_triplet_test": chip_smoke.add_counts(
            (chip_smoke.MODES_TEST, chip_smoke.TEST_PAIR_LAUNCHES))}
    row, = lines(capsys, "cli_modes")
    display = row["runs"]["triplet"]["display"]
    assert display["host"] == "127.0.0.1" and display["records"] == 2
    assert row["runs"]["patient_site"]["steps"] == 2
