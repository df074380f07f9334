"""chip_smoke.py's phases of the 3-D joint model (joint3d, bf16_3d) and of
bfloat16 with the zoo (bf16_zoo), rehearsed on the CPU at small widths
with the kernels swapped for counted plain versions: every check of each
phase runs, and each returns the launches it holds the card to (the 3-D
joint step's B5 among them)."""

import json

import pytest

import chip_smoke
from torch_threads import few_threads  # noqa: F401 (autouse fixture)
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)

# test_torch_joint3d.py's config at 7 integration steps: the full-width
# model, the narrow one and the convergence run all at 16^3 here
SMALL3D = dict(ndims=3, crop_size=16, ngf=8, netG="resnet_2blocks",
               vxm_enc=(4, 4, 4, 4), vxm_dec=(4,) * 7, netF_nc=16,
               num_patches=16)


@pytest.fixture
def small3d(cpu_card, monkeypatch):  # noqa: F811 (the fixture above)
    for name in ("JOINT3D", "JOINT3D_NARROW", "JOINT3D_CONVERGE"):
        monkeypatch.setattr(chip_smoke, name, SMALL3D)
    monkeypatch.setattr(chip_smoke, "JOINT3D_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "JOINT3D_REGISTER_REPS", 1)
    # the profiler's trace times the card's kernels: none here
    monkeypatch.setattr(chip_smoke, "trace",
                        lambda call, calls, warmup=2: {"calls": calls})
    return cpu_card


def lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_joint3d_phase(small3d, capsys):
    launches, reg_ms, step_ms = chip_smoke.phase_joint3d(0, "cpu", False)
    assert launches == {
        "joint3d_register": chip_smoke.add_counts(
            (2, chip_smoke.JOINT3D_REGISTER)),
        "joint3d_train": chip_smoke.add_counts(
            (2, chip_smoke.JOINT3D_STEP))}
    assert launches["joint3d_train"][chip_smoke.DSRC3D] == 2
    line = lines(capsys)[-1]
    assert line["phase"] == "joint3d" and line["labels_kept"] is True
    assert line["pos_flow_max_vox"] > 0.5
    narrow = line["narrow_card_vs_cpu"]
    assert set(narrow["grads"]) == {"netG", "netF", "netR"}
    assert narrow["register_max_abs"]["pos_flow"] == 0.0
    totals = line["converge"]["totals"]
    assert len(totals) == chip_smoke.CONVERGE_STEPS
    assert totals[-1] < totals[0]
    assert reg_ms > 0 and step_ms > 0


def test_bf16_3d_phase(small3d, capsys):
    launches = chip_smoke.phase_bf16_3d(0, "cpu", 1.0, 1.0)
    assert launches["bf16_3d_train"] == chip_smoke.add_counts(
        (2, chip_smoke.JOINT3D_STEP))
    assert launches["bf16_3d_register"] == chip_smoke.add_counts(
        (1, chip_smoke.JOINT3D_REGISTER))
    line = lines(capsys)[-1]
    assert line["phase"] == "bf16_3d" and line["master_dtype"] == "float32"
    assert 0.0 < line["pos_flow_max_vox"] < 0.5
    assert set(line["narrow_card_vs_cpu_bf16"]["metrics_rel"]) >= {
        "G", "NCE", "R", "total"}


def test_bf16_zoo_phase(cpu_card, monkeypatch, capsys):  # noqa: F811
    runs = {k: chip_smoke.ZOO_RUNS[k] for k in (
        "netG_stylegan2", "netR_vxm_dual", "netD_tilestylegan2")}
    monkeypatch.setattr(chip_smoke, "ZOO_RUNS", runs)
    monkeypatch.setattr(chip_smoke, "ZOO_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "ZOO_REGISTER_REPS", 1)
    f32 = {"netG_stylegan2": {"register_ms_b1": 1.0, "ms_per_step_b1": 2.0,
                              "peak_mem_gb_b1": 0.0}}
    out = chip_smoke.phase_bf16_zoo(0, "cpu", f32)
    assert out == {
        "bf16_zoo_register": chip_smoke.add_counts(
            (len(runs), chip_smoke.REGISTER_LAUNCHES)),
        "bf16_zoo_train": chip_smoke.add_counts(
            (2 * len(runs), chip_smoke.STEP_LAUNCHES))}
    got = lines(capsys)
    per_run = {x["run"]: x for x in got if "run" in x}
    assert set(per_run) == set(runs)
    assert per_run["netG_stylegan2"]["f32_ms_per_step_b1"] == 2.0
    assert per_run["netR_vxm_dual"]["f32_ms_per_step_b1"] is None
    for r in per_run.values():
        assert r["narrow_card_vs_cpu_bf16"]["register_max_abs"][
            "pos_flow"] == 0.0
    assert set(got[-1]["runs"]) == set(runs)
