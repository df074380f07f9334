"""chip_smoke.py's phase zoo3d (the 3-D zoo in the joint model) rehearsed
on the CPU at 16^3 with the kernels swapped for counted plain versions:
every check of the phase runs for a unet (shallowed to 4 levels, as the
parity tests run it), both netF heads, vxm_dual and a netD, with a run
whose change sets its cube and one through the skip of the narrow check
(as strided_conv's and unet_256's on the card); the phase returns the
launches it holds the card to."""

import json

import pytest

import chip_smoke
from test_torch_joint3d_phases import SMALL3D
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from test_torch_zoo3d_train import STRIDED_LAYERS, shallow_unet
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

RUNS = {"netG_unet_128": dict(netG="unet_128", nce_layers=(0, 1, 2, 3)),
        "netF_global_pool": dict(netF="global_pool"),
        "netF_strided_conv": dict(netF="strided_conv", crop_size=16,
                                  nce_layers=STRIDED_LAYERS),
        "netR_vxm_dual": dict(netR="vxm_dual"),
        "netD_pixel": dict(lambda_GAN=1.0, netD="pixel")}


@pytest.fixture
def small_zoo3d(cpu_card, monkeypatch):  # noqa: F811 (the fixture above)
    for name in ("JOINT3D", "JOINT3D_NARROW"):
        monkeypatch.setattr(chip_smoke, name, SMALL3D)
    monkeypatch.setattr(chip_smoke, "ZOO3D_RUNS", RUNS)
    monkeypatch.setattr(chip_smoke, "JOINT3D_REGISTER_REPS", 1)
    monkeypatch.setattr(chip_smoke, "ZOO3D_STEPS", 1)
    monkeypatch.setattr(chip_smoke, "ZOO3D_NARROW_CROP",
                        {"netR_vxm_dual": 32})
    monkeypatch.setattr(chip_smoke, "ZOO3D_NARROW_SKIP",
                        {"netF_global_pool": "netR_vxm_dual"})
    with shallow_unet(SMALL3D):
        yield cpu_card


def test_zoo3d_phase(small_zoo3d, capsys):
    out = chip_smoke.phase_zoo3d(0, "cpu", 1.0, 2.0)
    n = len(RUNS)
    steps = 1 + chip_smoke.ZOO3D_STEPS
    bf16_steps = 1 + chip_smoke.ZOO3D_BF16_STEPS
    assert out == {
        "zoo3d_register": chip_smoke.add_counts(
            (n, chip_smoke.JOINT3D_REGISTER)),
        "zoo3d_train": chip_smoke.add_counts(
            (n * steps, chip_smoke.JOINT3D_STEP)),
        "bf16_zoo3d_register": chip_smoke.add_counts(
            (n, chip_smoke.JOINT3D_REGISTER)),
        "bf16_zoo3d_train": chip_smoke.add_counts(
            (n * bf16_steps, chip_smoke.JOINT3D_STEP))}
    assert out["zoo3d_train"][chip_smoke.DSRC3D] == n * steps
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    per_run = {x["run"]: x for x in got if "run" in x}
    assert set(per_run) == set(RUNS)
    for name, r in per_run.items():
        assert r["float32"]["ms_per_step_b1"] > 0
        assert 0.5 < r["float32"]["pos_flow_max_vox"] < 1.0
        assert 0.0 < r["bfloat16"]["pos_flow_max_vox"] < 0.1
        narrow = r["narrow_card_vs_cpu"]
        if name == "netF_global_pool":
            assert narrow == {"held_by": "netR_vxm_dual"}
            continue
        assert narrow["register_max_abs"]["pos_flow"] == 0.0
        assert set(narrow["grads"]) >= {"netG", "netR"}
        assert r["narrow_card_vs_cpu_bf16"]["metrics_rel"]["total"] == 0.0
    assert per_run["netD_pixel"]["float32"]["nets"]["netD"]["type"] == (
        "PixelDiscriminator")
    assert "netD" in per_run["netD_pixel"]["narrow_card_vs_cpu"]["grads"]
    # a run's own narrow cube
    assert [per_run[k]["narrow_card_vs_cpu"]["crop"] for k in (
        "netR_vxm_dual", "netD_pixel")] == [32, SMALL3D["crop_size"]]
    unet = per_run["netG_unet_128"]["float32"]
    assert unet["nets"]["netG"]["type"] == "UnetGenerator"
    # tap 3 is 1^3: its MLP gets a zero gradient and stays
    assert unet["unmoved_zero_gradient"] == [
        f"netF.mlp_3.{k}" for k in ("0.weight", "0.bias", "2.weight",
                                    "2.bias")]
    assert set(got[-1]["runs"]) == set(RUNS)
