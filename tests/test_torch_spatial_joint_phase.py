"""chip_smoke.py's phase spatial_joint rehearsed on the CPU: the joint
model at a narrow width (2-D at 32^2 over 2 and 4 ``gloo`` CPU ranks, the
graft's crop 64 with netR six levels deep over 2, 3-D at 16^3 over 2),
register and steps against one process, with the slab kernels (B1, B2 at
C 1 and 2, B5) and the one-process references (run here, in this
process, where the card runs them in a launch of their own) on counted
plain versions (B2's source gradient its fixed-point model, what the
kernel equals bit for bit; the spawned ranks run the plain path itself,
counting nothing): every check of the phase runs, and it returns the
launches it holds the card to and its slab kernels' rows."""

import json
import types

import pytest
import torch

import chip_smoke
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import _counted
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from dfmir_tpu_torch.ops import warp as warp_mod
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import (warp, warp2d_dsrc_fixed_plain,
                                      warp3d_dsrc_binned_plain,
                                      warp_bwd_plain)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

NARROW2D = dict(crop_size=32, ngf=8, netG="resnet_2blocks", vxm_enc=(8, 16),
                vxm_dec=(16, 16, 8), netF_nc=16, num_patches=16)
GRAFT = dict(NARROW2D, crop_size=64, vxm_enc=(8,) * 6, vxm_dec=(8,) * 7,
             num_patches=64)
NARROW3D = dict(ndims=3, crop_size=16, ngf=8, netG="resnet_2blocks",
                vxm_enc=(4, 4, 4), vxm_dec=(4, 4, 4, 4, 4), netF_nc=16,
                num_patches=16, int_steps=2)


@pytest.fixture
def small_joint(cpu_card, monkeypatch):  # noqa: F811 (the fixture above)
    L = cpu_card
    monkeypatch.setattr(warp_cuda, "warp2d_slab_cuda", _counted(
        L, warp_cuda.FWD, lambda s, f, y0: warp(s, f, impl="torch", z0=y0)))
    monkeypatch.setattr(warp_cuda, "warp2d_bwd_cuda", _counted(
        L, warp_cuda.BWD, lambda s, f, g, need_dsrc=True: (
            warp2d_dsrc_fixed_plain(f, g) if need_dsrc else None,
            warp_bwd_plain(s, f, g, need_dsrc=False)[1])))
    monkeypatch.setattr(warp_cuda, "warp2d_bwd_slab_cuda", _counted(
        L, warp_cuda.BWD, lambda s, f, g, y0, m=None: (
            None if m is None else warp2d_dsrc_fixed_plain(
                f, g, y0, s.shape[2], m, sums=True),
            warp_bwd_plain(s, f, g, need_dsrc=False, z0=y0)[1])))
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dsrc_slab_cuda", _counted(
        L, warp_cuda.DSRC3D, lambda f, g, z0, D, m: warp3d_dsrc_binned_plain(
            f, g, z0, D, m, sums=True)))
    # B5's binned model: what the kernel equals bit for bit
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dsrc_cuda", _counted(
        L, warp_cuda.DSRC3D, warp3d_dsrc_binned_plain))
    monkeypatch.setattr(chip_smoke, "device_us", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "DP_DEVICES", ["cpu", "cpu"])
    monkeypatch.setattr(chip_smoke, "SJ_2D_CFG", NARROW2D)
    monkeypatch.setattr(chip_smoke, "SJ_GRAFT_CFG", GRAFT)
    monkeypatch.setattr(chip_smoke, "JOINT3D", NARROW3D)
    monkeypatch.setattr(chip_smoke, "SJ_REG_REPS", 1)
    monkeypatch.setattr(chip_smoke, "SJ_B1_SHAPE", (1, 1, 32, 24))
    monkeypatch.setattr(chip_smoke, "SJ_B1_Y0", (0, 16))
    monkeypatch.setattr(chip_smoke, "SJ_B5_SHAPE", (1, 1, 16, 12, 10))
    monkeypatch.setattr(chip_smoke, "SJ_B5_Z0", (0, 8))
    # the card's dispatch: float32 on the kernels (the float64 references
    # on the plain path)
    monkeypatch.setattr(warp_mod, "_kernel_takes", lambda src, flow, mode: (
        mode != "nearest" and src.dtype == flow.dtype == torch.float32))
    launch = chip_smoke.dp_launch

    def dp_launch(fn, devices, *args):
        # the one-process references' launch of one rank: here, on the
        # counted plain kernels
        if len(devices) == 1:
            return [fn(types.SimpleNamespace(device=torch.device(
                devices[0])), *args)]
        return launch(fn, devices, *args)
    monkeypatch.setattr(chip_smoke, "dp_launch", dp_launch)
    checked = []

    def check_launches(what, got, want):
        checked.append(what)
        # a spawned CPU rank counts no plain kernel
        if "one process" in what or got != chip_smoke.ZERO:
            if got != want:
                raise AssertionError(f"{what}: {got} != {want}")
    monkeypatch.setattr(chip_smoke, "check_launches", check_launches)
    return checked


def test_spatial_joint_phase(small_joint, capsys):
    launches, slab_rows = chip_smoke.phase_spatial_joint(0, "cpu")
    # the ranks count nothing on the CPU; the one-process runs were held
    # to a register call's and a step's launches
    assert launches == {"spatial_joint_register2d": chip_smoke.ZERO,
                        "spatial_joint_register3d": chip_smoke.ZERO,
                        "spatial_joint_train2d": chip_smoke.ZERO,
                        "spatial_joint_train": chip_smoke.ZERO}
    # register and each step of the 2-D, graft and 3-D references
    assert sum("one process" in w for w in small_joint) >= 3 + 2 + 1 + 2
    assert sum("rank" in w for w in small_joint) >= 2 + 4 + 2 + 2
    assert len(slab_rows[warp_cuda.FWD]) == len(slab_rows[warp_cuda.DSRC3D])
    assert len(slab_rows[warp_cuda.BWD]) == 2 * len(chip_smoke.SJ_B1_Y0)
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    slabs = [x["slab_kernel"] for x in got if "slab_kernel" in x]
    assert len(slabs) == 8
    for r in slabs:
        assert r.get("vs_whole_max_abs", 0.0) == 0.0
        assert r.get("dflow_vs_whole_max_abs", 0.0) == 0.0
        assert r.get("slabs_vs_whole_max_abs", 0.0) == 0.0
        assert r["max_abs_err"] <= chip_smoke.KERNEL_TOL
    meshes = {x["mesh"]: x for x in got if "mesh" in x}
    assert set(meshes) == {"2d_1x2", "2d_1x4", "graft_1x2", "3d_1x2"}
    for name, m in meshes.items():
        assert m["ranks"] == m["n_data"] * m["n_spatial"]
        assert len(m["register_ms_by_rank"]) == m["ranks"]
        assert max(m["register_max_abs_vs_one_process"].values()) <= 1e-4
        assert set(m["grad_vs_one_process"]) == {"G", "F", "R"}
        for sent in m["bytes_sent_per_step_by_rank"]:
            assert sent["halo"] > 0 and sent["gather"] > 0
            assert sent["reduce"] > 0
    assert meshes["graft_1x2"]["netR_gathered_from_level"] == 6
    for name in ("2d_1x2", "2d_1x4", "graft_1x2"):
        exact = meshes[name]["grad_float64_vs_one_process_float64"]
        assert set(exact) == {"G", "F", "R"}
        assert max(e["each_tensor"] for e in exact.values()) <= 1e-2
        f32 = meshes[name]["grad_vs_one_process_each_tensor"]
        assert set(f32) == {"G", "F", "R"}
        assert (max(e["each_tensor"] for e in f32.values())
                <= chip_smoke.SJ_GRAD_F32_TENSOR)
        assert set(meshes[name]["one_process_float32_vs_float64"]) == {
            "G", "F", "R"}
    assert "grad_float64_vs_one_process_float64" not in meshes["3d_1x2"]
    assert meshes["2d_1x4"]["netR_gathered_from_level"] is None
    for name in ("2d_1x2", "2d_1x4", "3d_1x2"):
        assert (len(meshes[name]["steps_rel_vs_one_process"])
                == chip_smoke.SJ_STEPS)
    last = got[-1]
    assert last["launches_per_rank_step"] == {
        "2d": chip_smoke.STEP_LAUNCHES, "3d": chip_smoke.JOINT3D_STEP}
