"""chip_smoke.py's phase spatial3d rehearsed on the CPU: VxmEngine at 32^3
(a narrow netR) split along D over 2 and 4 ``gloo`` CPU ranks (1 x 2, 2 x
2, and 1 x 4 with netR's fourth level gathered) against one process,
with the slab kernels and the one-process runs on counted plain versions
(the spawned ranks run the plain path itself, counting nothing):
every check of the phase runs, and it returns the launches it holds the
card to."""

import json

import pytest

import chip_smoke
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_vecint_chain import _counted
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from dfmir_tpu_torch.ops import warp_cuda
from dfmir_tpu_torch.ops.warp import warp, warp_bwd_plain
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

SIZE = 32
NARROW = dict(vol_size=SIZE, enc=(8, 16, 16, 16),
              dec=(16, 16, 16, 16, 16, 8, 8))


@pytest.fixture
def small_spatial(cpu_card, monkeypatch):  # noqa: F811 (the fixture above)
    L = cpu_card
    monkeypatch.setattr(warp_cuda, "warp3d_cuda", _counted(
        L, warp_cuda.FWD3D,
        lambda s, f, z0=0: warp(s, f, impl="torch", z0=z0)))
    monkeypatch.setattr(warp_cuda, "warp3d_bwd_dflow_cuda", _counted(
        L, warp_cuda.DFLOW3D, lambda s, f, g, z0=0: warp_bwd_plain(
            s, f, g, need_dsrc=False, z0=z0)[1]))
    monkeypatch.setattr(chip_smoke, "DP_DEVICES", ["cpu", "cpu"])
    monkeypatch.setattr(chip_smoke, "SPATIAL3D_CFG", NARROW)
    monkeypatch.setattr(chip_smoke, "SPATIAL_REG_REPS", 1)
    monkeypatch.setattr(chip_smoke, "SLAB_SHAPE", (1, 1, SIZE, SIZE, SIZE))
    monkeypatch.setattr(chip_smoke, "SLAB_Z0", (0, SIZE // 2))
    checked = []

    def check_launches(what, got, want):
        checked.append(what)
        # a spawned CPU rank counts no plain kernel
        if "one process" in what or got != chip_smoke.ZERO:
            if got != want:
                raise AssertionError(f"{what}: {got} != {want}")
    monkeypatch.setattr(chip_smoke, "check_launches", check_launches)
    return checked


def test_spatial3d_phase(small_spatial, capsys):
    out, slab_rows = chip_smoke.phase_spatial3d(0, "cpu")
    # the ranks count nothing on the CPU: the totals are zero there, and
    # each one-process run's launches were held to a step's and a call's
    assert out == {"spatial3d_register": chip_smoke.ZERO,
                   "spatial3d_train": chip_smoke.ZERO}
    # the slab kernels' rows, for the kernels line
    assert len(slab_rows) == 4
    assert any("one process" in w for w in small_spatial)
    assert sum("rank" in w for w in small_spatial) >= 10 * 3
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    slabs = [x["slab_kernel"] for x in got if "slab_kernel" in x]
    assert len(slabs) == 4
    assert all(r["vs_whole_max_abs"] == 0.0 for r in slabs)
    meshes = {x["mesh"]: x for x in got if "mesh" in x}
    assert set(meshes) == {"1x2", "2x2", "1x4"}
    for name, m in meshes.items():
        assert m["ranks"] == m["n_data"] * m["n_spatial"]
        assert len(m["ms_per_step_by_rank"]) == m["ranks"]
        assert max(m["register_max_abs_vs_one_process"].values()) <= 1e-5
        assert m["flow_max_vox"] > 1.0
        for sent in m["bytes_sent_per_step_by_rank"]:
            assert sent["halo"] > 0 and sent["gather"] > 0
    assert meshes["1x4"]["netR_gathered_from_level"] == 4
    assert meshes["1x2"]["netR_gathered_from_level"] is None
    last = got[-1]
    assert last["launches_per_rank_step"] == chip_smoke.STEP3D
    assert set(last["meshes"]) == {"1x2", "2x2", "1x4"}
