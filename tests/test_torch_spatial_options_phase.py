"""chip_smoke.py's phase spatial_options rehearsed on the CPU: the paper
model's training options on slabs at a narrow width (2-D at 32^2 over 2
``gloo`` CPU ranks each alone, over 2 x 2 with all negatives and over 1 x
4 with bfloat16 + FastCUT + dropout + the GAN phase; the 3-D model in
bfloat16 at 16^3 over 2), register and steps against one process, the
one-process references (run here, in this process, where the card runs
them in a launch of their own) on counted plain versions (the spawned
ranks run the plain path itself, counting nothing): every check of the
phase runs, and it returns the launches it holds the card to."""

import json

import chip_smoke
from test_torch_option_phases import cpu_card  # noqa: F401 (fixture)
from test_torch_spatial_joint_phase import small_joint  # noqa: F401
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)
from torch_threads import few_threads  # noqa: F401 (autouse fixture)


def test_spatial_options_phase(small_joint, capsys):  # noqa: F811
    launches = chip_smoke.phase_spatial_options(0, "cpu")
    # the ranks count nothing on the CPU; the one-process runs were held
    # to a register call's and a step's launches
    assert launches == {"spatial_options_register2d": chip_smoke.ZERO,
                        "spatial_options_register3d": chip_smoke.ZERO,
                        "spatial_options_train2d": chip_smoke.ZERO,
                        "spatial_options_train3d": chip_smoke.ZERO}
    runs = chip_smoke.SO_RUNS
    # each run's one process: its steps; the bfloat16 ones its register
    assert sum("one process" in w for w in small_joint) >= (
        len(runs) + 1) * chip_smoke.SO_STEPS + 3
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows = {x["run"]: x for x in got if "run" in x}
    assert set(rows) == set(runs) | {"bf16_3d_1x2"}
    for name, r in rows.items():
        assert r["ranks"] == r["n_data"] * r["n_spatial"]
        assert len(r["steps_rel_vs_one_process"]) == chip_smoke.SO_STEPS
        assert len(r["ms_per_step_by_rank"]) == r["ranks"]
        gan = r["options"].get("lambda_GAN", 0) > 0
        assert set(r["grad_vs_one_process"]) == (
            {"G", "F", "R", "D"} if gan else {"G", "F", "R"})
        for sent in r["bytes_sent_per_step_by_rank"]:
            assert sent["halo"] > 0 and sent["gather"] > 0
            assert sent["reduce"] > 0
        if gan:
            assert {"D", "D_fake", "D_real", "G_GAN"} <= set(
                r["steps_rel_vs_one_process"][0])
            assert len(r["netD_ms_by_rank"]) == r["ranks"]
            # netD on the gathered image: each rank gathers fake_B
            assert all(b["gather"] > 0 for b in r["netD_bytes_by_rank"])
        bf16 = r["options"].get("compute_dtype") == "bfloat16"
        assert ("register_max_abs_vs_one_process" in r) == bf16
        assert ("grad_vs_one_process_each_tensor" in r) == (not bf16)
    for key in ("one_process_grad_run_to_run", "one_process_bf16_vs_float32",
                "grad_vs_one_process_float32"):
        assert set(rows[chip_smoke.SO_AGAIN][key]) == {"G", "F", "R"}
    assert rows["fastcut_tails_1x2"]["flip"] is True
    assert rows["fastcut_heads_1x2"]["flip"] is False
    last = got[-1]
    assert last["runs"][0] == "bf16_3d_1x2"
    assert last["launches_per_rank_step"] == {
        "2d": chip_smoke.STEP_LAUNCHES, "3d": chip_smoke.JOINT3D_STEP}
