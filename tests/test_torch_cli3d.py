"""The port's 3-D command line end to end on the CPU (--model vxm
--dataset_mode volume through dfmir_tpu_torch.train.main and
evaluate.main --ndims 3, --gpu_ids -1) on scripts/make_soak_data.py
--ndims 3 volumes (written by chip_smoke.py's numpy copy of its writer,
which test_torch_volume.py holds bit-equal to the script) at 24^3 with
the JAX 3-D suite's small netR (enc (8,16), dec (16,16,8)): train 2
epochs and resume; the output tree carries the JAX command line's file
names (.pth for .msgpack).  On one JAX-written checkpoint (the flow head
scaled so that the field deforms), the port's evaluate --ndims 3 matches
``python scripts/evaluate.py --ndims 3 --gpu_ids -1``: Dice and HD95
exactly, every other key within 1e-4 relative.  With every kernel swapped
for its counted plain version, train.main and evaluate.main launch what
chip_smoke.py derives from the code, and chip_smoke.py's phase cli3d runs
through (its reload, resume, card-vs-CPU and evaluate checks) with the
CPU standing in for the card.  ``test.py --model vxm`` is refused, as the
JAX package's test.py cannot serve it."""

import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_vecint_chain import counted_kernels  # noqa: F401 (fixture)

import chip_smoke

from dfmir_tpu.compat import convert as jax_convert
from dfmir_tpu.engine import checkpoints as jax_ckpt
from dfmir_tpu_torch import evaluate
from dfmir_tpu_torch import test as test_cli
from dfmir_tpu_torch import train
from dfmir_tpu_torch.engine.vxm_engine import VxmConfig, VxmEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
S = 24
NET = ["--enc", "8,16", "--dec", "16,16,8"]
SMALL = ["--model", "vxm", "--dataset_mode", "volume", "--vol_size", str(S),
         *NET, "--gpu_ids", "-1"]
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform
N_TRAIN, N_TEST = 4, 2
VISUALS = ("source", "target", "registered")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's small steps (several test
    files run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = main(argv)
    return result, out.getvalue()


def write_jax_checkpoint(ck):
    """A vxm checkpoint that the JAX package writes (what its VxmTask's
    save_networks writes for netR): random weights drawn by the port, the
    flow head scaled, carried over by the JAX package's own converter."""
    eng = VxmEngine(VxmConfig(vol_size=S, enc=(8, 16), dec=(16, 16, 8)),
                    device="cpu", seed=3)
    with torch.no_grad():
        eng.netR.flow.weight.mul_(FLOW_GAIN)
    params = {"R": jax_convert.convert_netR(eng.netR.state_dict(), (8, 16),
                                            (16, 16, 8))}
    jax_ckpt.save_networks(str(ck / "jx"), "latest", params)


def eval_argv(data, ck):
    """Two integration steps: the JAX script's eager init and its jit of
    register grow with the unrolled chain (on one CPU, 86 s at 7 steps
    and 37 s at 2)."""
    return ["--ndims", "3", "--dataroot", str(data), "--name", "jx",
            "--checkpoints_dir", str(ck), "--vol_size", str(S), *NET,
            "--int_steps", "2", "--gpu_ids", "-1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Volumes with labels and a JAX-written checkpoint; then
    scripts/evaluate.py --ndims 3 on it, started in a subprocess that runs
    beside the tests (its JAX compiles go to the suite's persistent
    cache); then train 2 epochs (8 steps at B=1)."""
    tmp = tmp_path_factory.mktemp("cli3d")
    data = tmp / "data"
    chip_smoke.write_volumes(str(data), N_TRAIN, N_TEST, S, seed=0)
    ck_jax = tmp / "ck_jax"
    write_jax_checkpoint(ck_jax)
    env = dict(os.environ,
               JAX_COMPILATION_CACHE_DIR=str(ROOT / ".jax_cache_cpu"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    jax_eval = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts/evaluate.py"),
         *eval_argv(data, ck_jax), "--out", str(tmp / "jax_eval.json")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    common = ["--dataroot", str(data), "--name", "cli3d", "--checkpoints_dir",
              str(tmp / "ck"), *SMALL]
    try:
        trained, log = quiet(train.main, common + [
            "--n_epochs", "1", "--n_epochs_decay", "1", "--save_epoch_freq",
            "1", "--print_freq", "1", "--display_freq", "2", "--jac_freq",
            "2"])
        yield dict(tmp=tmp, data=data, common=common,
                   ck=tmp / "ck" / "cli3d", trained=trained, log=log,
                   ck_jax=ck_jax, jax_eval=jax_eval)
    finally:
        if jax_eval.poll() is None:
            jax_eval.kill()
        jax_eval.communicate(timeout=60)


def history(ck):
    return [json.loads(line) for line in
            (ck / "loss_history.jsonl").read_text().splitlines()]


def test_train_writes_the_jax_layout(run):
    ck = run["ck"]
    ckpts = {f"{e}_{s}.pth" for e in ("1", "2", "latest")
             for s in ("net_R", "optim")}
    logs = {"loss_log.txt", "loss_history.jsonl", "train_opt.txt", "web"}
    assert {p.name for p in ck.iterdir()} == ckpts | logs
    images = {f"epoch{e:03d}_{v}.png" for e in (1, 2) for v in VISUALS}
    assert {p.name for p in (ck / "web" / "images").iterdir()} == images
    assert (ck / "web" / "index.html").is_file()
    recs = history(ck)
    assert len(recs) == 2 * N_TRAIN
    for rec in recs:
        assert all(math.isfinite(v) for v in rec["losses"].values())
    assert list(recs[0]["losses"]) == ["sim", "smooth", "total"]
    assert [("fold" in r["losses"]) for r in recs] == [False, True] * N_TRAIN
    log = (ck / "loss_log.txt").read_text()
    assert log.count("(epoch: 1,") == N_TRAIN
    assert log.count("(epoch: 2,") == N_TRAIN
    model = run["trained"]["model"]
    assert type(model).__name__ == "VxmTask" and model.step == 2 * N_TRAIN
    assert len(run["trained"]["step_s"]) == 2 * N_TRAIN
    assert model.cfg.vol_size == S and model.cfg.enc == (8, 16)
    sd = torch.load(ck / "latest_net_R.pth", weights_only=True)
    assert set(sd) == set(model.engine.netR.state_dict())
    optim = torch.load(ck / "latest_optim.pth", weights_only=True)
    assert optim["step"] == 2 * N_TRAIN and len(
        optim["optimizer"]["state"]) == len(sd)


def test_resume_continues(run):
    resumed, _ = quiet(train.main, run["common"] + [
        "--continue_train", "--epoch_count", "3", "--n_epochs", "1",
        "--n_epochs_decay", "2", "--save_epoch_freq", "1",
        "--print_freq", "2"])
    assert resumed["model"].step == 2 * N_TRAIN + N_TRAIN
    assert (run["ck"] / "3_net_R.pth").is_file()
    recs = [r for r in history(run["ck"]) if r["epoch"] == 3]
    assert len(recs) == N_TRAIN // 2
    assert all(math.isfinite(v) for r in recs for v in r["losses"].values())


def test_launches_match_the_derived_counts(run, counted_kernels, tmp_path):
    common = ["--dataroot", str(run["data"]), "--name", "counted",
              "--checkpoints_dir", str(tmp_path / "ck"), *SMALL]
    quiet(train.main, common + [
        "--n_epochs", "1", "--n_epochs_decay", "0", "--max_dataset_size",
        "3", "--print_freq", "1", "--display_freq", "2", "--jac_freq", "3",
        "--save_epoch_freq", "1"])
    assert counted_kernels == chip_smoke.cli3d_train_launches(3, 2, 1, 3)
    assert counted_kernels[chip_smoke.VF3] == 3 + 1 + 1
    assert counted_kernels[chip_smoke.DSRC3D] == 0
    chip_smoke.warp_cuda.reset_launches()
    out, _ = quiet(evaluate.main, [
        "--ndims", "3", "--dataroot", str(run["data"]), "--name", "counted",
        "--checkpoints_dir", str(tmp_path / "ck"), "--vol_size", str(S),
        *NET, "--gpu_ids", "-1"])
    assert out["summary"]["n_pairs"] == N_TEST
    assert counted_kernels == chip_smoke.add_counts(
        (N_TEST, chip_smoke.EVAL3D_PAIR_LAUNCHES))


def test_cli3d_phase_on_the_cpu(counted_kernels, monkeypatch, capsys):
    """chip_smoke.py's phase cli3d at 24^3, the CPU standing in for the
    card: every check of the phase runs, and it returns the counts it
    holds the card to."""
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "CLI_GPU", "-1")
    monkeypatch.setattr(chip_smoke, "CLI3D_SIZE", S)
    monkeypatch.setattr(chip_smoke, "CLI3D_FLAGS", NET)
    launches = chip_smoke.phase_cli3d(0, "cpu", None)
    steps = 2 * chip_smoke.CLI3D_TRAIN
    assert launches["cli3d_train"] == chip_smoke.cli3d_train_launches(
        steps, chip_smoke.CLI3D_DISPLAY, chip_smoke.CLI3D_PRINT,
        chip_smoke.CLI3D_JAC)
    assert launches["cli3d_eval"] == chip_smoke.add_counts(
        (chip_smoke.CLI3D_TEST, chip_smoke.EVAL3D_PAIR_LAUNCHES))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "cli3d" and line["steps"] == steps
    assert line["stats_calls"] == steps // chip_smoke.CLI3D_JAC
    assert line["ckpt_bytes"] > 0 and line["reload_tensors_equal"] > 20
    assert line["evaluate_summary"]["n_pairs"] == chip_smoke.CLI3D_TEST


def test_evaluate_matches_jax_script(run, tmp_path):
    _, err = run["jax_eval"].communicate(timeout=900)
    assert run["jax_eval"].returncode == 0, err[-4000:]
    ref = json.loads((run["tmp"] / "jax_eval.json").read_text())
    argv = eval_argv(run["data"], run["ck_jax"])
    mine, _ = quiet(evaluate.main, argv + ["--out", str(tmp_path / "m.json")])
    assert json.loads((tmp_path / "m.json").read_text())["summary"] == \
        mine["summary"]
    assert list(mine["summary"]) == list(ref["summary"])
    assert mine["summary"]["n_pairs"] == N_TEST
    assert mine["summary"]["ndims"] == 3
    assert ref["summary"]["mean_dice_after"] != \
        ref["summary"]["mean_dice_before"]             # the field deforms
    for rec, rrec in zip(mine["records"], ref["records"]):
        assert rec.keys() == rrec.keys() and rec["name"] == rrec["name"]
        assert "hd95_after" in rec and "ncc_windowed_after" in rec
        for k, r in rrec.items():
            if k == "name":
                continue
            if k.startswith(("dice", "hd95")):
                assert rec[k] == r, (k, rec[k], r)
            else:
                assert abs(rec[k] - r) <= 1e-4 * max(abs(r), 1e-6), (
                    k, rec[k], r)
    for v in mine["label_values"]:
        assert set(v["warped"]) <= set(v["moving"])


def test_test_refuses_the_vxm_model(run, tmp_path):
    with pytest.raises(ValueError, match="evaluate --ndims 3"):
        quiet(test_cli.main, run["common"] + [
            "--results_dir", str(tmp_path / "results")])
    assert not (tmp_path / "results").exists()
    assert not (run["data"] / "deform_trainA").exists()


def test_evaluate_volume_labels_are_nearest(run):
    """Label volumes pass through the warp's nearest mode: every warped
    value is one of the input's (a deforming field, JAX-written)."""
    out, _ = quiet(evaluate.main, eval_argv(run["data"], run["ck_jax"]))
    assert len(out["label_values"]) == N_TEST
    for v in out["label_values"]:
        assert set(v["moving"]) == {0, 60, 120, 180}
        assert set(v["warped"]) <= set(v["moving"])
    assert len(out["label_s"]) == len(out["pair_s"]) == N_TEST
    assert np.all(np.asarray(out["label_s"]) < np.asarray(out["pair_s"]))
