"""The port's command line end to end on the CPU (dfmir_tpu_torch.train,
.test, .evaluate through ``main(argv)``), on scripts/make_soak_data.py
pairs at 64^2 (crop 64, ngf 8, resnet_4blocks, 64 patches, --gpu_ids -1):
train 2 epochs, resume with --continue_train, test and evaluate.  The
output trees carry the JAX command line's file names (with .pth for
.msgpack); label values survive the label warp.  On one JAX-written
checkpoint, the port's evaluate matches ``python scripts/evaluate.py
--gpu_ids -1`` (continuous metrics within 1e-4 relative; Dice and HD95
equal, or within 1e-3); ``metrics/`` equals the JAX package's exactly.
With every kernel swapped for its counted plain version, train.main and
test.main launch what chip_smoke.py derives from the code and holds the
card to."""

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
from dfmir_tpu.metrics import image as jax_image
from dfmir_tpu.metrics import segmentation as jax_seg
from dfmir_tpu.nets import resnet_generator_specs
from dfmir_tpu_torch import evaluate, metrics
from dfmir_tpu_torch import test as test_cli
from dfmir_tpu_torch import train
from dfmir_tpu_torch.engine.config import RegistrationConfig
from dfmir_tpu_torch.engine.registration import RegistrationModel
from dfmir_tpu_torch.utils.png import read_png

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--crop_size", "64", "--ngf", "8", "--netG", "resnet_4blocks",
         "--num_patches", "64", "--gpu_ids", "-1"]
FLOW_GAIN = 1e5     # flow head N(0, 1e-5) -> N(0, 1): the warps deform
VISUALS = ("real_A", "fake_B", "real_B", "dvf", "registered", "regA",
           "idt_B")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this file's small steps: the suite runs
    several files at once, and a pool the size of the machine in each
    of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = main(argv)
    return result, out.getvalue()


def write_jax_checkpoint(ck):
    """A checkpoint that the JAX package writes at scripts/evaluate.py's
    config (its RegistrationConfig at crop 64, 64 patches): random weights
    drawn by the port, carried over by the JAX package's own converter
    (cheaper than its init at ngf 64), the flow head scaled so that the
    field deforms."""
    cfg = RegistrationConfig(crop_size=64, num_patches=64)
    model = RegistrationModel(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        model.netR.flow.weight.mul_(FLOW_GAIN)
    params = {"G": jax_convert.convert_netG(
                  model.netG.state_dict(), resnet_generator_specs(
                      ngf=cfg.ngf, n_blocks=cfg.n_blocks)),
              "R": jax_convert.convert_netR(model.netR.state_dict(),
                                            cfg.vxm_enc, cfg.vxm_dec)}
    jax_ckpt.save_networks(str(ck / "jx"), "latest", params)


def eval_argv(data, ck):
    return ["--dataroot", str(data), "--name", "jx", "--checkpoints_dir",
            str(ck), "--crop_size", "64", "--num_patches", "64",
            "--gpu_ids", "-1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """make_soak_data.py pairs and a JAX-written checkpoint; then
    scripts/evaluate.py on it, started in a subprocess that runs beside
    the tests (its JAX compiles go to the suite's persistent cache); then
    train 2 epochs (8 steps at B=1)."""
    tmp = tmp_path_factory.mktemp("cli")
    data = tmp / "data"
    subprocess.run([sys.executable, str(ROOT / "scripts/make_soak_data.py"),
                    "--out", str(data), "--size", "64", "--n_train", "4",
                    "--n_test", "2"], check=True, capture_output=True,
                   timeout=120)
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
    common = ["--dataroot", str(data), "--name", "cli", "--checkpoints_dir",
              str(tmp / "ck"), *SMALL]
    try:
        trained, log = quiet(train.main, common + [
            "--n_epochs", "1", "--n_epochs_decay", "1", "--save_epoch_freq",
            "1", "--print_freq", "1", "--display_freq", "4", "--jac_freq",
            "2"])
        yield dict(tmp=tmp, data=data, common=common, ck=tmp / "ck" / "cli",
                   trained=trained, log=log, ck_jax=ck_jax,
                   jax_eval=jax_eval)
    finally:
        if jax_eval.poll() is None:
            jax_eval.kill()
        jax_eval.communicate(timeout=60)


def history(ck):
    return [json.loads(line) for line in
            (ck / "loss_history.jsonl").read_text().splitlines()]


def test_train_writes_the_jax_layout(run):
    ck = run["ck"]
    nets = {f"{e}_net_{n}.pth" for e in ("1", "2", "latest")
            for n in "GFR"}
    optim = {f"{e}_optim.pth" for e in ("1", "2", "latest")}
    logs = {"loss_log.txt", "loss_history.jsonl", "train_opt.txt", "web"}
    assert {p.name for p in ck.iterdir()} == nets | optim | logs
    images = {f"epoch{e:03d}_{v}.png" for e in (1, 2) for v in VISUALS}
    assert {p.name for p in (ck / "web" / "images").iterdir()} == images
    assert (ck / "web" / "index.html").is_file()
    recs = history(ck)
    assert len(recs) == 8
    for rec in recs:
        assert all(math.isfinite(v) for v in rec["losses"].values())
    assert {"G", "NCE", "NCE_Y", "R", "smooth", "local"} <= set(
        recs[0]["losses"])
    assert "fold" in recs[1]["losses"] and "fold" not in recs[0]["losses"]
    log = (ck / "loss_log.txt").read_text()
    assert log.count("(epoch: 1,") == 4 and log.count("(epoch: 2,") == 4
    assert run["trained"]["model"].step == 8
    assert len(run["trained"]["step_s"]) == 8


def test_resume_continues(run):
    resumed, _ = quiet(train.main, run["common"] + [
        "--continue_train", "--epoch_count", "3", "--n_epochs", "1",
        "--n_epochs_decay", "2", "--save_epoch_freq", "1",
        "--print_freq", "2"])
    assert resumed["model"].step == 8 + 4
    assert (run["ck"] / "3_net_G.pth").is_file()
    recs = [r for r in history(run["ck"]) if r["epoch"] == 3]
    assert len(recs) == 2
    assert all(math.isfinite(v) for r in recs for v in r["losses"].values())


def test_test_cli_writes_outputs(run):
    data = run["data"]
    out, _ = quiet(test_cli.main, run["common"] + [
        "--results_dir", str(run["tmp"] / "results"), "--num_test", "2"])
    assert out["n_pairs"] == 2
    names = ["pair_000.png", "pair_001.png"]
    for sub in ("deform_label", "deform_trainA", "jac_vis"):
        assert sorted(p.name for p in (data / sub).glob("*.png")) == names
    for name in names:
        warped = read_png(data / "deform_label" / name)
        orig = read_png(data / "trainA_label" / name)
        assert set(np.unique(warped)) <= set(np.unique(orig))
        assert read_png(data / "jac_vis" / name).shape == (64, 64, 3)
    stats = [json.loads(line) for line in
             (data / "jac_vis" / "stats.jsonl").read_text().splitlines()]
    assert [s["name"] for s in stats] == names
    web = run["tmp"] / "results" / "cli" / "test_latest"
    assert (web / "index.html").is_file()
    assert {p.name for p in (web / "images").iterdir()} == {
        f"pair_00{i}_{v}.png" for i in (0, 1)
        for v in ("real_A", "real_B", "fake_B", "registered")}


def test_launches_match_the_derived_counts(run, counted_kernels, tmp_path):
    common = ["--dataroot", str(run["data"]), "--name", "counted",
              "--checkpoints_dir", str(tmp_path / "ck"), *SMALL]
    quiet(train.main, common + [
        "--n_epochs", "1", "--n_epochs_decay", "0", "--max_dataset_size",
        "3", "--print_freq", "1", "--display_freq", "2", "--jac_freq", "3",
        "--save_epoch_freq", "1"])
    assert counted_kernels == chip_smoke.cli_train_launches(3, 1, 2, 1, 3)
    assert counted_kernels[chip_smoke.VF] == 3 + 1 + 1
    chip_smoke.warp_cuda.reset_launches()
    quiet(test_cli.main, common + ["--results_dir", str(tmp_path / "res"),
                                   "--num_test", "2"])
    assert counted_kernels == chip_smoke.add_counts(
        (2, chip_smoke.TEST_PAIR_LAUNCHES))


def test_evaluate_matches_jax_script(run, tmp_path):
    _, err = run["jax_eval"].communicate(timeout=900)
    assert run["jax_eval"].returncode == 0, err[-4000:]
    ref = json.loads((run["tmp"] / "jax_eval.json").read_text())
    argv = eval_argv(run["data"], run["ck_jax"])
    mine, _ = quiet(evaluate.main, argv + ["--out", str(tmp_path / "m.json")])
    assert json.loads((tmp_path / "m.json").read_text())["summary"] == \
        mine["summary"]
    assert mine["summary"].keys() == ref["summary"].keys()
    assert mine["summary"]["n_pairs"] == 2
    assert ref["summary"]["mean_dice_after"] != \
        ref["summary"]["mean_dice_before"]             # the field deforms
    worst = {}
    for rec, rrec in zip(mine["records"], ref["records"]):
        assert rec.keys() == rrec.keys() and rec["name"] == rrec["name"]
        for k, r in rrec.items():
            if k == "name":
                continue
            err = abs(rec[k] - r)
            if k.startswith(("dice", "hd95")):
                worst[k] = max(worst.get(k, 0.0), err)
                assert err <= 1e-3, (k, rec[k], r)
            else:
                assert err <= 1e-4 * max(abs(r), 1e-6), (k, rec[k], r)
    assert all(e == 0.0 for e in worst.values()), worst


def test_evaluate_scores_a_trained_run(run):
    """Train scripts/evaluate.py's model (the default netG at crop 64) for
    two steps on the soak pairs, then score it: every key of the JAX
    script's summary, finite."""
    ck = str(run["tmp"] / "ck_full")
    quiet(train.main, [
        "--dataroot", str(run["data"]), "--name", "full", "--checkpoints_dir",
        ck, "--crop_size", "64", "--load_size", "64", "--num_patches", "64",
        "--gpu_ids", "-1", "--max_dataset_size", "2", "--n_epochs", "1",
        "--n_epochs_decay", "0", "--save_epoch_freq", "1"])
    summary = quiet(evaluate.main, [
        "--dataroot", str(run["data"]), "--name", "full", "--checkpoints_dir",
        ck, "--crop_size", "64", "--num_patches", "64", "--gpu_ids", "-1"
    ])[0]["summary"]
    assert set(summary) == {
        "mean_dice_after", "mean_dice_before", "mean_folding_fraction",
        "mean_hd95_after", "mean_hd95_before", "mean_jac_det_min",
        "mean_ncc_global", "mean_ncc_windowed", "mean_psnr", "n_pairs"}
    assert summary["n_pairs"] == 2
    assert all(math.isfinite(v) for v in summary.values())
    with pytest.raises(FileNotFoundError, match="net R"):
        evaluate.main(["--dataroot", "x", "--name", "y", "--ndims", "3",
                       "--checkpoints_dir", str(run["tmp"] / "none"),
                       "--gpu_ids", "-1"])          # the volume path's own


@pytest.mark.parametrize("shape", [(64, 64), (12, 14, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, shape) * 60
    b = np.where(rng.random(shape) < 0.8, a, rng.integers(0, 4, shape) * 60)
    assert metrics.label_dice(a, b) == jax_seg.label_dice(a, b)
    assert metrics.label_dice(a, b, labels=[60, 240]) == \
        jax_seg.label_dice(a, b, labels=[60, 240])
    for lab in (0, 60, 180, 999):
        for pct in (None, 95):
            assert metrics.hausdorff_distance(a == lab, b == lab, pct) == \
                jax_seg.hausdorff_distance(a == lab, b == lab, pct)
        assert metrics.dice_score(a == lab, b == lab) == \
            jax_seg.dice_score(a == lab, b == lab)
    x, y = rng.standard_normal(shape), rng.standard_normal(shape)
    assert metrics.ncc_metric(x, y) == jax_image.ncc_metric(x, y)
    assert metrics.psnr(x, y) == jax_image.psnr(x, y)
    assert metrics.psnr(x, x) == jax_image.psnr(x, x) == float("inf")
