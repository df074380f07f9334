"""The port's patient_site and triplet datasets (``data/patient_site.py``,
``data/triplet.py``) against the JAX package's on the same files, seed and
epochs: every item equal (CHW against HWC; C too, paths equal), through
the loader's shuffled batches too.  The files are PNGs written here, L and
RGB (PIL's ``convert("L")`` rounding, reproduced by ``utils/png.py``), some
smaller than the crop (zeros outside, as PIL's crop).  Then the port's
command line trains a step on each mode on the CPU, tests the triplet run
(JAX's ``test.py`` lists ``{dataroot}/testA`` for its output names, which a
patient_site dataroot does not hold), and serves its live dashboard with
``--display_id 1``."""

import argparse
import json
import math
import urllib.request

import numpy as np
import pytest

from dfmir_tpu.data import create_dataset as jax_create_dataset
from dfmir_tpu.data.patient_site import PatientSiteDataset as JaxPatientSite
from dfmir_tpu.data.patient_site import TripletDataset as JaxTriplet
from dfmir_tpu_torch import test as test_cli
from dfmir_tpu_torch import train as train_cli
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.data.patient_site import (PatientSiteDataset,
                                               TripletDataset)
from dfmir_tpu_torch.utils.png import write_png
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

SITES, SLICES = 3, 4


def image(rng, h, w, rgb=False):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(yy / 5.0) * np.cos(xx / 7.0) * 90 + 128
    if rgb:
        img = base[..., None] + rng.integers(-40, 40, (h, w, 3))
    else:
        img = base + rng.integers(0, 30, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(9)
    sites = base / "sites"
    for s in range(SITES):
        for mod in ("t1", "t2"):
            d = sites / f"patient_{s}" / mod
            d.mkdir(parents=True)
            for k in range(SLICES):
                h, w = ((70, 66), (60, 62), (72, 72))[(s + k) % 3]
                write_png(d / f"slice_{k:02d}.png",
                          image(rng, h, w, rgb=(mod == "t2" and k == 1)))
    (sites / "notes").mkdir()          # not a site: no t1/
    trip = base / "triplet"
    for phase, n in (("train", 5), ("test", 2)):
        for side in "AB":
            d = trip / f"{phase}{side}"
            d.mkdir(parents=True)
            for i in range(n + (side == "B")):
                write_png(d / f"im_{i:02d}.png",
                          image(rng, 72, 72, rgb=(i == 2)))
    no_c = base / "triplet_no_c"
    for side in "AB":
        d = no_c / f"test{side}"
        d.mkdir(parents=True)
        for i in range(3):
            write_png(d / f"im_{i:02d}.png", image(rng, 72, 72))
    return {"sites": sites, "triplet": trip, "triplet_no_c": no_c}


def opt_for(root, **kw):
    base = dict(dataroot=str(root), phase="train", isTrain=True,
                dataset_mode="triplet", max_dataset_size=float("inf"),
                seed=5, preprocess="resize_and_crop", load_size=72,
                crop_size=64, no_flip=False, batch_size=2,
                serial_batches=False, num_threads=0)
    base.update(kw)
    return argparse.Namespace(**base)


def assert_items_equal(mine, ref):
    assert set(mine) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert mine[k].dtype == np.float32
            np.testing.assert_array_equal(mine[k], to_nchw(v[None])[0])
        else:
            assert mine[k] == v, k


@pytest.mark.parametrize("crop", [64, 48])
def test_patient_site_items_equal_jax(roots, crop):
    opt = opt_for(roots["sites"], dataset_mode="patient_site",
                  crop_size=crop)
    mine, ref = PatientSiteDataset(opt), JaxPatientSite(opt)
    assert len(mine) == len(ref) == SITES * SLICES
    cross = 0
    for epoch in (1, 2):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            a, b = mine[i], ref[i]
            assert_items_equal(a, b)
            assert a["A"].shape == (1, crop, crop)
            cross += a["A_paths"].split("/")[-3] != a["B_paths"].split(
                "/")[-3]
    assert cross > 0                  # B comes from other sites too


@pytest.mark.parametrize("phase,root", [("train", "triplet"),
                                        ("test", "triplet"),
                                        ("test", "triplet_no_c")])
def test_triplet_items_equal_jax(roots, phase, root):
    opt = opt_for(roots[root], phase=phase, isTrain=phase == "train")
    mine, ref = TripletDataset(opt), JaxTriplet(opt)
    assert len(mine) == len(ref)
    for epoch in (1, 3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            assert_items_equal(mine[i], ref[i])
    if root == "triplet_no_c":
        assert mine.C_paths == mine.A_paths


@pytest.mark.parametrize("mode", ["patient_site", "triplet"])
def test_loader_batches_equal_jax(roots, mode):
    root = roots["sites" if mode == "patient_site" else "triplet"]
    opt = opt_for(root, dataset_mode=mode, num_threads=2)
    mine, ref = create_dataset(opt), jax_create_dataset(opt)
    for epoch in (1, 2):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(zip(mine, ref, strict=True))
        assert batches
        for a, b in batches:
            assert set(a) == set(b)
            for k, v in b.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(a[k], to_nchw(v))
                else:
                    assert a[k] == v


CLI_FLAGS = ["--gpu_ids", "-1", "--crop_size", "64", "--load_size", "72",
             "--ngf", "8", "--netG", "resnet_4blocks", "--num_patches",
             "16", "--batch_size", "1", "--max_dataset_size", "1",
             "--n_epochs", "1", "--n_epochs_decay", "1", "--print_freq",
             "1", "--display_freq", "2", "--save_epoch_freq", "1"]


def fetch(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


@pytest.mark.parametrize("mode", ["patient_site", "triplet"])
def test_cli_trains_each_mode(roots, tmp_path, mode):
    root = roots["sites" if mode == "patient_site" else "triplet"]
    argv = ["--dataroot", str(root), "--name", mode, "--checkpoints_dir",
            str(tmp_path / "ck"), "--dataset_mode", mode, *CLI_FLAGS]
    if mode == "triplet":
        argv += ["--display_id", "1", "--display_port", "0"]
    out = train_cli.main(argv)
    assert len(out["step_s"]) == 2
    losses = out["model"].get_current_losses()
    assert losses and all(math.isfinite(float(v)) for v in losses.values())
    vis = out["visualizer"]
    if mode == "triplet":
        server, _ = vis.plot_server
        host, port = server.server_address[:2]
        assert host == "127.0.0.1"
        base = f"http://127.0.0.1:{port}"
        status, page = fetch(base + "/")
        assert status == 200 and b"triplet" in page
        _, hist = fetch(base + "/history")
        records = json.loads(hist)
        assert len(records) == 2
        last = records[-1]["losses"]
        assert {k: float(v) for k, v in losses.items()}.keys() <= last.keys()
        for k, v in losses.items():
            assert last[k] == pytest.approx(float(v), rel=1e-6)
        vis.close()
        res = test_cli.main(["--dataroot", str(root), "--name", mode,
                             "--checkpoints_dir", str(tmp_path / "ck"),
                             "--dataset_mode", mode, "--results_dir",
                             str(tmp_path / "res"), "--num_test", "1",
                             *CLI_FLAGS[:10]])
        assert res["n_pairs"] == 1
    else:
        assert vis.plot_server is None
