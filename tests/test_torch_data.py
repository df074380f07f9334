"""The port's data layer (dfmir_tpu_torch/data/) against the JAX package's
dfmir_tpu.data on the same files, seed and epochs: the loader's uint8
batches bit-equal to JAX's after NHWC -> NCHW, paths equal, over 2 epochs
with shuffle, the pair flip and A's and B's crops and flips; a real crop
(72^2 images at --load_size 72 --crop_size 64) and a resize (64^2 images
at --load_size 72, PIL present); the float path bit-equal to JAX's
--uint8_transfer False; the dequantization within 1 ulp of that path
and within 1 ulp of 1.0 (1.2e-7) of JAX's _dequant_u8.  Pairs come from
scripts/make_soak_data.py (a subprocess)."""

import argparse
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfmir_tpu.data import create_dataset as jax_create_dataset
from dfmir_tpu.models.registration import _dequant_u8
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.data import create_dataset, image_folder
from dfmir_tpu_torch.data.transforms import apply_transform
from dfmir_tpu_torch.models.registration import dequant_u8
from dfmir_tpu_torch.utils.png import read_png, write_png
from torch_threads import few_threads  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    soak = base / "soak"
    subprocess.run([sys.executable, str(ROOT / "scripts/make_soak_data.py"),
                    "--out", str(soak), "--size", "64", "--n_train", "5",
                    "--n_test", "2"], check=True, capture_output=True,
                   timeout=120)
    rng = np.random.default_rng(7)
    big = base / "big"
    for side in "AB":
        d = big / f"train{side}"
        d.mkdir(parents=True)
        for i in range(5):
            yy, xx = np.mgrid[0:72, 0:72]
            img = (np.sin(yy / (4 + i)) * np.cos(xx / 6) * 100 + 128
                   + rng.integers(0, 20, (72, 72)))
            write_png(d / f"im_{i:02d}.png", img.astype(np.uint8))
    return {"soak": soak, "big": big}


def opt_for(root, **kw):
    base = dict(dataroot=str(root), phase="train", isTrain=True,
                dataset_mode="unaligned", max_dataset_size=float("inf"),
                seed=3, cache_images_mb=512, uint8_transfer=True,
                preprocess="resize_and_crop", load_size=64, crop_size=64,
                no_flip=False, batch_size=2, serial_batches=False,
                num_threads=0, n_epochs=1, direction="AtoB")
    base.update(kw)
    return argparse.Namespace(**base)


def batches(loader, epochs=(1, 2)):
    out = []
    for epoch in epochs:
        loader.set_epoch(epoch)
        out += list(loader)
    return out


def assert_batches_equal(mine, ref, dtype):
    assert len(mine) == len(ref) > 0
    for m, r in zip(mine, ref):
        for k in ("A", "B"):
            assert m[k].dtype == dtype and r[k].dtype == dtype
            np.testing.assert_array_equal(m[k], to_nchw(r[k]))
        assert m["A_paths"] == r["A_paths"]
        assert m["B_paths"] == r["B_paths"]


CASES = {
    # name: (root, options)
    "soak64": ("soak", {}),
    "crop72to64": ("big", dict(load_size=72)),
    "resize64to72": ("soak", dict(load_size=72)),
    "threads": ("soak", dict(num_threads=2, batch_size=3)),
    "scale_width": ("big", dict(preprocess="scale_width_and_crop",
                                load_size=72)),
    "finetune": ("big", dict(load_size=72, n_epochs=1, serial_batches=True,
                             max_dataset_size=4)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_uint8_batches_bit_equal_to_jax(roots, case):
    root, kw = CASES[case]
    opt = opt_for(roots[root], **kw)
    mine = batches(create_dataset(opt))
    ref = batches(jax_create_dataset(opt))
    assert_batches_equal(mine, ref, np.uint8)
    flat = np.concatenate([b["A"] for b in mine])
    assert flat.shape[1:] == (1, 64, 64)
    if case == "soak64":     # the pair flip and shuffle moved something
        first = [b["A_paths"] for b in batches(create_dataset(opt), (1,))]
        second = [b["A_paths"] for b in batches(create_dataset(opt), (2,))]
        assert first != second


def test_float_batches_bit_equal_to_jax(roots):
    opt = opt_for(roots["big"], load_size=72, uint8_transfer=False)
    mine = batches(create_dataset(opt))
    assert_batches_equal(mine, batches(jax_create_dataset(opt)), np.float32)
    u8 = batches(create_dataset(opt_for(roots["big"], load_size=72)))
    for f, u in zip(mine, u8):
        for k in ("A", "B"):
            deq = dequant_u8(torch.from_numpy(u[k])).numpy()
            np.testing.assert_array_max_ulp(deq, f[k], maxulp=1)
            # JAX's device dequantization, within 1 ulp of 1.0 (its own
            # suite's bar: XLA may fold /255 * 2 into one multiply)
            ref = np.asarray(_dequant_u8(jnp.asarray(u[k])))
            assert np.abs(deq - ref).max() <= 1.2e-7


def test_eval_loader_keeps_every_pair(roots):
    opt = opt_for(roots["soak"], phase="test", isTrain=False,
                  serial_batches=True, no_flip=True, batch_size=1)
    mine = list(create_dataset(opt))
    assert_batches_equal(mine, list(jax_create_dataset(opt)), np.uint8)
    assert [b["A_paths"][0].rsplit("/", 1)[1] for b in mine] == [
        "pair_000.png", "pair_001.png"]
    train = create_dataset(opt_for(roots["soak"], batch_size=2))
    assert len(train) == 4 and len(list(train)) == 2    # drops the last


def test_cache_holds_decoded_images(roots):
    opt = opt_for(roots["soak"])
    loader = create_dataset(opt)
    first = batches(loader, (1,))
    cache = loader.dataset.cache
    assert 0 < cache.nbytes <= 10 * 64 * 64
    path = loader.dataset.A_paths[0]
    img = image_folder.load_image(path, cache=cache)
    assert img is cache.get((path, True)) and not img.flags.writeable
    np.testing.assert_array_equal(img, read_png(path, mode="L"))
    again = batches(loader, (1,))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["A"], b["A"])
    small = image_folder.ImageCache(cache_mb=1e-3)
    image_folder.load_image(path, cache=small)
    assert small.nbytes == 0                            # over its capacity


def test_resize_without_pil_raises(roots, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = read_png(roots["soak"] / "trainA" / "pair_000.png", mode="L")
    same = apply_transform(opt_for(roots["soak"]), img,
                           rng=np.random.default_rng(0), out_dtype="uint8")
    assert same.shape == (1, 64, 64)
    with pytest.raises(ImportError, match="PIL"):
        apply_transform(opt_for(roots["soak"], load_size=72), img,
                        rng=np.random.default_rng(0))


PREPROCESS = ["resize_and_crop", "crop", "scale_width_and_crop",
              "scale_shortside_and_crop", "fixsize", "zoom_and_crop",
              "trim", "patch", "none"]


@pytest.mark.parametrize("preprocess", PREPROCESS)
def test_every_preprocess_mode_matches_jax(preprocess):
    """The whole chain per mode, on a 70x90 image (every crop, trim and
    patch draws; the resizes through PIL, present here), with the same
    generator, uint8 and float."""
    from PIL import Image

    from dfmir_tpu.data.transforms import apply_transform as jax_apply
    from dfmir_tpu.data.transforms import get_params as jax_params
    from dfmir_tpu_torch.data.transforms import get_params

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (70, 90), dtype=np.uint8)
    opt = opt_for("unused", preprocess=preprocess, load_size=80,
                  crop_size=64)
    for out_dtype in ("uint8", "float32"):
        for seed in range(3):
            mine = apply_transform(opt, img, rng=np.random.default_rng(seed),
                                   out_dtype=out_dtype)
            ref = jax_apply(opt, Image.fromarray(img),
                            rng=np.random.default_rng(seed),
                            out_dtype=out_dtype)
            assert mine.dtype == ref.dtype
            np.testing.assert_array_equal(mine, np.moveaxis(ref, -1, 0))
    # pre-drawn parameters, shared by a pair
    params = get_params(opt, (90, 70), np.random.default_rng(4))
    assert dataclasses.asdict(params) == dataclasses.asdict(
        jax_params(opt, (90, 70), np.random.default_rng(4)))
    mine = apply_transform(opt, img, params=params,
                           rng=np.random.default_rng(5), convert=False)
    ref = jax_apply(opt, Image.fromarray(img), params=params,
                    rng=np.random.default_rng(5), convert=False)
    np.testing.assert_array_equal(mine, np.asarray(ref))


def test_resize_helpers_match_jax(tmp_path, monkeypatch):
    from dfmir_tpu.utils import util as jax_util
    from dfmir_tpu_torch.utils import util

    rng = np.random.default_rng(2)
    arr = np.tanh(rng.standard_normal((2, 1, 16, 12))).astype(np.float32)
    np.testing.assert_array_equal(
        util.correct_resize(arr, (8, 10)),
        np.moveaxis(jax_util.correct_resize(np.moveaxis(arr, 1, -1),
                                            (8, 10)), -1, 1))
    lab = rng.integers(0, 4, (2, 1, 16, 12)) * 60
    np.testing.assert_array_equal(
        util.correct_resize_label(lab, (8, 10)),
        jax_util.correct_resize_label(np.moveaxis(lab, 1, -1), (8, 10)))
    np.testing.assert_array_equal(util.tensor2im(torch.from_numpy(arr)),
                                  jax_util.tensor2im(np.moveaxis(arr, 1, -1)))
    im = util.tensor2im(arr)
    for ratio in (1.0, 1.5, 0.5):
        util.save_image(im, str(tmp_path / "mine.png"), aspect_ratio=ratio)
        jax_util.save_image(im, str(tmp_path / "ref.png"),
                            aspect_ratio=ratio)
        np.testing.assert_array_equal(read_png(tmp_path / "mine.png"),
                                      read_png(tmp_path / "ref.png"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    util.save_image(im, str(tmp_path / "plain.png"))     # needs no PIL
    with pytest.raises(ImportError, match="correct_resize needs PIL"):
        util.correct_resize(arr, (8, 10))
