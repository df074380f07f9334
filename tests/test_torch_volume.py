"""The port's volume data layer (dfmir_tpu_torch/data/volume.py) against
the JAX package's dfmir_tpu/data/volume.py on the same files: load_volume
(.npy, .npz with and without the ``vol`` key, a trailing size-1 axis, the
ValueError on anything but 3-D), normalize_minmax and crop_or_pad
bit-equal; VolumeDataset's items and the loader's batches (shuffle,
drop_last, A[i] with B[i % B_size], max_dataset_size) np.array_equal to
JAX's after NDHWC -> NCDHW.  And chip_smoke.py's numpy copy of
scripts/make_soak_data.py's 3-D writer writes the script's files bit for
bit."""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from dfmir_tpu.data import create_dataset as jax_create_dataset
from dfmir_tpu.data import volume as jax_volume
from dfmir_tpu_torch.compat.convert import to_nchw
from dfmir_tpu_torch.data import create_dataset
from dfmir_tpu_torch.data import volume

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent


def write(path, arr, kind):
    if kind == "npy":
        np.save(path, arr)
    elif kind == "npz_vol":
        np.savez(path, other=np.zeros(3), vol=arr)
    else:
        np.savez(path, first=arr, second=np.zeros(3))


@pytest.mark.parametrize("kind", ["npy", "npz_vol", "npz_first"])
@pytest.mark.parametrize("shape,dtype", [
    ((5, 6, 7), np.float32), ((5, 6, 7, 1), np.float64), ((4, 4, 4), np.int16)])
def test_load_volume_matches_jax(tmp_path, rng, kind, shape, dtype):
    arr = (rng.standard_normal(shape) * 100).astype(dtype)
    path = str(tmp_path / ("v.npy" if kind == "npy" else "v.npz"))
    write(path, arr, kind)
    mine, ref = volume.load_volume(path), jax_volume.load_volume(path)
    assert mine.dtype == ref.dtype == np.float32
    assert mine.shape == ref.shape == shape[:3]
    assert np.array_equal(mine, ref)


@pytest.mark.parametrize("shape", [(5, 6), (2, 3, 4, 2), (2, 3, 4, 5, 1)])
def test_load_volume_refuses_other_shapes(tmp_path, shape):
    path = str(tmp_path / "v.npy")
    np.save(path, np.zeros(shape, np.float32))
    for mod in (volume, jax_volume):
        with pytest.raises(ValueError, match="3-D volume"):
            mod.load_volume(path)


@pytest.mark.parametrize("case", ["random", "constant", "offset"])
def test_normalize_minmax_matches_jax(rng, case):
    vol = {"random": rng.standard_normal((6, 7, 8)) * 50,
           "constant": np.full((4, 5, 6), 3.25),
           "offset": rng.random((5, 5, 5)) * 1e-3 + 1e4}[case]
    vol = vol.astype(np.float32)
    mine, ref = volume.normalize_minmax(vol), jax_volume.normalize_minmax(vol)
    assert mine.dtype == ref.dtype
    assert np.array_equal(mine, ref)
    if case == "constant":
        assert not mine.any() and mine.shape == vol.shape
    else:
        assert mine.min() == 0.0 and mine.max() == 1.0


@pytest.mark.parametrize("shape,target", [
    ((9, 8, 7), (6, 6, 6)),        # crop: odd and even remainders
    ((4, 5, 6), (8, 8, 8)),        # pad: odd and even remainders
    ((10, 3, 6), (7, 8, 6)),       # crop, pad and keep on different axes
    ((5, 12, 2), (8, 7, 5)),
])
def test_crop_or_pad_matches_jax(rng, shape, target):
    vol = rng.standard_normal(shape).astype(np.float32)
    mine = volume.crop_or_pad(vol, target)
    ref = jax_volume.crop_or_pad(vol, target)
    assert mine.shape == ref.shape == target
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)


@pytest.fixture(scope="module")
def vol_root(tmp_path_factory):
    """5 A and 3 B volumes of assorted shapes and files (A[i] pairs with
    B[i % 3]), and 2 test pairs."""
    root = tmp_path_factory.mktemp("vols")
    rng = np.random.default_rng(11)
    shapes = [(14, 12, 10), (10, 10, 10, 1), (9, 13, 11), (12, 12, 12),
              (8, 16, 10)]
    for phase, counts in (("train", (5, 3)), ("test", (2, 2))):
        for side, n in zip("AB", counts):
            d = root / f"{phase}{side}"
            d.mkdir()
            for i in range(n):
                arr = rng.standard_normal(shapes[(i + (side == "B"))
                                                 % len(shapes)]) * 30 + i
                kind = ("npy", "npz_vol", "npz_first")[i % 3]
                name = f"vol_{i:02d}.{'npy' if kind == 'npy' else 'npz'}"
                write(str(d / name), arr.astype(np.float32), kind)
            (d / "notes.txt").write_text("not a volume")
    return root


def vol_opt(root, **kw):
    base = dict(dataroot=str(root), phase="train", isTrain=True,
                dataset_mode="volume", max_dataset_size=float("inf"),
                seed=3, batch_size=2, serial_batches=False, num_threads=0,
                vol_size=12)
    base.update(kw)
    return argparse.Namespace(**base)


def test_dataset_items_match_jax(vol_root):
    opt = vol_opt(vol_root)
    mine, ref = volume.VolumeDataset(opt), jax_volume.VolumeDataset(opt)
    assert len(mine) == len(ref) == 5
    assert mine.A_paths == ref.A_paths and mine.B_paths == ref.B_paths
    for i in range(len(ref)):
        m, r = mine[i], ref[i]
        assert m["A"].shape == (1, 12, 12, 12) and m["A"].dtype == np.float32
        for k in ("A", "B"):
            assert np.array_equal(m[k], np.moveaxis(r[k], -1, 0))
        assert (m["A_paths"], m["B_paths"]) == (r["A_paths"], r["B_paths"])
        assert m["B_paths"] == ref.B_paths[i % 3]


@pytest.mark.parametrize("kw", [
    dict(),                                        # shuffle, drop_last
    dict(batch_size=1, serial_batches=True),       # in order
    dict(phase="test", isTrain=False, batch_size=2, vol_size=9),
    dict(max_dataset_size=3, batch_size=1, num_threads=2),
])
def test_loader_batches_match_jax(vol_root, kw):
    opt = vol_opt(vol_root, **kw)
    mine_loader, ref_loader = create_dataset(opt), jax_create_dataset(opt)
    assert len(mine_loader) == len(ref_loader)
    for epoch in (1, 2):
        mine_loader.set_epoch(epoch)
        ref_loader.set_epoch(epoch)
        mine, ref = list(mine_loader), list(ref_loader)
        assert len(mine) == len(ref) > 0
        for m, r in zip(mine, ref):
            for k in ("A", "B"):
                assert m[k].dtype == r[k].dtype == np.float32
                assert np.array_equal(m[k], to_nchw(r[k]))
            assert m["A_paths"] == r["A_paths"]
            assert m["B_paths"] == r["B_paths"]


@pytest.mark.parametrize("flow_amp,texture", [(6.0, 0.35), (2.5, 0.0)])
def test_numpy_writer_matches_make_soak_data(tmp_path, flow_amp, texture):
    ref_dir, mine_dir = tmp_path / "script", tmp_path / "mine"
    subprocess.run([sys.executable, str(ROOT / "scripts/make_soak_data.py"),
                    "--ndims", "3", "--out", str(ref_dir), "--size", "16",
                    "--n_train", "3", "--n_test", "2", "--seed", "5",
                    "--flow_amp", str(flow_amp), "--texture", str(texture)],
                   check=True, capture_output=True, timeout=120)
    chip_smoke.write_volumes(str(mine_dir), 3, 2, 16, seed=5,
                             flow_amp=flow_amp, texture=texture)
    ref_files = sorted(p.relative_to(ref_dir) for p in ref_dir.rglob("*.npy"))
    mine_files = sorted(p.relative_to(mine_dir)
                        for p in mine_dir.rglob("*.npy"))
    assert mine_files == ref_files and len(ref_files) == 4 * 5
    for rel in ref_files:
        a, b = np.load(mine_dir / rel), np.load(ref_dir / rel)
        assert a.dtype == b.dtype and a.shape == b.shape == (16, 16, 16)
        assert np.array_equal(a, b), rel
    labels = np.load(ref_dir / "trainA_label" / "pair_000.npy")
    assert set(np.unique(labels)) == {0, 60, 120, 180}
