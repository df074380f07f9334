"""The port's PNG codec (dfmir_tpu_torch/utils/png.py) against PIL: every
PNG that PIL writes in L, LA, RGB and RGBA, and rows of each of the five
filters written here through zlib, read bit-equal to
``np.asarray(Image.open(p))`` and to ``.convert("L")``; PIL reads the
port's L and RGB files bit-equal; palette, 16-bit, sub-byte and
interlaced images and broken files raise ValueError."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dfmir_tpu_torch.utils.png import read_png, write_png

MODES = {"L": (1, 0), "LA": (2, 4), "RGB": (3, 2), "RGBA": (4, 6)}
SIZES = [(1, 1), (45, 67), (256, 256)]      # (H, W)


def image(mode, shape, kind, seed=0):
    """(H, W[, C]) uint8: smooth content (PIL picks Sub, Up and Paeth
    rows) or noise."""
    H, W = shape
    C = MODES[mode][0]
    rng = np.random.default_rng(seed)
    if kind == "noise":
        a = rng.integers(0, 256, (H, W, C), dtype=np.uint8)
    else:
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        a = np.stack([(np.sin(yy / 7 + c) + np.cos(xx / (5 + c))) * 60 + 128
                      + rng.normal(0, 2, (H, W)) for c in range(C)], -1)
        a = np.clip(a, 0, 255).astype(np.uint8)
    return a[:, :, 0] if C == 1 else a


def pil_filters(path):
    """The filter bytes of the rows of a PIL-written 8-bit PNG."""
    with Image.open(path) as img:
        W, H = img.size
        C = len(img.getbands())
    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        n, t = struct.unpack(">I4s", data[pos:pos + 8])
        if t == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[y * (1 + W * C)] for y in range(H)}


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_reads_pil_files_bit_equal(tmp_path, mode, shape):
    filters = set()
    for kind in ("smooth", "noise"):
        p = tmp_path / f"{kind}.png"
        Image.fromarray(image(mode, shape, kind), mode).save(p)
        filters |= pil_filters(p)
        with Image.open(p) as ref:
            want, want_l = np.asarray(ref), np.asarray(ref.convert("L"))
        got = read_png(p)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_png(p, mode="L"), want_l)
    if shape == (256, 256):
        assert len(filters) >= 2, filters      # PIL mixed filters


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_rows(img, kinds):
    """Scanlines of ``img`` (H, W, C) with row y filtered by
    ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int64)
    left = np.zeros_like(x)
    left[:, C:] = x[:, :-C]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, C:] = x[:-1, :-C]
    preds = [np.zeros_like(x), left, up, (left + up) // 2,
             paeth(left, up, upleft)]
    rows = np.empty((H, 1 + W * C), np.uint8)
    for y, k in enumerate(kinds):
        rows[y, 0] = k
        rows[y, 1:] = (x[y] - preds[k][y]) % 256
    return rows


def chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_raw_png(path, W, H, depth, ctype, rows_bytes, interlace=0,
                  extra=b""):
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                             0, 0, interlace))
                + extra + chunk(b"IDAT", zlib.compress(rows_bytes))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", ["none", "sub", "up", "average", "paeth",
                                   "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_reads_each_filter_bit_equal(tmp_path, mode, kinds):
    C, ctype = MODES[mode]
    H, W = 37, 29
    img = image(mode, (H, W), "noise", seed=3).reshape(H, W, C)
    names = ["none", "sub", "up", "average", "paeth"]
    row_kinds = ([y % 5 for y in range(H)] if kinds == "mixed"
                 else [names.index(kinds)] * H)
    p = tmp_path / "f.png"
    write_raw_png(p, W, H, 8, ctype, filtered_rows(img, row_kinds).tobytes())
    with Image.open(p) as ref:
        want, want_l = np.asarray(ref), np.asarray(ref.convert("L"))
    np.testing.assert_array_equal(want.reshape(H, W, C), img)
    np.testing.assert_array_equal(read_png(p), want)
    np.testing.assert_array_equal(read_png(p, mode="L"), want_l)


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pil_reads_written_files_bit_equal(tmp_path, mode, shape):
    img = image(mode, shape, "noise", seed=5)
    p = tmp_path / "w.png"
    write_png(p, img)
    with Image.open(p) as back:
        assert back.mode == mode
        np.testing.assert_array_equal(np.asarray(back), img)
    np.testing.assert_array_equal(read_png(p), img)


def test_write_takes_one_channel_and_refuses_others(tmp_path):
    img = image("L", (9, 7), "noise")
    write_png(tmp_path / "a.png", img[:, :, None])
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match="L or RGB"):
        write_png(tmp_path / "b.png", image("RGBA", (9, 7), "noise"))
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "c.png", img.astype(np.float32))


def _palette(path):
    Image.fromarray(image("L", (8, 8), "noise")).convert("P").save(path)


def _sixteen_bit(path):
    img = Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    assert img.mode == "I;16"
    img.save(path)


def _one_bit(path):
    Image.fromarray(image("L", (8, 8), "noise") > 128).save(path)


def _interlaced(path):
    write_raw_png(path, 8, 8, 8, 0, bytes(8 * 9), interlace=1)


@pytest.mark.parametrize("make,feature", [
    (_palette, "palette"), (_sixteen_bit, "16-bit"), (_one_bit, "1-bit"),
    (_interlaced, "interlaced"),
])
def test_unsupported_images_raise(tmp_path, make, feature):
    p = tmp_path / "u.png"
    make(p)
    with pytest.raises(ValueError, match=feature) as err:
        read_png(p)
    assert str(p) in str(err.value)


def test_broken_files_raise(tmp_path):
    good = tmp_path / "g.png"
    write_png(good, image("L", (8, 8), "noise"))
    data = good.read_bytes()
    cases = {"not a PNG": b"GIF89a" + data[6:],
             "CRC mismatch": data[:40] + bytes([data[40] ^ 1]) + data[41:],
             "truncated": data[:30]}
    for what, blob in cases.items():
        p = tmp_path / "b.png"
        p.write_bytes(blob)
        with pytest.raises(ValueError, match=what):
            read_png(p)
    p = tmp_path / "short.png"
    write_raw_png(p, 8, 8, 8, 0, bytes(8 * 9 - 1))
    with pytest.raises(ValueError, match="truncated"):
        read_png(p)
    p = tmp_path / "filter.png"
    write_raw_png(p, 2, 1, 8, 0, bytes([7, 1, 2]))
    with pytest.raises(ValueError, match="row filter 7"):
        read_png(p)
