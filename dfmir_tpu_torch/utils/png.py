"""A PNG codec on numpy and ``zlib``: the port's image I/O, with no PIL.

Reads 8-bit, non-interlaced PNGs of colour type 0 (L), 2 (RGB), 4 (LA) and
6 (RGBA), every row filter (None, Sub, Up, Average, Paeth).  ``mode="L"``
converts as PIL's ``Image.convert("L")`` does, bit for bit: LA keeps its L
band, RGB(A) takes ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``.
Palette, 16-bit, sub-byte and interlaced images raise ``ValueError``
naming the file and the feature.  Writes 8-bit L and RGB.

Sub is a running sum along the row and Up an add of the row above, both
vectorised; Average and Paeth depend on the pixel to their left after
its own reconstruction, so they run as a loop over the row's bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (0 L, 2 RGB, 4 LA, 6 RGBA)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path):
    """Yield (type, body) of each chunk, checking lengths and CRCs."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def _unfilter_average(line: np.ndarray, prev: np.ndarray, bpp: int):
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(bpp):
        cur[i] = (cur[i] + (up[i] >> 1)) & 255
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: np.ndarray, prev: np.ndarray, bpp: int):
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(bpp):        # a = c = 0: the predictor is b
        cur[i] = (cur[i] + up[i]) & 255
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        # p = a + b - c; |p - a| = |b - c|, |p - b| = |a - c|,
        # |p - c| = |(b - c) + (a - c)|
        pa, pb = b - c, a - c
        pc = abs(pa + pb)
        pa, pb = abs(pa), abs(pb)
        if pa <= pb and pa <= pc:
            cur[i] = (cur[i] + a) & 255
        elif pb <= pc:
            cur[i] = (cur[i] + b) & 255
        else:
            cur[i] = (cur[i] + c) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(rows: np.ndarray, width: int, bpp: int, path) -> np.ndarray:
    """(H, 1 + W * bpp) filtered scanlines -> (H, W * bpp) pixels."""
    H = rows.shape[0]
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())} is "
                         f"not one of the five PNG filters")
    out = np.empty((H, width * bpp), np.uint8)
    prev = np.zeros(width * bpp, np.uint8)
    for y in range(H):
        line, kind = rows[y, 1:], kinds[y]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(width, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            np.add(line, prev, out=out[y])
        elif kind == 3:
            out[y] = _unfilter_average(line, prev, bpp)
        else:
            out[y] = _unfilter_paeth(line, prev, bpp)
        prev = out[y]
    return out


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """(H, W[, C]) uint8 -> (H, W) uint8 as PIL's ``convert("L")``."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:           # L, LA: the L band
        return np.ascontiguousarray(img[:, :, 0])
    rgb = img[:, :, :3].astype(np.uint32)
    return ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
             + rgb[:, :, 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_png(path, mode=None) -> np.ndarray:
    """Decode the PNG at ``path``: (H, W) uint8 for L, else (H, W, C) with
    C = 2 (LA), 3 (RGB) or 4 (RGBA), as ``np.asarray(Image.open(path))``
    gives them.  ``mode="L"`` returns the grayscale conversion."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, ctype, compression, filtering, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs (colour type 3) are not "
                         f"supported")
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not valid")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported, "
                         f"only 8-bit")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         f"supported")
    if compression or filtering:
        raise ValueError(f"{path}: unknown PNG compression or filter "
                         f"method")
    C = CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    need = H * (1 + W * C)
    if len(raw) < need:
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, count=need).reshape(H, 1 + W * C)
    img = _unfilter(rows, W, C, path).reshape(H, W, C)
    if C == 1:
        img = img[:, :, 0]
    if mode == "L":
        return to_grayscale(img)
    if mode is not None:
        raise ValueError(f"mode must be None or 'L', got {mode!r}")
    return img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path, img: np.ndarray) -> None:
    """Write (H, W) or (H, W, 1) uint8 as an L PNG, (H, W, 3) as RGB."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"write_png writes L or RGB, got shape {img.shape}")
    H, W = img.shape[:2]
    rows = np.zeros((H, 1 + img[0].size), np.uint8)     # filter 0 (None)
    rows[:, 1:] = img.reshape(H, -1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
