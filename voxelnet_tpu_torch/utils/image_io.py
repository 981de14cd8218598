"""PNG files on the standard library's zlib and numpy, for the viz and the
raw-drive tools where cv2 (and PIL) do not import.

`read_png_bgr(path)` returns what `cv2.imread(path)` returns for the PNGs
it reads: a uint8 (H, W, 3) array in BGR order (grey replicated to three
channels, the alpha channel dropped), so that code written for cv2 keeps
its channel logic. It reads 8-bit grey, RGB and RGBA images, not
interlaced, with any of the five scanline filters, and checks every
chunk's CRC; any other kind of PNG (16-bit, palette, grey + alpha,
interlaced) raises `ValueError`. A missing file raises
`FileNotFoundError` (`cv2.imread` returns None).

`write_png_rgb(path, rgb)` writes a uint8 (H, W, 3) RGB array as an 8-bit
RGB PNG (filter 0 on every row): what `cv2.imwrite(path,
cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))` stores.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}        # colour type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in its {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row filters of a non-interlaced 8-bit image ->
    (height, width, bpp) uint8. Rows of filter 0-2 are undone a row at a
    time; Average and Paeth depend on the pixel to the left, so they are
    undone along anti-diagonals, a pixel of every such row at once."""
    rows = raw.reshape(height, 1 + width * bpp)
    kinds, data = rows[:, 0], rows[:, 1:].reshape(height, width, bpp)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = np.zeros((height + 1, width + 1, bpp), np.int32)  # zero border
    y = 0
    while y < height:
        if kinds[y] >= 3:               # a run of Average / Paeth rows
            end = y
            while end < height and kinds[end] >= 3:
                end += 1
            _wavefront(out, data, kinds, np.arange(y, end), width)
            y = end
            continue
        cur = data[y].astype(np.int32)
        if kinds[y] == 1:               # Sub
            cur = np.cumsum(cur, axis=0)
        elif kinds[y] == 2:             # Up
            cur = cur + out[y, 1:]
        out[y + 1, 1:] = cur & 0xFF
        y += 1
    return out[1:, 1:].astype(np.uint8)


def _wavefront(out, data, kinds, ys: np.ndarray, width: int) -> None:
    """Undo the consecutive Average / Paeth rows `ys` in `out`: step t
    handles pixel x = t - i of the run's i-th row, whose left, upper and
    upper-left neighbours earlier steps have done."""
    n = len(ys)
    k = kinds[ys]
    for t in range(width + n - 1):
        i = np.arange(max(0, t - width + 1), min(n, t + 1))
        y, x = ys[i], t - i
        a = out[y + 1, x]              # left (out is offset by 1)
        b = out[y, x + 1]              # up
        c = out[y, x]                  # up-left
        avg = (a + b) >> 1
        pred = np.where((k[i] == 3)[:, None], avg, _paeth(a, b, c))
        out[y + 1, x + 1] = (data[y, x].astype(np.int32) + pred) & 0xFF


def read_png_bgr(path: str) -> np.ndarray:
    """A PNG file -> uint8 (H, W, 3) BGR, as `cv2.imread` gives it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit grey (0), RGB (2) and RGBA (6) PNGs "
            "that are not interlaced are read")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data, "
                         f"{height * (1 + width * bpp)} expected")
    pixels = _unfilter(raw, height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


def write_png_rgb(path: str, rgb: np.ndarray) -> None:
    """Write a uint8 (H, W, 3) RGB array as an 8-bit RGB PNG."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png_rgb takes uint8 (H, W, 3), got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
