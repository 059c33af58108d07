"""A PNG codec in numpy and the standard library's zlib: the loader's last
depth decoder, after the native libpng one and OpenCV (it takes the place
of the reference's PIL branch, `tpuslam/data/tum.py:41-44`), and the
sequence writer's when OpenCV is absent.

Reads non-interlaced 8- and 16-bit grayscale and RGB images (samples
big-endian, as PNG stores them) with all five row filters.
None, Sub and Up rows are vectorised; Average and Paeth rows depend on the
pixel to their left and are undone byte by byte in Python, about a
thousand times slower a row (`bench/harness.bench_loader` reports the rate
of whichever decoder runs).  Writes 8-bit RGB and 16-bit grayscale with
filter None.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each PNG colour type this codec reads: grayscale, RGB
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRC checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before IEND")


def _unfilter_average(line: np.ndarray, prev: np.ndarray, bpp: int):
    cur = line.tolist()
    up = prev.tolist()
    for x in range(len(cur)):
        left = cur[x - bpp] if x >= bpp else 0
        cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
    return np.array(cur, dtype=np.uint8)


def _unfilter_paeth(line: np.ndarray, prev: np.ndarray, bpp: int):
    cur = line.tolist()
    up = prev.tolist()
    for x in range(len(cur)):
        if x >= bpp:
            a, c = cur[x - bpp], up[x - bpp]
        else:
            a = c = 0
        b = up[x]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return np.array(cur, dtype=np.uint8)


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The (height, stride) image bytes from the filtered scanlines."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum along each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prev
        elif kind == 3:
            cur = _unfilter_average(line, prev, bpp)
        elif kind == 4:
            cur = _unfilter_paeth(line, prev, bpp)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) or (H, W, C) uint8 / uint16 array."""
    header = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {color} at {depth} bits is not "
                         f"supported (grayscale or RGB at 8 or 16 bits)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) uint16 grayscale or (H, W, 3) uint8 RGB → PNG bytes (filter
    None on every row)."""
    img = np.asarray(img)
    if img.ndim == 2 and img.dtype == np.uint16:
        color, depth, samples = 0, 16, img.astype(">u2")
    elif img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color, depth, samples = 2, 8, img
    else:
        raise ValueError(f"encode_png takes (H, W) uint16 or (H, W, 3) uint8, "
                         f"got {img.shape} {img.dtype}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), dtype=np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
