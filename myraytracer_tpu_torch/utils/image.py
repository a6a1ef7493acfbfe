"""Image IO: float [H, W, 3] arrays <-> 8-bit RGB PNG files (NumPy + zlib).

Counterpart of ``myraytracer_tpu/utils/image.py`` without an imaging
package: the writer emits one zlib stream of unfiltered scanlines, the
reader takes 8-bit greyscale, RGB or RGBA files, non-interlaced, with
any of the five PNG row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels per PNG colour type (0 grey, 2 RGB, 4 grey + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp a float [0, 1] image to uint8 (round half up)."""
    arr = np.asarray(img, dtype=np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a float [H, W, 3] (or uint8) image to an RGB8 PNG file."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> [h, w * bpp] uint8."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:                                     # none
            cur = line
        elif ftype == 2:                                   # up
            cur = (line + prev) & 0xFF
        elif ftype == 1:                                   # sub
            cur = line.reshape(w, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):                              # average, paeth
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                up = prev[i]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = prev[i - bpp] if i >= bpp else 0
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit PNG file into a float32 [H, W, 3] array in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, RGB or "
                         f"RGBA PNGs are read (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w, ch)
    rgb = px[..., :3] if ch >= 3 else np.repeat(px[..., :1], 3, axis=2)
    return rgb.astype(np.float32) / 255.0
