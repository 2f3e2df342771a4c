"""Image I/O and display-orientation transforms.

The framework's canonical image layout is ``img[x, y, rgba]`` with x = screen
column, y = screen row from the top — the reference's column-major screen
buffer (pixel id x*SCR_HEIGHT + y, kernel.cu:25).

The reference's saved PNGs go through extra display plumbing
(transformSScreenVec4toFloat myApp.cu:1661-1688 -> GL point raster ->
glReadPixels + vertical flip, myApp.cu:1942-1956), which amounts to:

  * VRC / a1: a 180° rotation about Z in NDC (myApp.cu:933)  =>
      png[row r][col c] ~= img[W - c][r]  (±1 px point-raster offset)
  * TEST / a5: identity rotate (myApp.cu:1033)               =>
      png[row r][col c] ~= img[c][H - 1 - r]

:func:`to_display` applies the matching orientation so saved PNGs are
directly comparable with the reference's image_output/ goldens.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .config import Algorithm

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def to_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def to_display(img, algorithm: Algorithm = Algorithm.VRC) -> np.ndarray:
    """[W, H, C] canonical image -> [H, W, C] top-down display array."""
    arr = np.asarray(img)
    if algorithm is Algorithm.VRC:
        # png[r][c] = img[W-1-c][r] (180° rotate; -1 accounts for raster offset)
        return arr[::-1, :, :].transpose(1, 0, 2)
    # identity rotate: png[r][c] = img[c][H-1-r]
    return arr[:, ::-1, :].transpose(1, 0, 2)


def from_display(arr, algorithm: Algorithm = Algorithm.VRC) -> np.ndarray:
    """Inverse of :func:`to_display` — [H, W, C] -> canonical [W, H, C]."""
    arr = np.asarray(arr)
    if algorithm is Algorithm.VRC:
        return arr.transpose(1, 0, 2)[::-1, :, :]
    return arr.transpose(1, 0, 2)[:, ::-1, :]


def encode_png(arr) -> bytes:
    """8-bit RGB [H, W, 3] or RGBA [H, W, 4] uint8 array -> PNG bytes
    (zlib + struct; filter type 0 on every row)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, C]: 8-bit, non-interlaced grey (C=1),
    RGB (C=3) or RGBA (C=4), any of the five row filters."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 6: 4}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {color_type}, "
            f"interlace {interlace}); 8-bit grey/RGB/RGBA only")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        ftype, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:  # sub / average / paeth depend on the left neighbour
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - channels] if i >= channels else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[r] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, channels)


def save_png(path, img, algorithm: Algorithm = Algorithm.VRC) -> None:
    """Save a canonical [W, H, 3/4] float image as PNG in display orientation."""
    disp = to_uint8(to_display(img, algorithm))
    with open(path, "wb") as f:
        f.write(encode_png(disp[..., :3]))


def load_png(path) -> np.ndarray:
    """Load a PNG as float [H, W, 3] in [0, 1] (display orientation)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0
