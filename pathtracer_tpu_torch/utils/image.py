"""Image IO and comparison metrics, with the standard library only.

Port of ``pathtracer_tpu/utils/image.py`` without Pillow: ``encode_png``
makes the bytes of an RGB8 PNG (filter type 0 on every row) with ``zlib`` and
``struct``, ``write_png`` writes them, and ``read_png`` reads that format
back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, ~] -> uint8 with clamping (Uint8ClampedArray)."""
    return np.clip(np.asarray(img) * 255.0, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """An [H, W, 3] float (linear, post-tonemap) or uint8 image as the bytes
    of an RGB8 PNG."""
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3], got {arr.shape}")
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(arr).reshape(h, w * 3)],
        axis=1,
    )
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return b"".join([
        _SIGNATURE,
        _chunk(b"IHDR", header),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] float (linear, post-tonemap) or uint8 image as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG with unfiltered rows (as ``write_png`` writes
    them) into an [H, W, 3] float array in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: only 8-bit RGB non-interlaced PNGs are read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * 3)
    if np.any(rows[:, 0] != 0):
        raise ValueError(f"{path}: only unfiltered rows are read")
    return rows[:, 1:].reshape(h, w, 3).astype(np.float32) / 255.0


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error between two [H, W, 3] float images in [0, 1]."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return float(np.mean((a - b) ** 2))
