"""Framebuffer conversion + image IO.

The reference presents through an R8G8B8A8 swapchain (DXRTRenderer.cpp:181);
here the display surface is a plain (H, W, 3) array converted to u8 and
written as PNG (the checkpoint/save capability the reference's File->Save
menu stub never implemented, DXRTMainWindow.cpp:155-158).  The PNG writer
uses only the standard library, so rendering needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey / RGB / RGBA


def to_u8(img) -> np.ndarray:
    """Clamp [0,1] float image to uint8 (UNORM-style round-to-nearest)."""
    arr = np.asarray(img, dtype=np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def png_bytes(img) -> bytes:
    """8-bit PNG of an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) image;
    float images are converted with :func:`to_u8`."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_u8(arr)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _PNG_COLOR_TYPE:
        raise ValueError(f"cannot write a {c}-channel image as PNG")
    # Each scanline is prefixed by its filter type (0 = none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
