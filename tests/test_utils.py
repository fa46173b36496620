"""Image IO and compile-cache location helpers."""

import struct
import zlib

import numpy as np
import pytest

from directx_raytracer.utils.compile_cache import (
    REPO_ROOT,
    compile_cache_dir,
)
from directx_raytracer.utils.image import png_bytes, to_u8, write_png


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's output: 8-bit, unfiltered rows."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = header[:4]
    assert depth == 8
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (raw[:, 0] == 0).all()  # filter type "none" on every row
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trip(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, size=(7, 11, channels), dtype=np.uint8)
    path = tmp_path / "img.png"
    write_png(str(path), img)
    data = path.read_bytes()
    np.testing.assert_array_equal(_decode_png(data), img)
    try:
        from PIL import Image
    except ImportError:
        return
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(img.shape), img)


def test_png_float_input_uses_unorm_rounding():
    img = np.linspace(-0.5, 1.5, 24, dtype=np.float32).reshape(2, 4, 3)
    np.testing.assert_array_equal(_decode_png(png_bytes(img)), to_u8(img))
    np.testing.assert_array_equal(_decode_png(png_bytes(img[:, :, 0])),
                                  to_u8(img[:, :, :1]))


def test_png_rejects_two_channels():
    with pytest.raises(ValueError, match="2-channel"):
        png_bytes(np.zeros((2, 2, 2), np.uint8))


def test_compile_cache_follows_env_var(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache")}
    assert compile_cache_dir(env) == str(tmp_path / "cache")


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_compile_cache_defaults_to_repo_root(env):
    import os

    path = compile_cache_dir(env)
    assert path == os.path.join(REPO_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(REPO_ROOT, "pyproject.toml"))
