"""Camera ray generation — batched counterpart of the DXR raygen shader.

Reproduces HLSL/ray_tracing_shaders.hlsl:21-70 exactly, but vectorized over
the whole pixel grid instead of one GPU thread per pixel:

* pixel center offset +0.5, normalize by width/height,
* NDC mapping x -> 2x-1, y -> 1-2y (y flip),
* aspect scaling of x by width/height,
* camera-space direction normalize((x, y, -1)),
* world direction = normalize(R @ dir) with the camera rotation applied as a
  column-vector product (``mul(cameraRotation, v)`` on a row_major-uploaded
  matrix, hlsl:47 + DXRTRenderer.cpp:258-265),
* TMin = 0.001, TMax = 10000 (hlsl:51-52).

Unlike the reference, width/height are parameters (the reference hard-codes
1920x1080 in the shader, hlsl:24-25).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

T_MIN = 0.001
T_MAX = 10000.0


def pick_tile(rows: int, width: int, tile_h: int = 8, tile_w: int = 32):
    """Largest (th, tw) <= (tile_h, tile_w) dividing the image, or None.

    The primary-ray schedule: 8x32 pixel tiles are 256 rays, one tile of
    the intersection kernel (bvh.pallas_intersect.TILE_R), and 8 and 32
    divide common resolutions (1080 is not divisible by 16).  Other tile
    shapes not measured on the card."""

    def pick(total, want):
        for c in (want, 32, 24, 16, 12, 8, 6, 4, 3, 2):
            if c <= want and total % c == 0:
                return c
        return 1

    th = pick(rows, tile_h)
    tw = pick(width, tile_w)
    if th * tw < 16:  # degenerate tiling buys nothing
        return None
    return th, tw


def generate_rays_tiled(position, rotation, width: int, height: int,
                        tile_h: int, tile_w: int, offset=(0.5, 0.5),
                        row_start=0, rows: int | None = None):
    """Primary rays in TILE-MAJOR order, computed arithmetically.

    Equivalent to ``generate_rays(...)[tile_perm(...)]`` but with no
    permutation gather.  Pixel (px, py) lands at flat index
    ((ty*tiles_x + tx) * tile_h + ry) * tile_w + rx.
    """
    position = jnp.asarray(position, jnp.float32)
    rotation = jnp.asarray(rotation, jnp.float32)
    offset = jnp.asarray(offset, jnp.float32)
    rows = height if rows is None else rows
    ty_n, tx_n = rows // tile_h, width // tile_w
    n = ty_n * tx_n * tile_h * tile_w

    # Flat (N,) arithmetic: the tile-major index is decomposed with integer
    # div/mod instead of 4D (ty, tx, th, tw) broadcasts.
    i = jnp.arange(n, dtype=jnp.int32)
    rx = i % tile_w
    t1 = i // tile_w
    ry = t1 % tile_h
    t2 = t1 // tile_h
    tx = t2 % tx_n
    ty = t2 // tx_n
    px = (tx * tile_w + rx).astype(jnp.float32)
    py = (ty * tile_h + ry).astype(jnp.float32) + row_start

    x = (2.0 * ((px + offset[0]) / width) - 1.0) * (width / height)
    y = 1.0 - 2.0 * ((py + offset[1]) / height)
    # Rotation as nine scalar-broadcast FMAs: exact f32, with no 3-wide
    # matrix product (whose precision would follow the matmul setting).
    inv_len = jax.lax.rsqrt(x * x + y * y + 1.0)
    dx, dy, dz = x * inv_len, y * inv_len, -inv_len
    wx = rotation[0, 0] * dx + rotation[0, 1] * dy + rotation[0, 2] * dz
    wy = rotation[1, 0] * dx + rotation[1, 1] * dy + rotation[1, 2] * dz
    wz = rotation[2, 0] * dx + rotation[2, 1] * dy + rotation[2, 2] * dz
    wlen = jax.lax.rsqrt(wx * wx + wy * wy + wz * wz)
    dir_world = jnp.stack([wx * wlen, wy * wlen, wz * wlen], axis=-1)
    origins = jnp.broadcast_to(position, (n, 3))
    return origins, dir_world


def tile_perm(rows: int, width: int, tile_h: int = 8, tile_w: int = 32):
    """Permutation regrouping row-major pixels into (tile_h x tile_w) tiles.

    Coherent square-ish ray tiles overlap ~10-30x fewer BVH clusters than
    row strips of the same size (measured on the 100k-tri bench scene), which
    directly scales the binned intersector's work.  Returns an (rows*width,)
    i32 permutation p such that rays[p] is tile-major, or None if no
    reasonable tile size divides the image (callers then keep row order).
    """
    import numpy as np

    t = pick_tile(rows, width, tile_h, tile_w)
    if t is None:
        return None
    th, tw = t
    idx = np.arange(rows * width, dtype=np.int32).reshape(rows, width)
    return (
        idx.reshape(rows // th, th, width // tw, tw)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )


# 4x rotated-grid supersampling offsets (BASELINE config 4); spp=1 uses the
# reference's pixel-center +0.5 (hlsl:35-36).
RGSS_OFFSETS = ((0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875))


def generate_rays(position, rotation, width: int, height: int, offset=(0.5, 0.5),
                  row_start=0, rows: int | None = None):
    """Primary rays for every pixel of a (full-width) row tile.

    Args:
      position: (3,) f32 camera position.
      rotation: (3, 3) f32 camera rotation (columns = right/up/forward).
      width, height: static FULL image size (the projection frustum).
      offset: subpixel sample offset; (0.5, 0.5) = pixel center (reference).
        May be a traced (2,) array (sample-sharded rendering).
      row_start: first pixel row of the tile (traced OK — multi-chip tiles).
      rows: tile height (static); None = full image.

    Returns:
      origins (rows*W, 3), directions (rows*W, 3) — row-major pixel order
      (pixel (px, py) at tile index (py-row_start)*width + px, matching the
      reference's UAV layout when the tile is the whole image).
    """
    position = jnp.asarray(position, jnp.float32)
    rotation = jnp.asarray(rotation, jnp.float32)
    offset = jnp.asarray(offset, jnp.float32)
    rows = height if rows is None else rows

    px = jnp.arange(width, dtype=jnp.float32)[None, :]  # (1, W)
    py = (jnp.arange(rows, dtype=jnp.float32) + row_start)[:, None]  # (rows, 1)

    x = (px + offset[0]) / width
    y = (py + offset[1]) / height
    x = 2.0 * x - 1.0
    y = 1.0 - 2.0 * y
    x = x * (width / height)

    x = jnp.broadcast_to(x, (rows, width))
    y = jnp.broadcast_to(y, (rows, width))
    # Unrolled rotation — see generate_rays_tiled.
    inv_len = jax.lax.rsqrt(x * x + y * y + 1.0)
    dx, dy, dz = x * inv_len, y * inv_len, -inv_len
    wx = rotation[0, 0] * dx + rotation[0, 1] * dy + rotation[0, 2] * dz
    wy = rotation[1, 0] * dx + rotation[1, 1] * dy + rotation[1, 2] * dz
    wz = rotation[2, 0] * dx + rotation[2, 1] * dy + rotation[2, 2] * dz
    wlen = jax.lax.rsqrt(wx * wx + wy * wy + wz * wz)
    dir_world = jnp.stack([wx * wlen, wy * wlen, wz * wlen], axis=-1)

    origins = jnp.broadcast_to(position, (rows, width, 3))
    return origins.reshape(-1, 3), dir_world.reshape(-1, 3)
