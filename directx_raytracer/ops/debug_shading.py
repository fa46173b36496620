"""The reference's 7 procedural debug shading modes, vectorized.

Formula-equivalent port of the ``closestHit`` shader's mode switch
(HLSL/ray_tracing_shaders.hlsl:78-169) and the ``miss`` shader's constant
cyan (hlsl:72-76).  The DXR intrinsics map to hit-record fields:

* ``PrimitiveIndex()``  -> geometry.local_id[tri]  (triangle index in mesh)
* ``InstanceID()``      -> geometry.mesh_id[tri]   (instance ID = mesh index,
                           DXRTRenderer.cpp:700)
* ``WorldRayOrigin() + WorldRayDirection() * RayTCurrent()`` -> o + d*t
* ``attr.barycentrics`` -> (u, v)

Mode names follow the UI combo box (DXRTMainWindow.cpp:98-121).

Precision note: the hash family ``frac(sin(k * id) * 43758.5453)`` is
evaluated in f32 with arguments up to ~1e10 (mode 1 hashes a uint32 into
``sin``).  HLSL ``sin`` and XLA's ``sin`` on each backend disagree in ULPs at such
magnitudes, so hash-colored pixels are deterministic per backend but not
bit-equal across backends; the geometric modes (3 barycentric, 4 height,
5 distance, 6 world checker) are directly comparable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MISS_COLOR = (0.0, 1.0, 1.0)  # hlsl:75 — ignores the scene's background_color

MODE_NAMES = (
    "Triangle Random Colors",
    "Object Spatial Shading",
    "Object Triangle Shades",
    "Barycentric Heatmap",
    "World-Space Height Gradient",
    "Distance to Camera Debug",
    "Checker Pattern",
)
NUM_MODES = len(MODE_NAMES)


def _frac(x):
    return x - jnp.floor(x)


def _hash_sin(k, mul):
    return _frac(jnp.sin(k * jnp.float32(mul)) * jnp.float32(43758.5453))


def _object_base_color(obj_id_f):
    """hlsl:97-101 / 115-120 — hashed per-object base color."""
    r = _frac(jnp.sin(obj_id_f * 12.9898) * 43758.5453)
    g = _frac(jnp.sin(obj_id_f * 78.233) * 12345.6789)
    b = _frac(jnp.sin(obj_id_f * 39.425) * 34567.8901)
    return jnp.stack([r, g, b], axis=-1)


def shade_debug(mode, origins, dirs, t, u, v, local_id, mesh_id):
    """Per-ray debug color for hits; caller overlays the miss color.

    All 7 modes evaluate componentwise on (N,) arrays and the traced mode
    picks via per-component selects, so the ``sin`` hashes are shared across
    modes.  Per-mode formula float-op ORDER is preserved exactly (golden
    tests pin the pixels).

    Args:
      mode: traced i32 scalar — shading mode 0..6 (values > 6 behave like 6,
        matching the shader's trailing ``else``).
      origins, dirs: (N, 3); t, u, v: (N,); local_id, mesh_id: (N,) i32.
    Returns (N, 3) f32 colors.
    """
    tri_f = local_id.astype(jnp.float32)
    obj_f = mesh_id.astype(jnp.float32)
    wx = origins[:, 0] + dirs[:, 0] * t
    wy = origins[:, 1] + dirs[:, 1] * t
    wz = origins[:, 2] + dirs[:, 2] * t

    # mode 0 (hlsl:84-92) — also mode 2's triangle shade (same hash)
    s0r = _hash_sin(tri_f, 12.9898)
    s0g = _hash_sin(tri_f, 78.233)
    s0b = _hash_sin(tri_f, 45.164)

    # object base color (hlsl:97-101 / 115-120), shared by modes 1-2
    br = _frac(jnp.sin(obj_f * jnp.float32(12.9898)) * jnp.float32(43758.5453))
    bg = _frac(jnp.sin(obj_f * jnp.float32(78.233)) * jnp.float32(12345.6789))
    bb = _frac(jnp.sin(obj_f * jnp.float32(39.425)) * jnp.float32(34567.8901))

    # mode 1 (hlsl:93-112): hashed 2-unit world grid cell variation
    hx = (jnp.floor(wx / 2.0).astype(jnp.int32) * jnp.int32(73856093)).astype(jnp.uint32)
    hy = (jnp.floor(wy / 2.0).astype(jnp.int32) * jnp.int32(19349663)).astype(jnp.uint32)
    hz = (jnp.floor(wz / 2.0).astype(jnp.int32) * jnp.int32(83492791)).astype(jnp.uint32)
    h1 = (hx ^ hy ^ hz).astype(jnp.float32)
    var = _hash_sin(h1, 12.9898)
    inv_var = 1.0 - var

    # mode 2 (hlsl:113-124): base * (0.6 (1 - shade) + 1.0 shade)
    f2 = 0.6 * (1.0 - s0r) + 1.0 * s0r

    # mode 4 (hlsl:135-147): lerp(lo, hi, world height)
    h4 = jnp.clip((wy + 10.0) / 20.0, 0.0, 1.0)
    inv_h4 = 1.0 - h4

    # mode 5 (hlsl:148-154)
    c5 = jnp.clip(t * 0.05, 0.0, 1.0)

    # mode 6 (hlsl:155-166)
    checker = (jnp.floor(wx).astype(jnp.int32)
               ^ jnp.floor(wz).astype(jnp.int32)) & 1
    c6 = jnp.where(checker != 0, jnp.float32(0.9), jnp.float32(0.2))

    mode = jnp.clip(mode, 0, NUM_MODES - 1)

    def sel(m0, m1, m2, m3, m4):
        # modes 5/6 are shared grayscale channels, appended by the caller
        out = c6
        out = jnp.where(mode == 5, c5, out)
        out = jnp.where(mode == 4, m4, out)
        out = jnp.where(mode == 3, m3, out)
        out = jnp.where(mode == 2, m2, out)
        out = jnp.where(mode == 1, m1, out)
        out = jnp.where(mode == 0, m0, out)
        return out

    r = sel(s0r, br * 0.7 * inv_var + br * 1.3 * var, br * f2,
            1.0 - u - v, 0.1 * inv_h4 + 0.9 * h4)
    g = sel(s0g, bg * 0.7 * inv_var + bg * 1.3 * var, bg * f2,
            u, 0.2 * inv_h4 + 0.9 * h4)
    b = sel(s0b, bb * 0.7 * inv_var + bb * 1.3 * var, bb * f2,
            v, 0.6 * inv_h4 + 0.9 * h4)
    return jnp.stack([r, g, b], axis=-1)
