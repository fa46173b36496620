"""Batched ray-triangle intersection.

The reference delegates intersection to the D3D12 driver's hardware BVH
(``TraceRay``, HLSL/ray_tracing_shaders.hlsl:57-66; acceleration structures
built at DXRTRenderer.cpp:548-806).  Here each triangle carries a
precomputed Woop unit-triangle transform (models/scene.py), so testing a
block of R rays against a block of T triangles is two dense f32 matmuls —

    o' = [O | 1] @ W^T      (R, 4) @ (4, 3T)
    d' =  D      @ Wl^T     (R, 3) @ (3, 3T)

followed by elementwise work: t = -o'_z / d'_z, u = o'_x + t d'_x,
v = o'_y + t d'_y, and a masked running min over triangle blocks.  Barycentric
convention matches DXR's BuiltInTriangleIntersectionAttributes: (u, v) weight
vertices 1 and 2; the hit point is v0 + u e1 + v e2.

`intersect_bruteforce` is the reference-correctness path (and is genuinely
fast for small scenes); the XLA clustered walker (bvh/clustered.py) reuses
the same dense block primitive inside traversal.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .rays import T_MAX, T_MIN

INF = jnp.float32(jnp.inf)


@dataclass
class Hit:
    """SoA hit record for a batch of rays. tri == -1 means miss."""

    t: jax.Array  # (N,) f32 — hit distance (inf on miss)
    tri: jax.Array  # (N,) i32 — global triangle index, -1 on miss
    u: jax.Array  # (N,) f32 — barycentric weight of vertex 1
    v: jax.Array  # (N,) f32 — barycentric weight of vertex 2

    @property
    def mask(self) -> jax.Array:
        return self.tri >= 0


jax.tree_util.register_dataclass(Hit, data_fields=["t", "tri", "u", "v"], meta_fields=[])


def woop_mats(woop: jax.Array):
    """Split (T, 3, 4) Woop transforms into matmul operands.

    Returns (w4, w3): w4 is (4, 3T) acting on homogeneous origins, w3 is
    (3, 3T) acting on directions.  Column layout is triangle-major
    (tri t's rows occupy columns 3t..3t+2).
    """
    t = woop.shape[0]
    w = jnp.swapaxes(woop.reshape(t * 3, 4), 0, 1)  # (4, 3T)
    return w, w[:3]


# Matmul precision for the intersection search: full f32.  A float32 matmul
# may otherwise run in TF32 (about 10 mantissa bits), which flips hit/miss
# decisions on sliver edges; the brute-force reference must not.
SEARCH_PRECISION = jax.lax.Precision.HIGHEST


def intersect_block(origins, dirs, woop, t_min=T_MIN, t_max=T_MAX,
                    precision=SEARCH_PRECISION):
    """Dense R x T intersection via the Woop matmul formulation.

    Args:
      origins, dirs: (R, 3) f32.
      woop: (T, 3, 4) f32.
    Returns:
      (t, u, v, valid): each (R, T); t is inf where invalid.
    """
    r = origins.shape[0]
    t = woop.shape[0]
    w4, w3 = woop_mats(woop)
    o4 = jnp.concatenate([origins, jnp.ones((r, 1), origins.dtype)], axis=1)
    op = jnp.dot(o4, w4, preferred_element_type=jnp.float32,
                 precision=precision).reshape(r, t, 3)
    dp = jnp.dot(dirs, w3, preferred_element_type=jnp.float32,
                 precision=precision).reshape(r, t, 3)

    tt = -op[..., 2] / dp[..., 2]
    u = op[..., 0] + tt * dp[..., 0]
    v = op[..., 1] + tt * dp[..., 1]
    valid = (tt > t_min) & (tt < t_max) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return jnp.where(valid, tt, INF), u, v, valid


def _closest_in_block(origins, dirs, woop, tri_base, carry, t_min, t_max):
    """Fold one triangle block into the running closest-hit carry."""
    best_t, best_tri, best_u, best_v = carry
    tt, u, v, _ = intersect_block(origins, dirs, woop, t_min, t_max)
    blk_idx = jnp.argmin(tt, axis=1)  # (R,)
    blk_t = jnp.take_along_axis(tt, blk_idx[:, None], axis=1)[:, 0]
    blk_u = jnp.take_along_axis(u, blk_idx[:, None], axis=1)[:, 0]
    blk_v = jnp.take_along_axis(v, blk_idx[:, None], axis=1)[:, 0]
    closer = blk_t < best_t
    return (
        jnp.where(closer, blk_t, best_t),
        jnp.where(closer, tri_base + blk_idx.astype(jnp.int32), best_tri),
        jnp.where(closer, blk_u, best_u),
        jnp.where(closer, blk_v, best_v),
    )


def _pad_woop(woop, tri_block: int):
    """Pad the triangle axis to a multiple of ``tri_block`` with guaranteed-
    miss sentinels (zero linear part, -1e30 translation => t folds to inf)."""
    rem = (-woop.shape[0]) % tri_block
    if not rem:
        return woop
    bad = jnp.zeros((rem, 3, 4), woop.dtype).at[:, :, 3].set(-1e30)
    return jnp.concatenate([woop, bad], axis=0)


def intersect_bruteforce(
    origins,
    dirs,
    woop,
    t_min=T_MIN,
    t_max=T_MAX,
    ray_block: int = 16384,
    tri_block: int = 512,
) -> Hit:
    """Closest hit of every ray against every triangle.

    Rays are processed in blocks of ``ray_block`` (jax.lax.map) and triangles
    in blocks of ``tri_block`` (jax.lax.scan with a running min), bounding
    the transient (R_blk, 3*T_blk) matmul outputs.
    """
    n = origins.shape[0]
    tri_block = min(tri_block, woop.shape[0])
    woop = _pad_woop(woop, tri_block)
    n_tri_blocks = woop.shape[0] // tri_block
    woop_blocks = woop.reshape(n_tri_blocks, tri_block, 3, 4)

    ray_block = min(ray_block, n)
    pad = (-n) % ray_block
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), origins.dtype)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), dirs.dtype)])
    n_ray_blocks = (n + pad) // ray_block
    o_blocks = origins.reshape(n_ray_blocks, ray_block, 3)
    d_blocks = dirs.reshape(n_ray_blocks, ray_block, 3)

    def per_ray_block(args):
        o, d = args
        init = (
            jnp.full((ray_block,), INF),
            jnp.full((ray_block,), -1, jnp.int32),
            jnp.zeros((ray_block,), jnp.float32),
            jnp.zeros((ray_block,), jnp.float32),
        )

        def step(carry, blk):
            w, base = blk
            return _closest_in_block(o, d, w, base, carry, t_min, t_max), None

        bases = jnp.arange(n_tri_blocks, dtype=jnp.int32) * tri_block
        carry, _ = jax.lax.scan(step, init, (woop_blocks, bases))
        return carry

    bt, btri, bu, bv = jax.lax.map(per_ray_block, (o_blocks, d_blocks))
    flat = lambda x: x.reshape(-1)[:n]
    return Hit(t=flat(bt), tri=flat(btri), u=flat(bu), v=flat(bv))


def hit_record(origins, dirs, packed, hit: Hit):
    """THE per-bounce gather: one fused (N, 40) row -> exact (t, u, v),
    per-triangle ids, and the raw record for attribute slicing.

    Geometry + vertex attributes + material data all ride one row
    (models/scene.py Geometry.packed), so a bounce pays one gather pass
    instead of three.  Re-evaluates Möller-Trumbore exactly for each ray's winning
    triangle (same refine trick as refine_hit).

    Returns (refined Hit, local_id, mesh_id, mat_id, rec) — ids are 0 for
    misses; ``rec`` feeds ops.shading.hit_attributes without re-gathering.
    """
    rec = packed[jnp.maximum(hit.tri, 0)]  # (N, 40) — THE gather
    local_id = jax.lax.bitcast_convert_type(rec[:, 9], jnp.int32)
    mesh_id = jax.lax.bitcast_convert_type(rec[:, 10], jnp.int32)
    mat_id = jax.lax.bitcast_convert_type(rec[:, 11], jnp.int32)

    # Möller-Trumbore componentwise on (N,) columns rather than (N, 3)
    # cross/dot math with a minor dimension of 3.
    v0x, v0y, v0z = rec[:, 0], rec[:, 1], rec[:, 2]
    e1x, e1y, e1z = rec[:, 3], rec[:, 4], rec[:, 5]
    e2x, e2y, e2z = rec[:, 6], rec[:, 7], rec[:, 8]
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = hit.mask
    refined = Hit(
        t=jnp.where(ok, t, hit.t),
        tri=hit.tri,
        u=jnp.where(ok, u, hit.u),
        v=jnp.where(ok, v, hit.v),
    )
    zero = jnp.int32(0)
    keep = lambda x: jnp.where(ok, x, zero)
    return (refined, keep(local_id), keep(mesh_id),
            keep(jnp.maximum(mat_id, 0)), rec)


def refine_hit(origins, dirs, v0, e1, e2, hit: Hit) -> Hit:
    """Re-evaluate (t, u, v) exactly for each ray's winning triangle.

    The Woop search loses ~1e-2 of barycentric
    precision on sliver triangles far from the ray origin (cancellation in
    ``o' + t d'``).  One batched Möller-Trumbore evaluation against just the
    winning triangle (O(rays), not O(rays x tris)) restores f32-accurate
    t/u/v for shading; the hit/miss decision of the search is kept.
    """
    tri = jnp.maximum(hit.tri, 0)
    a = v0[tri]
    b = e1[tri]
    c = e2[tri]
    p = jnp.cross(dirs, c)
    det = jnp.sum(b * p, axis=-1)
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    s = origins - a
    u = jnp.sum(s * p, axis=-1) * inv_det
    q = jnp.cross(s, b)
    v = jnp.sum(dirs * q, axis=-1) * inv_det
    t = jnp.sum(c * q, axis=-1) * inv_det
    ok = hit.mask
    return Hit(
        t=jnp.where(ok, t, hit.t),
        tri=hit.tri,
        u=jnp.where(ok, u, hit.u),
        v=jnp.where(ok, v, hit.v),
    )


def occluded_bruteforce(
    origins,
    dirs,
    woop,
    t_max,
    t_min=T_MIN,
    ray_block: int = 16384,
    tri_block: int = 512,
):
    """Any-hit test: True where some triangle lies in (t_min, t_max[i]).

    Used for shadow rays (the capability surface the reference parses lights
    for but never traces — SURVEY.md fact 1: recursion depth 1, no TraceRay
    in closestHit).  Same blocked Woop-matmul formulation as
    ``intersect_bruteforce`` but folds a boolean OR instead of a running min
    (no early exit: XLA control flow would serialize the ray batch).

    Args:
      origins, dirs: (N, 3) f32; dirs need not be normalized if t_max is in
        the same parameterization.
      t_max: (N,) f32 per-ray upper bound (e.g. distance to the light).
    Returns (N,) bool.
    """
    n = origins.shape[0]
    tri_block = min(tri_block, woop.shape[0])
    woop = _pad_woop(woop, tri_block)
    n_tri_blocks = woop.shape[0] // tri_block
    woop_blocks = woop.reshape(n_tri_blocks, tri_block, 3, 4)

    ray_block = min(ray_block, n)
    pad = (-n) % ray_block
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), origins.dtype)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), dirs.dtype)])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), t_min, t_max.dtype)])
    n_ray_blocks = (n + pad) // ray_block
    o_blocks = origins.reshape(n_ray_blocks, ray_block, 3)
    d_blocks = dirs.reshape(n_ray_blocks, ray_block, 3)
    tm_blocks = t_max.reshape(n_ray_blocks, ray_block)

    def per_ray_block(args):
        o, d, tm = args

        def step(blocked, w):
            tt, _, _, _ = intersect_block(o, d, w, t_min, T_MAX)
            return blocked | jnp.any(tt < tm[:, None], axis=1), None

        blocked, _ = jax.lax.scan(step, jnp.zeros((ray_block,), bool), woop_blocks)
        return blocked

    out = jax.lax.map(per_ray_block, (o_blocks, d_blocks, tm_blocks))
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# Classic Möller-Trumbore — scalar reference for cross-checking the Woop path
# ---------------------------------------------------------------------------


def moller_trumbore(origin, direction, v0, e1, e2, t_min=T_MIN, t_max=T_MAX):
    """Single ray vs single triangle; returns (t, u, v, hit).  Used only in
    tests as an independent oracle for the matmul formulation."""
    p = jnp.cross(direction, e2)
    det = jnp.dot(e1, p)
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    s = origin - v0
    u = jnp.dot(s, p) * inv_det
    q = jnp.cross(s, e1)
    v = jnp.dot(direction, q) * inv_det
    t = jnp.dot(e2, q) * inv_det
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min) & (t < t_max)
    return t, u, v, hit
