"""Clustered (binned-wavefront) intersector — the plain XLA path.

Pointer chasing is replaced with dense vector math:

* build: triangles sorted along the Morton curve (same ordering as the
  LBVH) are grouped into fixed-size clusters of K contiguous triangles;
  each cluster gets an AABB and a (K, 3, 4) Woop-transform block.  The
  cluster level is exactly an LBVH cut at fixed leaf size, laid out SoA.
* query: rays are processed in blocks of B (image-coherent, row-major).
  Phase 1 slab-tests all B rays against all C cluster AABBs — elementwise,
  no indirection.  Phase 2 compacts the clusters any ray in the block hit,
  sorts them near-to-far by block-min entry t, and walks them with a
  ``lax.while_loop`` whose trip count is the *actual* overlap count; each
  step dynamically slices one contiguous Woop block (no gather — clusters
  are contiguous by construction) and folds a dense B x K intersection
  into the running closest hit.  The loop exits early once the next
  cluster's entry t exceeds every ray's current best.

This is the CPU render path and the XLA baseline the GPU tile kernel
(pallas_intersect.py) is timed against.  Coherent primary blocks touch a
handful of clusters; the worst case degrades to brute force over the block.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import Geometry, _register
from ..ops.intersect import Hit, _closest_in_block, intersect_block
from ..ops.rays import T_MAX, T_MIN
from .lbvh import morton_codes

INF = jnp.float32(jnp.inf)


@dataclass
class ClusterSet:
    """Morton-ordered triangle clusters (SoA, padded with miss sentinels)."""

    woop: jax.Array  # (C, K, 3, 4) f32 — per-cluster Woop blocks
    aabb_min: jax.Array  # (C, 3) f32
    aabb_max: jax.Array  # (C, 3) f32
    valid: jax.Array  # (C,) bool — False for all-sentinel clusters (treelet
    #                   leaf padding); binners cull them outright
    order: jax.Array  # (C*K,) i32 — sorted slot -> original tri id (-1 pad)
    v0: jax.Array  # (C*K, 3) f32 — sorted geometry (exact MT re-evaluation)
    e1: jax.Array
    e2: jax.Array
    n_tris: int
    k: int
    identity_order: bool  # geometry already Morton-sorted: slot == tri id


_register(ClusterSet, meta=("n_tris", "k", "identity_order"))


@partial(jax.jit, static_argnames=("n_tris", "k", "presorted"))
def _build(v0, e1, e2, woop, n_tris: int, k: int, presorted: bool):
    t = n_tris
    p0, p1, p2 = v0, v0 + e1, v0 + e2
    tri_min = jnp.minimum(jnp.minimum(p0, p1), p2)
    tri_max = jnp.maximum(jnp.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    lo = jnp.min(tri_min, axis=0)
    hi = jnp.max(tri_max, axis=0)

    if presorted:
        order = jnp.arange(t, dtype=jnp.int32)
    else:
        codes = morton_codes(centroid, lo, hi)
        _, order = jax.lax.sort_key_val(codes, jnp.arange(t, dtype=jnp.int32))

    c = -(-t // k)
    pad = c * k - t
    sent_woop = jnp.zeros((3, 4), jnp.float32).at[:, 3].set(-1e30)

    def padded(x, fill):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
        ) if pad else x

    s_woop = padded(woop[order], 0.0).at[t:].set(sent_woop) if pad else woop[order]
    # Sentinel (degenerate) rows must not bloat cluster AABBs, and clusters
    # made ONLY of sentinels must not bin at all.
    real = (jnp.abs(e1).max(axis=1) > 0) | (jnp.abs(e2).max(axis=1) > 0)
    real_s = padded(real[order], False)
    s_min = jnp.where(real_s[:, None], padded(tri_min[order], jnp.inf),
                      jnp.inf)
    s_max = jnp.where(real_s[:, None], padded(tri_max[order], -jnp.inf),
                      -jnp.inf)
    return ClusterSet(
        woop=s_woop.reshape(c, k, 3, 4),
        aabb_min=s_min.reshape(c, k, 3).min(axis=1),
        aabb_max=s_max.reshape(c, k, 3).max(axis=1),
        valid=real_s.reshape(c, k).any(axis=1),
        order=padded(order, -1),
        v0=padded(v0[order], 0.0),
        e1=padded(e1[order], 0.0),
        e2=padded(e2[order], 0.0),
        n_tris=t,
        k=k,
        identity_order=presorted,
    )


def build_clusters(geometry: Geometry, k: int = 128) -> ClusterSet:
    t = geometry.n_tris
    if t == 0:
        raise ValueError("cannot build clusters over an empty scene")
    presorted = bool(getattr(geometry, "morton_sorted", False))
    return _build(
        geometry.v0[:t], geometry.e1[:t], geometry.e2[:t], geometry.woop[:t],
        n_tris=t, k=k, presorted=presorted,
    )


def _safe_inv(d):
    tiny = 1e-12
    return 1.0 / jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)


def _cluster_slabs(o, d, cs: ClusterSet, t_min):
    """Entry/exit t of every ray against every cluster AABB.

    Returns (tn, tf): each (B, C); a ray overlaps cluster c iff
    tn <= tf and tf >= t_min.  Computed per-axis to avoid a (B, C, 3)
    intermediate.
    """
    inv = _safe_inv(d)
    tn = jnp.full((o.shape[0], cs.aabb_min.shape[0]), -INF)
    tf = jnp.full((o.shape[0], cs.aabb_min.shape[0]), INF)
    for ax in range(3):
        a = (cs.aabb_min[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        b = (cs.aabb_max[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        tn = jnp.maximum(tn, jnp.minimum(a, b))
        tf = jnp.minimum(tf, jnp.maximum(a, b))
    return tn, tf


def _closest_block(o, d, cs: ClusterSet, t_min, t_max):
    """Closest hit for one coherent ray block (B rays)."""
    b = o.shape[0]
    tn, tf = _cluster_slabs(o, d, cs, t_min)
    overlap = (tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])  # (B, C)
    needed = overlap.any(axis=0)  # (C,)
    # Near-to-far over the block: key = min entry t over overlapping rays.
    entry = jnp.where(overlap, jnp.maximum(tn, t_min), INF)
    key = jnp.where(needed, entry.min(axis=0), INF)
    key_sorted, cluster_ids = jax.lax.sort_key_val(
        key, jnp.arange(key.shape[0], dtype=jnp.int32)
    )
    n_needed = jnp.sum(needed)

    init = (
        jnp.int32(0),
        jnp.minimum(jnp.full((b,), INF), t_max),
        jnp.full((b,), -1, jnp.int32),
        jnp.zeros((b,), jnp.float32),
        jnp.zeros((b,), jnp.float32),
    )

    def cond(s):
        i, best_t, *_ = s
        return (i < n_needed) & (key_sorted[i] <= jnp.max(best_t))

    def body(s):
        i, best_t, best_tri, best_u, best_v = s
        c = cluster_ids[i]
        woop_blk = jax.lax.dynamic_index_in_dim(cs.woop, c, axis=0, keepdims=False)
        carry = _closest_in_block(
            o, d, woop_blk, c * cs.k, (best_t, best_tri, best_u, best_v),
            t_min, T_MAX,
        )
        return (i + 1,) + carry

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    hit = best_tri >= 0
    return (
        jnp.where(hit, best_t, INF),
        best_tri,
        best_u,
        best_v,
    )


def _occluded_block(o, d, cs: ClusterSet, t_min, t_max):
    """Any-hit for one ray block: True where something lies in (t_min, t_max)."""
    b = o.shape[0]
    tn, tf = _cluster_slabs(o, d, cs, t_min)
    overlap = (tn <= tf) & (tf >= t_min) & (tn <= t_max[:, None])
    needed = overlap.any(axis=0)
    key = jnp.where(needed, jnp.where(overlap, tn, INF).min(axis=0), INF)
    _, cluster_ids = jax.lax.sort_key_val(
        key, jnp.arange(key.shape[0], dtype=jnp.int32)
    )
    n_needed = jnp.sum(needed)

    def cond(s):
        i, blocked = s
        return (i < n_needed) & ~jnp.all(blocked | (t_max <= t_min))

    def body(s):
        i, blocked = s
        c = cluster_ids[i]
        woop_blk = jax.lax.dynamic_index_in_dim(cs.woop, c, axis=0, keepdims=False)
        tt, _, _, _ = intersect_block(o, d, woop_blk, t_min, T_MAX)
        blocked = blocked | jnp.any(tt < t_max[:, None], axis=1)
        return i + 1, blocked

    _, blocked = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((b,), bool))
    )
    return blocked


def _block_apply(fn, origins, dirs, t_max, block, t_min, cs):
    n = origins.shape[0]
    blk = min(block, n)
    pad = (-n) % blk
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), jnp.float32)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), jnp.float32)])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), t_min, jnp.float32)])
    out = jax.lax.map(
        lambda args: fn(args[0], args[1], cs, t_min, args[2]),
        (origins.reshape(-1, blk, 3), dirs.reshape(-1, blk, 3), t_max.reshape(-1, blk)),
    )
    return out, n


@partial(jax.jit, static_argnames=("block",))
def intersect_clustered(origins, dirs, cs: ClusterSet, t_max=None, t_min=T_MIN,
                        block: int = 8192) -> Hit:
    """Closest hit via cluster binning; ``tri`` in ORIGINAL triangle ids."""
    n = origins.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), T_MAX, jnp.float32)
    (best_t, best_tri, best_u, best_v), n = _block_apply(
        _closest_block, origins, dirs, t_max, block, t_min, cs
    )
    flat = lambda x: x.reshape(-1)[:n]
    k = flat(best_tri)
    if cs.identity_order:
        tri = k  # slot == triangle id; avoids a narrow (N,) remap gather
    else:
        tri = jnp.where(k >= 0, cs.order[jnp.maximum(k, 0)], -1)
    return Hit(t=flat(best_t), tri=tri, u=flat(best_u), v=flat(best_v))


@partial(jax.jit, static_argnames=("block",))
def occluded_clustered(origins, dirs, cs: ClusterSet, t_max, t_min=T_MIN,
                       block: int = 8192):
    out, n = _block_apply(_occluded_block, origins, dirs, t_max, block, t_min, cs)
    return out.reshape(-1)[:n]
