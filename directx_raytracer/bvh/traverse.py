"""Stackless LBVH traversal — a software replacement for the hardware
``TraceRay`` intrinsic (HLSL/ray_tracing_shaders.hlsl:57-66).

Skip-pointer ("rope") walk: per-ray state is just (current node id, best
hit) — no stack arrays in HBM.  Internal node hit -> descend to first child;
miss (or leaf, after its Möller-Trumbore test) -> follow the skip pointer.
The walk is vmapped over a ray block (lockstep with masking: every lane
steps until the *block's* slowest ray finishes) and ``lax.map``-ped over
blocks to bound that divergence domain.  It is the correctness oracle, not
a render path.

The box test prunes against the ray's *current best t*, so near-to-far isn't
required for correctness; Morton order gives approximate front-to-back
locality anyway.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.intersect import Hit
from ..ops.rays import T_MAX, T_MIN
from .lbvh import LBVH, SENTINEL

INF = jnp.float32(jnp.inf)


def _safe_inv(d):
    tiny = 1e-12
    return 1.0 / jnp.where(jnp.abs(d) < tiny, jnp.where(d < 0, -tiny, tiny), d)


def _traverse_one(o, d, t_max_ray, bvh: LBVH, t_min, any_hit: bool):
    """Walk the threaded tree for a single ray (to be vmapped)."""
    leaf_base = bvh.leaf_base
    inv_d = _safe_inv(d)

    def cond(carry):
        cur, best_t, *_ = carry
        live = cur != SENTINEL
        if any_hit:
            live = live & (best_t == INF)
        return live

    def body(carry):
        cur, best_t, best_k, best_u, best_v = carry
        node_min = bvh.aabb_min[cur]
        node_max = bvh.aabb_max[cur]
        t0 = (node_min - o) * inv_d
        t1 = (node_max - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1))
        tf = jnp.min(jnp.maximum(t0, t1))
        limit = jnp.minimum(best_t, t_max_ray)
        box_hit = (tn <= tf) & (tf >= t_min) & (tn <= limit)

        is_leaf = cur >= leaf_base
        k = jnp.maximum(cur - leaf_base, 0)
        # Möller-Trumbore on the leaf triangle.
        e1 = bvh.e1[k]
        e2 = bvh.e2[k]
        p = jnp.cross(d, e2)
        det = jnp.dot(e1, p)
        inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
        s = o - bvh.v0[k]
        u = jnp.dot(s, p) * inv_det
        q = jnp.cross(s, e1)
        v = jnp.dot(d, q) * inv_det
        tt = jnp.dot(e2, q) * inv_det
        tri_hit = (
            is_leaf & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
            & (tt > t_min) & (tt < limit)
        )

        best_t = jnp.where(tri_hit, tt, best_t)
        best_k = jnp.where(tri_hit, k, best_k)
        best_u = jnp.where(tri_hit, u, best_u)
        best_v = jnp.where(tri_hit, v, best_v)

        descend = (~is_leaf) & box_hit
        cur = jnp.where(descend, bvh.left[cur], bvh.skip[cur])
        return cur, best_t, best_k, best_u, best_v

    root = jnp.int32(bvh.root)
    init = (root, INF, jnp.int32(-1), jnp.float32(0), jnp.float32(0))
    _, best_t, best_k, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return best_t, best_k, best_u, best_v


@partial(jax.jit, static_argnames=("block",))
def traverse_closest(origins, dirs, bvh: LBVH, t_max=None, t_min=T_MIN,
                     block: int = 65536) -> Hit:
    """Closest hit of each ray via the threaded LBVH.

    Returns a Hit whose ``tri`` holds ORIGINAL triangle ids (mapped back
    through the Morton sort), matching ``intersect_bruteforce``.
    """
    n = origins.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), T_MAX, jnp.float32)
    pad = (-n) % min(block, n) if n else 0
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), jnp.float32)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), jnp.float32)])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), t_min, jnp.float32)])
    m = origins.shape[0]
    blk = min(block, m)

    def per_block(args):
        o, d, tm = args
        return jax.vmap(
            lambda oo, dd, tt: _traverse_one(oo, dd, tt, bvh, t_min, any_hit=False)
        )(o, d, tm)

    o_b = origins.reshape(-1, blk, 3)
    d_b = dirs.reshape(-1, blk, 3)
    t_b = t_max.reshape(-1, blk)
    best_t, best_k, best_u, best_v = jax.lax.map(per_block, (o_b, d_b, t_b))
    flat = lambda x: x.reshape(-1)[:n]
    best_k = flat(best_k)
    tri = jnp.where(best_k >= 0, bvh.order[jnp.maximum(best_k, 0)], -1)
    return Hit(t=flat(best_t), tri=tri, u=flat(best_u), v=flat(best_v))


@partial(jax.jit, static_argnames=("block",))
def traverse_occluded(origins, dirs, bvh: LBVH, t_max, t_min=T_MIN,
                      block: int = 65536):
    """Any-hit shadow query: True where something lies in (t_min, t_max[i])."""
    n = origins.shape[0]
    pad = (-n) % min(block, n) if n else 0
    if pad:
        origins = jnp.concatenate([origins, jnp.zeros((pad, 3), jnp.float32)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), jnp.float32)])
        t_max = jnp.concatenate([t_max, jnp.full((pad,), t_min, jnp.float32)])
    m = origins.shape[0]
    blk = min(block, m)

    def per_block(args):
        o, d, tm = args
        best_t, *_ = jax.vmap(
            lambda oo, dd, tt: _traverse_one(oo, dd, tt, bvh, t_min, any_hit=True)
        )(o, d, tm)
        return best_t < INF

    o_b = origins.reshape(-1, blk, 3)
    d_b = dirs.reshape(-1, blk, 3)
    t_b = t_max.reshape(-1, blk)
    out = jax.lax.map(per_block, (o_b, d_b, t_b))
    return out.reshape(-1)[:n]
