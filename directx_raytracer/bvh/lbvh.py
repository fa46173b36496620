"""LBVH construction — the from-scratch replacement for the D3D12 driver's
opaque acceleration-structure build (``BuildRaytracingAccelerationStructure``,
DXRTRenderer.cpp:672/791; SURVEY.md fact 3).

Fully vectorized, jittable, device-side (no x64 requirement):

1. triangle centroids -> 30-bit Morton codes over the scene AABB (10 bits
   per axis, magic-number bit spreading);
2. ``jax.lax.sort_key_val`` orders triangles along the Z-curve;
3. Karras-2012 internal-node topology: each of the T-1 internal nodes finds
   its leaf range and split with fixed-trip-count binary searches over the
   common-prefix metric delta(i, j) = clz(key_i ^ key_j) (index-XOR tiebreak
   for duplicate codes, so no 64-bit keys needed);
4. skip-pointer ("rope") threading for stackless traversal, computed by a
   top-down sweep: skip(left child) = right sibling, skip(right child) =
   skip(parent), propagated ``max_depth`` times;
5. AABB refit bottom-up by readiness sweeps.  Internal nodes start at the
   *scene* AABB, so if the tree is deeper than ``max_depth`` the unconverged
   top nodes stay conservatively large — traversal remains correct, just
   less tight (they are the always-hit nodes anyway).

Node id encoding: 0..T-2 are internal (0 = root), T-1+k is leaf k (the k-th
triangle in Morton order).  A single-triangle scene has no internal nodes
and root = leaf 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import Geometry, _register

SENTINEL = jnp.int32(-1)


@dataclass
class LBVH:
    """Threaded LBVH over Morton-sorted triangles."""

    # Unified node arrays, size 2T-1 (internal 0..T-2, leaf k at T-1+k).
    aabb_min: jax.Array  # (2T-1, 3) f32
    aabb_max: jax.Array  # (2T-1, 3) f32
    left: jax.Array  # (2T-1,) i32 — first child (internal only; SENTINEL else)
    skip: jax.Array  # (2T-1,) i32 — next node when skipping this subtree
    # Morton-sorted geometry (leaf k = sorted triangle k).
    order: jax.Array  # (T,) i32 — sorted position -> original triangle id
    v0: jax.Array  # (T, 3) f32
    e1: jax.Array  # (T, 3) f32
    e2: jax.Array  # (T, 3) f32
    n_tris: int

    @property
    def n_internal(self) -> int:
        return self.n_tris - 1

    @property
    def root(self) -> int:
        return 0 if self.n_tris > 1 else self.leaf_base

    @property
    def leaf_base(self) -> int:
        return max(self.n_tris - 1, 0)


_register(LBVH, meta=("n_tris",))


# ---------------------------------------------------------------------------
# Morton codes
# ---------------------------------------------------------------------------


def _spread_bits_10(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(centroids, lo, hi):
    """30-bit Morton codes of points quantized to a 1024^3 grid over [lo, hi]."""
    extent = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip(((centroids - lo) / extent) * 1024.0, 0.0, 1023.0).astype(jnp.int32)
    return (
        (_spread_bits_10(q[:, 0]) << 2)
        | (_spread_bits_10(q[:, 1]) << 1)
        | _spread_bits_10(q[:, 2])
    )


# ---------------------------------------------------------------------------
# Karras topology
# ---------------------------------------------------------------------------


def _delta_fn(keys, n):
    """delta(i, j): common-prefix length of keys i and j in a 62-bit virtual
    key (30-bit Morton ++ 32-bit index tiebreak); -1 outside [0, n)."""

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        jc = jnp.clip(j, 0, n - 1)
        kx = keys[i] ^ keys[jc]
        ix = i ^ jc
        d = jnp.where(kx == 0, 32 + jax.lax.clz(ix), jax.lax.clz(kx))
        return jnp.where(valid, d, -1)

    return delta


def _karras_ranges(keys):
    """Children of every internal node (vectorized Karras 2012).

    Returns (left_child, right_child) as unified node ids, each (T-1,).
    """
    n = keys.shape[0]
    n_int = n - 1
    leaf_base = n_int
    i = jnp.arange(n_int, dtype=jnp.int32)
    delta = _delta_fn(keys, n)

    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    delta_min = delta(i, i - d)

    # Range length: largest l with delta(i, i + l*d) > delta_min (delta is
    # monotone non-increasing away from i on sorted keys).
    bits = max((n - 1).bit_length(), 1)
    l = jnp.zeros_like(i)
    for p in reversed(range(bits)):
        t = l + (1 << p)
        cond = delta(i, i + t * d) > delta_min
        l = jnp.where(cond, t, l)
    j = i + l * d

    # Split: largest s < l with delta(i, i + s*d) > delta(i, j).
    delta_node = delta(i, j)
    s = jnp.zeros_like(i)
    for p in reversed(range(bits)):
        t = s + (1 << p)
        cond = (t < l) & (delta(i, i + t * d) > delta_node)
        s = jnp.where(cond, t, s)
    gamma = i + s * d + jnp.minimum(d, 0)

    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    left = jnp.where(lo == gamma, leaf_base + gamma, gamma)
    right = jnp.where(hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left, right


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_tris", "max_depth"))
def _build(v0, e1, e2, n_tris: int, max_depth: int):
    t = n_tris
    p0 = v0
    p1 = v0 + e1
    p2 = v0 + e2
    tri_min = jnp.minimum(jnp.minimum(p0, p1), p2)
    tri_max = jnp.maximum(jnp.maximum(p0, p1), p2)
    centroid = (tri_min + tri_max) * 0.5
    scene_lo = jnp.min(tri_min, axis=0)
    scene_hi = jnp.max(tri_max, axis=0)

    codes = morton_codes(centroid, scene_lo, scene_hi)
    codes, order = jax.lax.sort_key_val(codes, jnp.arange(t, dtype=jnp.int32))

    sv0, se1, se2 = v0[order], e1[order], e2[order]
    s_min, s_max = tri_min[order], tri_max[order]

    n_int = t - 1
    leaf_base = n_int
    n_nodes = 2 * t - 1

    if t == 1:
        return LBVH(
            aabb_min=s_min, aabb_max=s_max,
            left=jnp.full((1,), SENTINEL), skip=jnp.full((1,), SENTINEL),
            order=order, v0=sv0, e1=se1, e2=se2, n_tris=1,
        )

    left, right = _karras_ranges(codes)
    internal = jnp.arange(n_int, dtype=jnp.int32)

    left_arr = jnp.full((n_nodes,), SENTINEL).at[internal].set(left)

    # Skip threading: left children point at their sibling immediately; right
    # children inherit the parent's skip.  Each sweep pushes skips one level
    # deeper, so the fixed point arrives after ``tree depth`` sweeps — the
    # while_loop stops there instead of always paying max_depth full-array
    # scatter passes (measured depth ~22 at 100k tris
    # vs the old unconditional 64).  max_depth stays as a safety bound.
    skip0 = jnp.full((n_nodes,), SENTINEL).at[left].set(right)

    def skip_cond(state):
        i, s, changed = state
        return (i < max_depth) & changed

    def skip_sweep(state):
        i, s, _ = state
        s2 = s.at[right].set(s[internal])
        return i + 1, s2, jnp.any(s2[right] != s[right])

    _, skip, _ = jax.lax.while_loop(
        skip_cond, skip_sweep, (jnp.int32(0), skip0, jnp.bool_(True))
    )

    # AABB refit: leaves exact; internals start at the scene box
    # (conservative), tighten bottom-up until the sweep is a no-op (same
    # actual-depth trip count as the skip threading above).
    amin0 = jnp.broadcast_to(scene_lo, (n_nodes, 3)).at[leaf_base:].set(s_min)
    amax0 = jnp.broadcast_to(scene_hi, (n_nodes, 3)).at[leaf_base:].set(s_max)

    def refit_cond(state):
        i, _, _, changed = state
        return (i < max_depth) & changed

    def refit(state):
        i, mn, mx, _ = state
        new_mn = jnp.minimum(mn[left], mn[right])
        new_mx = jnp.maximum(mx[left], mx[right])
        changed = jnp.any(new_mn != mn[internal]) | jnp.any(
            new_mx != mx[internal])
        return i + 1, mn.at[internal].set(new_mn), mx.at[internal].set(new_mx), changed

    _, amin, amax, _ = jax.lax.while_loop(
        refit_cond, refit, (jnp.int32(0), amin0, amax0, jnp.bool_(True))
    )

    return LBVH(
        aabb_min=amin, aabb_max=amax, left=left_arr, skip=skip,
        order=order, v0=sv0, e1=se1, e2=se2, n_tris=t,
    )


def build_lbvh(geometry: Geometry, max_depth: int = 64) -> LBVH:
    """Build the LBVH over a scene's true (unpadded) triangles.

    ``max_depth`` bounds the skip/refit propagation sweeps; trees deeper than
    this stay correct but conservatively tight near the root (see module doc).
    """
    t = geometry.n_tris
    if t == 0:
        raise ValueError("cannot build a BVH over an empty scene")
    return _build(
        geometry.v0[:t], geometry.e1[:t], geometry.e2[:t], n_tris=t,
        max_depth=max_depth,
    )
