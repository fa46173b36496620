"""TEST ORACLE binning — a sorted near-to-far binner.

``bin_clusters`` is NOT called by any render path: the tile kernel
(pallas_intersect.py) schedules from the sort-free occupancy words of
``bin_clusters_bits``.  This module is the independently-derived oracle:
tests/test_bvh.py checks that both binners schedule the SAME
(tile, cluster) visit sets, so the production path cannot drift silently.

Reference parity: this is the explicit counterpart of the driver-internal
traversal ordering the reference never sees (DXRTRenderer.cpp:548-806
delegates it to the D3D12 driver).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.rays import T_MIN
from .clustered import ClusterSet
from .pallas_intersect import BIG, INF, _interval_inv


def bin_clusters(origins, dirs, cs: ClusterSet, t_min=T_MIN):
    """Per-tile cluster lists via interval-arithmetic frustum culling.

    Args:
      origins, dirs: (T, R, 3) tiled rays.
    Returns (ids (T, C) i32 near-to-far then misses, entry (T, C) f32 sorted
    conservative entry distances, counts (T,) i32).
    """
    o_lo = origins.min(axis=1)  # (T, 3)
    o_hi = origins.max(axis=1)
    d_lo = dirs.min(axis=1)
    d_hi = dirs.max(axis=1)

    entry = jnp.full((origins.shape[0], cs.aabb_min.shape[0]), -BIG)
    exit_ = jnp.full_like(entry, BIG)
    for ax in range(3):
        n_lo = cs.aabb_min[None, :, ax] - o_hi[:, None, ax]  # (T, C)
        n_hi = cs.aabb_max[None, :, ax] - o_lo[:, None, ax]
        i_lo, i_hi = _interval_inv(d_lo[:, None, ax], d_hi[:, None, ax])
        prods = jnp.stack(
            [n_lo * i_lo, n_lo * i_hi, n_hi * i_lo, n_hi * i_hi], axis=0
        )
        prods = jnp.clip(prods, -BIG, BIG)
        entry = jnp.maximum(entry, prods.min(axis=0))
        exit_ = jnp.minimum(exit_, prods.max(axis=0))

    overlap = (entry <= exit_) & (exit_ >= t_min) & cs.valid[None, :]
    key = jnp.where(overlap, jnp.maximum(entry, t_min), INF)
    key_sorted, ids = jax.lax.sort_key_val(
        key, jnp.broadcast_to(jnp.arange(key.shape[1], dtype=jnp.int32), key.shape),
        dimension=1,
    )
    counts = overlap.sum(axis=1).astype(jnp.int32)
    return ids, key_sorted, counts
