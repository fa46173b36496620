"""Binned-tile intersection kernel — the production ``TraceRay`` on the GPU.

The XLA clustered walker (clustered.py) writes (B, 3K) Woop products to
device memory at every cluster visit.  This path keeps each visit in
registers:

* **binning (XLA):** each ``TILE_R``-ray tile is reduced to an origin /
  direction interval box; interval-arithmetic slab tests against all
  cluster AABBs give per-tile occupancy bits (packed into 32-bit words)
  and conservative entry distances.  The test is elementwise, so XLA fuses
  it into one loop.
* **cluster lists (XLA):** ``rank_table_bits`` turns each tile's occupancy
  words into a dense (T, RANK_CAP) table of cluster ids.
* **kernel (Pallas, Triton route):** one program per ray tile, rays on the
  block's vector axis.  The program loads its own cluster ids from the
  table and walks them in a ``while_loop``; the running closest hit
  (best t, best slot) stays in registers.  A cluster whose conservative
  entry lies beyond every ray's current best is skipped.  Each visit tests
  ``TRI_BLOCK`` triangles x ``TILE_R`` rays per inner step with plain f32
  FMAs on the planar Woop operand (:func:`planar_woop`).  In tiles binning
  more than ``RANK_CAP`` clusters, the ranks past the table are resolved
  straight from the occupancy words.

Slot -> original triangle id via the Morton ``order``.  Occlusion runs the
same kernel seeded with the shadow distance: a ray is blocked once it holds
a hit, and blocked rays no longer keep clusters alive.

Reference parity: this replaces the driver-built BLAS/TLAS + hardware
traversal the reference leans on (DXRTRenderer.cpp:548-806,
HLSL/ray_tracing_shaders.hlsl:57-66).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..ops.intersect import Hit
from ..ops.rays import T_MAX, T_MIN
from .clustered import ClusterSet

INF = float("inf")
BIG = 1e30
# XLA-side dots (the rank-table one-hot selections) carry exact integer
# values < 2^24 in f32 and must not be rounded to a shorter mantissa.
_DOT_PRECISION = jax.lax.Precision.HIGHEST
# Rays per tile: one 8x32 pixel tile of the primary schedule
# (ops.rays.pick_tile).  A power of two, as Triton blocks must be.  Other
# sizes not measured on the card.
TILE_R = 256
# Triangles per inner step: the (TRI_BLOCK, TILE_R) working block is sized
# for registers.  16 x 256 with 8 warps was the fastest of five shapes on
# the H100 (PERF.md), swept with the steps unrolled; not re-swept since.
TRI_BLOCK = 16
NUM_WARPS = 8
# Rank-table width: clusters per tile scheduled by the dense table; ranks
# past it are resolved from the occupancy words.  Not measured on the card.
RANK_CAP = 128


# ---------------------------------------------------------------------------
# Planar Woop operand
# ---------------------------------------------------------------------------


def planar_woop(cs: ClusterSet) -> jax.Array:
    """(C, 12, K) f32: row ``3 * 4``-major Woop coefficients of every
    cluster, triangles on the minor axis.

    Row ``4 * a + j`` holds ``woop[:, :, a, j]``: rows 0-3 map a homogeneous
    origin to the u coordinate, 4-7 to v, 8-11 to z (rows ``4a..4a+2`` alone
    map a direction).  A kernel step loads each row as one contiguous
    (TRI_BLOCK,) vector."""
    c, k = cs.woop.shape[0], cs.k
    return jnp.swapaxes(cs.woop.reshape(c, k, 12), 1, 2)


# ---------------------------------------------------------------------------
# Conservative frustum binning (XLA)
# ---------------------------------------------------------------------------


def _interval_inv(d_lo, d_hi):
    """Interval reciprocal; spans of zero go conservatively infinite."""
    same_sign = (d_lo > 0) | (d_hi < 0)
    i_lo = jnp.where(same_sign, 1.0 / d_hi, -BIG)
    i_hi = jnp.where(same_sign, 1.0 / d_lo, BIG)
    return i_lo, i_hi


def bin_clusters_bits(origins, dirs, cs: ClusterSet, t_min=T_MIN, t_cap=None):
    """Per-tile overlap as 32-bit occupancy WORDS.

    ``origins``/``dirs``: (T, R, 3) tiled rays.  ``t_cap``: optional (T,)
    per-tile upper bound on ray t — a cluster whose conservative entry
    exceeds it is dropped (no ray of the tile can accept a hit there).

    Returns (words (T, W) i32, cum (T, W) i32 running popcounts,
    entry (T, C) f32 conservative entries, counts (T,)).
    """
    o_lo = origins.min(axis=1)
    o_hi = origins.max(axis=1)
    d_lo = dirs.min(axis=1)
    d_hi = dirs.max(axis=1)
    tiles = origins.shape[0]
    c = cs.aabb_min.shape[0]

    entry = jnp.full((tiles, c), -BIG)
    exit_ = jnp.full_like(entry, BIG)
    for ax in range(3):
        n_lo = cs.aabb_min[None, :, ax] - o_hi[:, None, ax]
        n_hi = cs.aabb_max[None, :, ax] - o_lo[:, None, ax]
        i_lo, i_hi = _interval_inv(d_lo[:, None, ax], d_hi[:, None, ax])
        prods = jnp.stack(
            [n_lo * i_lo, n_lo * i_hi, n_hi * i_lo, n_hi * i_hi], axis=0)
        prods = jnp.clip(prods, -BIG, BIG)
        entry = jnp.maximum(entry, prods.min(axis=0))
        exit_ = jnp.minimum(exit_, prods.max(axis=0))

    overlap = (entry <= exit_) & (exit_ >= t_min) & cs.valid[None, :]
    entry = jnp.maximum(entry, t_min)
    if t_cap is not None:
        overlap = overlap & (entry <= t_cap[:, None])
    pad = (-c) % 32
    if pad:
        overlap = jnp.concatenate(
            [overlap, jnp.zeros((tiles, pad), bool)], axis=1)

    w = overlap.shape[1] // 32
    bits = overlap.reshape(tiles, w, 32).astype(jnp.int32)
    words = (bits << jnp.arange(32, dtype=jnp.int32)[None, None, :]).sum(-1)
    cnt_w = jax.lax.population_count(words)
    cum = jnp.cumsum(cnt_w, axis=1)
    counts = cnt_w.sum(axis=1)
    return words, cum, entry, counts


def _nth_set_bit(word, n):
    """Index of the n-th (0-based) set bit of each 32-bit word (popcount
    binary descent; works on arrays and, inside the kernel, on scalars)."""
    bit = jnp.zeros_like(n)
    rem = n
    cur = word
    for width in (16, 8, 4, 2, 1):
        low = cur & jnp.int32((1 << width) - 1)
        c_low = jax.lax.population_count(low)
        go_high = rem >= c_low
        rem = jnp.where(go_high, rem - c_low, rem)
        bit = jnp.where(go_high, bit + width, bit)
        cur = jnp.where(go_high, cur >> width, low)
    return bit


def rank_table_bits(words, cum, cap: int):
    """(T, cap) table: entry j = cluster id of tile t's j-th set bit.

    Built densely, with no gathers: the word holding rank j is
    ``p = sum_w [cum[t, w] <= j]`` (one (T, cap, W) elementwise compare),
    the word value and its preceding popcount come from one-hot sums over
    the same axis, and the in-word bit from the popcount descent.

    Ranks >= the tile's count return garbage (callers bound their loops by
    the count); ranks >= cap are not representable — the kernel resolves
    those from the words directly.
    """
    t, w = words.shape
    if w > 64:
        return _rank_table_bits_hier(words, cum, cap)
    j = jnp.arange(cap, dtype=jnp.int32)
    gt = (cum[:, None, :] > j[None, :, None]).astype(jnp.int32)  # (T, cap, W)
    p = w - gt.sum(-1)  # (T, cap) word index of rank j (first w: cum > j)
    oh = gt - jnp.concatenate(
        [jnp.zeros((t, cap, 1), jnp.int32), gt[:, :, :-1]], axis=2)  # 1 at p
    word_at = (words[:, None, :] * oh).sum(-1)  # (T, cap) == words[t, p]
    before = ((cum[:, None, :] * oh).sum(-1) -
              jax.lax.population_count(word_at))  # cum[t, p-1]
    bit = _nth_set_bit(word_at, j[None, :] - before)
    return jnp.minimum(p, w - 1) * 32 + bit


def _rank_table_bits_hier(words, cum, cap: int):
    """rank_table_bits for wide word rows (big C): two-level descent.

    The flat build materializes (T, cap, W) one-hots.  Here words group
    into S = W/sub SUPERWORDS: rank -> superword via a (T, cap, S) one-hot,
    then the superword's ``sub`` words are SELECTED with batched f32
    matmuls (values < 2^24 so f32 is exact; 32-bit word PATTERNS split into
    two 16-bit halves to stay exact), and the final word is picked by a
    second (T, cap, sub) one-hot.  Peak intermediate is (T, cap, max(S, sub)).
    """
    t, w = words.shape
    sub = 16
    s = -(-w // sub)
    if w % sub:
        pad = s * sub - w
        words = jnp.concatenate(
            [words, jnp.zeros((t, pad), jnp.int32)], axis=1)
        cum = jnp.concatenate(
            [cum, jnp.broadcast_to(cum[:, -1:], (t, pad))], axis=1)
    j = jnp.arange(cap, dtype=jnp.int32)
    cum_s = cum.reshape(t, s, sub)[:, :, -1]  # (T, S) super cumsums
    gt_s = (cum_s[:, None, :] > j[None, :, None]).astype(jnp.float32)
    sp = s - gt_s.sum(-1).astype(jnp.int32)  # (T, cap) superword of rank j
    oh_s = gt_s - jnp.concatenate(
        [jnp.zeros((t, cap, 1), jnp.float32), gt_s[:, :, :-1]], axis=2)

    def sel(vals_f32):  # (T, S, sub) -> (T, cap, sub) rows at sp
        return jnp.einsum("tjs,tsw->tjw", oh_s, vals_f32,
                          precision=_DOT_PRECISION)

    cum_r = cum.reshape(t, s, sub).astype(jnp.float32)
    cum_sel = sel(cum_r)  # (T, cap, sub) — exact: counts < 2^24
    gt_w = (cum_sel > j[None, :, None].astype(jnp.float32)).astype(jnp.int32)
    pw = sub - gt_w.sum(-1)  # in-super word index
    oh_w = (gt_w - jnp.concatenate(
        [jnp.zeros((t, cap, 1), jnp.int32), gt_w[:, :, :-1]], axis=2)
    ).astype(jnp.float32)
    wr = words.reshape(t, s, sub)
    w_lo = sel((wr & 0xFFFF).astype(jnp.float32))
    w_hi = sel(((wr >> 16) & 0xFFFF).astype(jnp.float32))
    word_at = ((w_lo * oh_w).sum(-1).astype(jnp.int32)
               | ((w_hi * oh_w).sum(-1).astype(jnp.int32) << 16))
    before = ((cum_sel * oh_w).sum(-1).astype(jnp.int32)
              - jax.lax.population_count(word_at))
    bit = _nth_set_bit(word_at, j[None, :] - before)
    p = jnp.minimum(sp * sub + pw, w - 1)
    return p * 32 + bit


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _make_kernel(k: int, anyhit: bool, cap: int, n_words: int):
    """Per-tile kernel body: walk ranks [0, count) of the tile's clusters.

    Ranks below ``cap`` come from the rank table; ranks past it (tiles that
    outgrew the table) are resolved from the occupancy words: a binary
    search over the running popcounts, then the in-word bit.
    """
    nbits = max((n_words - 1).bit_length(), 1)

    def kernel(rays_ref, t_ref, count_ref, table_ref, words_ref, cum_ref,
               entry_ref, w_ref, out_t_ref, out_slot_ref):
        tile = pl.program_id(0)
        ox, oy, oz = rays_ref[0][None, :], rays_ref[1][None, :], rays_ref[2][None, :]
        dx, dy, dz = rays_ref[3][None, :], rays_ref[4][None, :], rays_ref[5][None, :]

        def from_words(j):
            lo = jnp.int32(0)  # smallest p with cum[tile, p] > j
            for b in reversed(range(nbits)):
                cand = lo + (1 << b)
                val = cum_ref[tile, jnp.minimum(cand, n_words) - 1]
                lo = jnp.where((cand <= n_words) & (val <= j), cand, lo)
            p = jnp.minimum(lo, n_words - 1)
            before = jnp.where(p > 0, cum_ref[tile, jnp.maximum(p - 1, 0)], 0)
            return p * 32 + _nth_set_bit(words_ref[tile, p], j - before)

        def cluster_at(j):
            if cap >= n_words * 32:
                return table_ref[tile, j]
            return jax.lax.cond(j < cap, lambda j: table_ref[tile, j],
                                from_words, j)

        def gate(best_t, best_slot):
            # Largest t any ray of the tile could still accept.  Occlusion
            # rays are done once blocked, so they stop holding clusters open.
            if anyhit:
                best_t = jnp.where(best_slot >= 0, -BIG, best_t)
            return jnp.max(best_t)

        def visit(c, best_t, best_slot):
            def step(s, carry):
                best_t, best_slot = carry
                cols = pl.ds(pl.multiple_of(s * TRI_BLOCK, TRI_BLOCK), TRI_BLOCK)

                def row(r):
                    return w_ref[c, r, cols][:, None]  # (TRI_BLOCK, 1)

                def origin(a):
                    return (row(4 * a) * ox + row(4 * a + 1) * oy
                            + row(4 * a + 2) * oz + row(4 * a + 3))

                def direction(a):
                    return row(4 * a) * dx + row(4 * a + 1) * dy + row(4 * a + 2) * dz

                tt = -origin(2) / direction(2)
                u = origin(0) + tt * direction(0)
                v = origin(1) + tt * direction(1)
                ok = ((tt > T_MIN) & (tt < best_t[None, :]) & (u >= 0.0)
                      & (v >= 0.0) & (u + v <= 1.0))
                tt = jnp.where(ok, tt, INF)
                blk_t = jnp.min(tt, axis=0)
                blk_i = jnp.argmin(tt, axis=0).astype(jnp.int32)
                closer = blk_t < best_t
                return (jnp.where(closer, blk_t, best_t),
                        jnp.where(closer, c * k + s * TRI_BLOCK + blk_i,
                                  best_slot))

            # A loop, not an unrolled Python range: on the H100 Triton
            # compiles it ~10x faster, and it runs faster too (PERF.md).
            return jax.lax.fori_loop(0, k // TRI_BLOCK, step,
                                     (best_t, best_slot))

        def body(j, carry):
            best_t, best_slot = carry
            c = cluster_at(j)
            return jax.lax.cond(entry_ref[tile, c] <= gate(best_t, best_slot),
                                visit, lambda c, bt, bs: (bt, bs),
                                c, best_t, best_slot)

        best_t, best_slot = jax.lax.fori_loop(
            0, count_ref[tile], body,
            (t_ref[...], jnp.full((TILE_R,), -1, jnp.int32)))
        out_t_ref[...] = best_t
        out_slot_ref[...] = best_slot

    return kernel


def _launch(rays, t_init, counts, table, words, cum, entry, w, *,
            anyhit: bool, interpret: bool):
    """One kernel launch over every tile; returns (best_t, best_slot)."""
    m = t_init.shape[0]
    tiles, cap = table.shape
    ray_block = pl.BlockSpec((TILE_R,), lambda t: (t,))
    whole = pl.BlockSpec()
    kernel = _make_kernel(w.shape[2], anyhit, cap, words.shape[1])
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((m,), jnp.float32),
                   jax.ShapeDtypeStruct((m,), jnp.int32)],
        grid=(tiles,),
        in_specs=[pl.BlockSpec((8, TILE_R), lambda t: (0, t)), ray_block]
        + [whole] * 6,
        out_specs=[ray_block, ray_block],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="anyhit_tiles" if anyhit else "closest_hit_tiles",
    )(rays, t_init, counts, table, words, cum, entry, w)


@partial(jax.jit, static_argnames=("anyhit", "interpret", "cap"))
def _search(origins, dirs, t_init, cs: ClusterSet, wplanar, anyhit: bool,
            interpret: bool = False, cap: int = RANK_CAP):
    """(best_t, best_slot) over all rays (padded to whole tiles inside).

    ``t_init`` (N,) is each ray's exclusive upper bound on t.  Padding rays
    repeat the last real ray (so the tile's box does not grow) with a bound
    of 0, which accepts nothing.
    """
    n = origins.shape[0]
    pad = (-n) % TILE_R
    if pad:
        origins = jnp.concatenate(
            [origins, jnp.broadcast_to(origins[-1], (pad, 3))])
        dirs = jnp.concatenate([dirs, jnp.broadcast_to(dirs[-1], (pad, 3))])
        t_init = jnp.concatenate([t_init, jnp.zeros((pad,), jnp.float32)])
    m = origins.shape[0]
    tiles = m // TILE_R

    if not anyhit:
        # Seed each ray's bound with its SCENE-EXIT distance: no hit lies
        # past the point a ray leaves the scene box, so tiles mixing hit and
        # sky rays are not held open by the sky rays' T_MAX.
        lo = jnp.min(jnp.where(cs.valid[:, None], cs.aabb_min, jnp.inf), axis=0)
        hi = jnp.max(jnp.where(cs.valid[:, None], cs.aabb_max, -jnp.inf), axis=0)
        tn, tf = jnp.float32(-3e38), jnp.float32(3e38)
        for ax in range(3):
            inv = 1.0 / jnp.where(jnp.abs(dirs[:, ax]) < 1e-12,
                                  jnp.where(dirs[:, ax] < 0, -1e-12, 1e-12),
                                  dirs[:, ax])
            a = (lo[ax] - origins[:, ax]) * inv
            b = (hi[ax] - origins[:, ax]) * inv
            tn = jnp.maximum(tn, jnp.minimum(a, b))
            tf = jnp.minimum(tf, jnp.maximum(a, b))
        exit_t = jnp.where((tn <= tf) & (tf > 0), tf, T_MIN)
        t_init = jnp.minimum(t_init, exit_t * 1.001 + 1e-2)

    # A cluster whose conservative entry lies past every ray's bound can
    # accept nothing: drop it at binning time.  The margin covers f32
    # rounding between the slab entry and the Woop t.
    t_cap = jnp.max(t_init.reshape(tiles, TILE_R), axis=1)
    t_cap = t_cap * (1.0 + 2.0 ** -11) + 1e-7
    words, cum, entry, counts = bin_clusters_bits(
        origins.reshape(tiles, TILE_R, 3), dirs.reshape(tiles, TILE_R, 3), cs,
        t_cap=t_cap)
    cap = min(cap, words.shape[1] * 32)
    table = rank_table_bits(words, cum, cap)

    rays = jnp.concatenate([origins.T, dirs.T, jnp.zeros((2, m), jnp.float32)])
    best_t, best_slot = _launch(rays, t_init, counts, table, words, cum,
                                entry, wplanar, anyhit=anyhit,
                                interpret=interpret)
    return best_t[:n], best_slot[:n]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _mt_refine(o, d, slot, cs: ClusterSet):
    """Exact Möller-Trumbore (t, u, v) of each ray's winning sorted slot."""
    s = jnp.maximum(slot, 0)
    a = cs.v0[s]
    e1 = cs.e1[s]
    e2 = cs.e2[s]
    p = jnp.cross(d, e2)
    det = jnp.sum(e1 * p, axis=-1)
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    sv = o - a
    u = jnp.sum(sv * p, axis=-1) * inv_det
    q = jnp.cross(sv, e1)
    v = jnp.sum(d * q, axis=-1) * inv_det
    t = jnp.sum(e2 * q, axis=-1) * inv_det
    return t, u, v


@partial(jax.jit, static_argnames=("refine", "interpret"))
def intersect_pallas(origins, dirs, cs: ClusterSet, wplanar, t_max=None,
                     refine: bool = False, interpret: bool = False) -> Hit:
    """Closest hit in (T_MIN, t_max) via the tile kernel.

    By default returns the kernel's Woop ``t`` with u = v = 0 — the render
    paths re-evaluate exact (t, u, v) plus per-triangle ids with one wide
    packed-record gather (ops.intersect.hit_record).  Pass ``refine=True``
    for a standalone exact Hit.  ``interpret=True`` runs the kernel in the
    Pallas interpreter (CPU tests); without it the kernel compiles for the
    GPU or the call fails.
    """
    n = origins.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), T_MAX, jnp.float32)
    best_t, best_slot = _search(origins, dirs, t_max, cs, wplanar,
                                anyhit=False, interpret=interpret)
    hit = best_slot >= 0
    if cs.identity_order:
        tri = best_slot  # geometry is Morton-sorted: slot == triangle id
    else:
        tri = jnp.where(hit, cs.order[jnp.maximum(best_slot, 0)], -1)
    zero = jnp.zeros_like(best_t)
    if refine:
        rt, ru, rv = _mt_refine(origins, dirs, best_slot, cs)
        return Hit(t=jnp.where(hit, rt, INF), tri=tri,
                   u=jnp.where(hit, ru, 0.0), v=jnp.where(hit, rv, 0.0))
    return Hit(t=jnp.where(hit, best_t, INF), tri=tri, u=zero, v=zero)


@partial(jax.jit, static_argnames=("interpret",))
def occluded_pallas(origins, dirs, cs: ClusterSet, wplanar, t_max,
                    interpret: bool = False):
    """Any-hit: True where a triangle lies in (T_MIN, t_max[i]).

    A tile stops scheduling clusters for a ray once it is blocked, and the
    tile's walk skips everything once all armed rays are blocked."""
    _, best_slot = _search(origins, dirs, t_max.astype(jnp.float32), cs,
                           wplanar, anyhit=True, interpret=interpret)
    return best_slot >= 0
