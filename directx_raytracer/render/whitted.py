"""Wavefront Whitted renderer — the feature set the reference *declares*
but never executes.

The reference parses materials, point lights and textures
(CRTSceneParser.cpp:152-405) yet uploads none of it to the GPU, caps
``MaxTraceRecursionDepth`` at 1 (DXRTRenderer.cpp:1169-1179) and never calls
``TraceRay`` from its closest-hit shader — so shadows/reflection/refraction
exist only as capability surface (SURVEY.md facts 1-2).  Here that surface is
made real, designed as a wavefront rather than a recursive per-pixel
shader:

* a ray *wavefront* is a fixed-capacity SoA queue (origins, dirs, RGB
  throughput, pixel id, active mask) generated directly in tile-major order
  (coherent tiles feed the binned BVH intersector); shapes stay static
  under jit;
* each bounce: closest-hit (the binned BVH intersector), one wide packed-record
  gather for surface attributes, terminal shading into the framebuffer
  (a plain aligned add on the primary pass; `.at[pixel].add` after
  compaction), then the surviving specular continuations are **compacted**
  (one key sort + a live-prefix chunked gather) into the next wavefront;
* REFRACTIVE surfaces *split* the ray: the refraction branch (weight
  1 - Fresnel) goes in the first half of the candidate list, the reflection
  branch (weight Fresnel) in the second half, so under queue overflow the
  perceptually-dominant transmission branch survives first.  Overflow is
  counted and returned, never silent;
* shading model follows the Chaos RT course the `.crtscene` format comes
  from: point light contribution ``intensity / (4 pi r^2) * max(0, n.l)``
  gated by an any-hit shadow ray; DIFFUSE/CONSTANT terminate; REFLECTIVE
  multiplies throughput by albedo and mirrors; REFRACTIVE uses Schlick
  Fresnel + total internal reflection (albedo forced to white by the parser,
  CRTSceneParser.cpp:360-370).

Divergence from a recursive tracer, documented: rays still alive at
``max_depth`` shade their final hit as DIFFUSE (direct lighting) instead of
returning black, which avoids hard black speckles on deep specular chains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.intersect import hit_record, intersect_bruteforce, occluded_bruteforce
from ..ops.rays import RGSS_OFFSETS, generate_rays, generate_rays_tiled, pick_tile
from .debug import untile
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import checks

# Continuations whose peak throughput falls below this contribute < 1/256 of
# a pixel value — kill them instead of tracing.
MIN_THROUGHPUT = 1e-3

# Pixel ids ride the compacted queue's packed f32 row as their NUMERIC value
# (exact for ids < 2^24), never as a bitcast int32 pattern: small ids bitcast
# to f32 DENORMALS, which a device that flushes denormals to zero would turn
# into pixel 0.  2^24 doubles as the parked-lane sentinel: >= any frame's
# pixel count, so the mode="drop" framebuffer scatter discards it.
PIXEL_SENTINEL = 1 << 24


def _default_intersect(origins, dirs, geo):
    return intersect_bruteforce(origins, dirs, geo.woop)


def _default_occluder(geo):
    def occluder(origins, dirs, max_t):
        return occluded_bruteforce(origins, dirs, geo.woop, max_t)

    return occluder


def _compact_sort(cand: dict, capacity: int, scene_lo, scene_hi,
                  split_at: int | None = None, chunk: int | None = None):
    """Compact + coherence-sort candidate rays into a queue of ``capacity``
    with ONE key sort and ONE wide gather.

    One sort and one gather replace a cumsum-prefix compaction (four row
    scatters) followed by a separate coherence sort with its own gather.

    Sort key, most- to least-significant: inactive (parked last, dropped
    by truncation first) | droppable branch (candidate indices >=
    ``split_at``, the Fresnel-reflection half — overflow drops it before
    the transmission half) | direction octant (3b) | origin Morton cell
    (24b).  Coherent tiles for the binned intersector fall out of the
    (octant, Morton) order as before.

    ``chunk``: when set, the survivor gather walks the LIVE PREFIX in
    chunk-row slices inside a ``while_loop`` instead of gathering all
    ``capacity`` rows — the surviving wavefront is typically a few percent
    of the queue.  Dead slots keep their parked defaults without ever being
    touched.

    Returns (queue, n_alive, n_dropped).
    """
    o = cand["origins"]
    d = cand["dirs"]
    q2 = o.shape[0]
    active = cand["active"]

    ext = jnp.maximum(scene_hi - scene_lo, 1e-12)
    cell = jnp.clip((o - scene_lo) / ext * 256.0, 0.0, 255.0).astype(jnp.int32)
    morton = jnp.zeros((q2,), jnp.int32)
    for bit in range(8):
        for ax in range(3):
            morton = morton | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
    octant = (
        ((d[:, 0] > 0).astype(jnp.int32) << 2)
        | ((d[:, 1] > 0).astype(jnp.int32) << 1)
        | (d[:, 2] > 0).astype(jnp.int32)
    )
    key = (octant << 24) | morton
    if split_at is not None:
        key = key | ((jnp.arange(q2, dtype=jnp.int32) >= split_at) << 27)
    key = jnp.where(active, key, jnp.int32(1) << 29)

    _, order = jax.lax.sort_key_val(key, jnp.arange(q2, dtype=jnp.int32))
    take = min(capacity, q2)
    n_alive = jnp.sum(active)
    src = jnp.concatenate(
        [o, d, cand["throughput"],
         jnp.minimum(cand["pixel"], PIXEL_SENTINEL).astype(jnp.float32)[:, None]],
        axis=1,
    )
    # Park dead slots: origin far outside the scene with strictly-positive
    # direction components, so their tiles bin to zero BVH visits (a zero
    # direction span makes the conservative tile box cover everything).
    park = jnp.array([1e30, 1e30, 1e30, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0,
                      float(PIXEL_SENTINEL)], jnp.float32)
    if chunk is None:
        packed = src[order[:take]]  # ONE wide gather of the survivors
        if capacity > take:  # chunk-aligned queues can exceed the candidates
            packed = jnp.pad(packed, ((0, capacity - take), (0, 0)))
        live = jnp.arange(capacity) < n_alive
        packed = jnp.where(live[:, None], packed, park[None, :])
    else:
        # Chunked survivor gather: only ceil(live / chunk) slices execute.
        assert capacity % chunk == 0, (capacity, chunk)
        lim = jnp.minimum(n_alive, take)
        packed = jnp.broadcast_to(park[None, :], (capacity, 10))
        # Pad so the final chunk's dynamic_slice never clamps (a clamped
        # start would misalign rows against the live mask).
        q2_pad = -(-q2 // chunk) * chunk
        order = jnp.pad(order, (0, q2_pad - q2))

        def body(carry):
            ci, buf = carry
            off = ci * chunk
            idx = jax.lax.dynamic_slice_in_dim(order, off, chunk)
            rows = src[idx]  # one chunk-row wide gather
            live = off + jnp.arange(chunk) < lim
            rows = jnp.where(live[:, None], rows, park[None, :])
            return ci + 1, jax.lax.dynamic_update_slice_in_dim(
                buf, rows, off, axis=0)

        _, packed = jax.lax.while_loop(
            lambda c: c[0] * chunk < lim, body, (jnp.int32(0), packed))

    queue = {
        "origins": packed[:, 0:3],
        "dirs": packed[:, 3:6],
        "throughput": packed[:, 6:9],
        "pixel": packed[:, 9].astype(jnp.int32),
        "active": jnp.arange(capacity) < n_alive,
    }
    # The returned count is CLAMPED to the queue capacity: callers use it
    # as the live-prefix loop bound, and an uncapped count past capacity
    # would make the clamped dynamic_slice re-execute the final chunk —
    # idempotent for the slot-indexed writes but NOT for the deferred
    # commit loops' scatter-ADD (over-bright pixels exactly when the
    # overflow-drop path triggers).
    return (queue, jnp.minimum(n_alive, capacity),
            jnp.maximum(n_alive - capacity, 0))


def _shade_chunk(dscene, state, framebuffer, intersect_fn, occluder_fn,
                 last: bool, aligned: bool = False, defer: bool = False):
    """Intersect + shade ONE wavefront slice; returns (fb', candidates).

    Candidates come back as (A, B) dicts of the slice's length: A = the
    overflow-surviving branch (mirror bounce / refractive transmission),
    B = the droppable Fresnel-reflection branch.  ``None`` when ``last``.

    ``defer=True`` (bounce passes): the slice's raw (chunk, 3) terminal
    contributions are returned IN PLACE of the framebuffer and the
    ``framebuffer`` argument is ignored — the caller commits them after
    its shading loop (see _shade_pass_bounce), so the framebuffer is not
    carried through the bounce while_loop.
    """
    geo = dscene.geometry
    active = state["active"]

    hit = intersect_fn(state["origins"], state["dirs"], geo)
    hit, _, _, _, rec = hit_record(state["origins"], state["dirs"], geo.packed, hit)
    hit_mask = active & hit.mask
    miss_mask = active & ~hit.mask

    attrs = hit_attributes(dscene, state["origins"], state["dirs"], hit, rec)
    mtype = attrs["mtype"]
    is_diffuse = mtype == MaterialType.DIFFUSE
    is_constant = mtype == MaterialType.CONSTANT
    is_reflective = mtype == MaterialType.REFLECTIVE
    is_refractive = mtype == MaterialType.REFRACTIVE
    if last:  # depth exhausted: specular shades as diffuse (see module doc)
        is_diffuse = is_diffuse | is_reflective | is_refractive
        is_reflective = jnp.zeros_like(is_reflective)
        is_refractive = jnp.zeros_like(is_refractive)

    thpt = state["throughput"]
    pixel = state["pixel"]

    # --- terminal contributions --------------------------------------------
    contrib = jnp.where(miss_mask[:, None], thpt * dscene.background_color[None, :], 0.0)

    diffuse_mask = hit_mask & is_diffuse
    # Shadow rays are Morton-sorted even for tile-major primary rays:
    # silhouette tiles mix fore/back surface points, whose shadow tiles
    # would bin far more clusters.
    sort_bounds = (geo.scene_lo, geo.scene_hi)
    if dscene.has_specular:  # static: pow() skipped for reference scenes
        light, spec_light = direct_lighting(
            attrs["point"], attrs["normal"], dscene.lights, occluder_fn,
            mask=diffuse_mask, view=state["dirs"],
            shininess=attrs["shininess"], sort_bounds=sort_bounds,
        )
        shaded = (attrs["albedo"] * light
                  + attrs["specular"][:, None] * spec_light)
    else:
        light = direct_lighting(attrs["point"], attrs["normal"],
                                dscene.lights, occluder_fn, mask=diffuse_mask,
                                sort_bounds=sort_bounds)
        shaded = attrs["albedo"] * light
    contrib = contrib + jnp.where(diffuse_mask[:, None], thpt * shaded, 0.0)
    contrib = contrib + jnp.where(
        (hit_mask & is_constant)[:, None], thpt * attrs["albedo"], 0.0
    )
    # DXRT_CHECK=1 debug build: the contribution is exactly what becomes
    # user-visible, so a NaN/inf here is a real shading bug (masked lanes
    # are already zeroed); a live ray's pixel id outside the framebuffer
    # would be silently dropped by mode="drop" below.
    checks.check(jnp.all(jnp.isfinite(contrib)),
                 "non-finite framebuffer contribution in shade pass")
    if framebuffer is not None:
        checks.check(
            jnp.all(~active | ((pixel >= 0) & (pixel < framebuffer.shape[0]))),
            "wavefront pixel id out of framebuffer range",
        )
    if defer:
        framebuffer = contrib  # caller-committed (see docstring)
    elif aligned:
        framebuffer = framebuffer + contrib
    else:
        framebuffer = framebuffer.at[pixel].add(contrib, mode="drop")

    if last:
        return framebuffer, None

    # --- specular continuations --------------------------------------------
    d = state["dirs"]
    n = attrs["normal"]
    refr_dir, refl_dir_o, fres, tir = refract_fresnel(d, n, attrs["ior"])
    # Offset origins off the surface along the *geometric* normal, on the
    # side the continuation travels.
    ng = attrs["n_geom"]
    side = jnp.sign(jnp.sum(d * ng, axis=-1, keepdims=True))  # +1 exiting face

    # Branch A (first half — survives overflow): reflective mirror bounce OR
    # refractive transmission.
    mirror_dir = reflect(d, n)
    a_refl = hit_mask & is_reflective
    a_refr = hit_mask & is_refractive & ~tir
    cand_a = {
        "origins": attrs["point"]
        + jnp.where(a_refr[:, None], side * ng * RAY_BIAS, -side * ng * RAY_BIAS),
        "dirs": jnp.where(a_refr[:, None], refr_dir, mirror_dir),
        "throughput": jnp.where(
            a_refr[:, None], thpt * (1.0 - fres)[:, None], thpt * attrs["albedo"]
        ),
        "pixel": pixel,
        "active": a_refl | a_refr,
    }

    # Branch B (second half — dropped first on overflow): the refractive
    # surface's Fresnel reflection (weight 1 on total internal reflection).
    b_mask = hit_mask & is_refractive
    cand_b = {
        "origins": attrs["point"] - side * ng * RAY_BIAS,
        "dirs": refl_dir_o,
        "throughput": thpt * fres[:, None],
        "pixel": pixel,
        "active": b_mask,
    }

    for c in (cand_a, cand_b):
        c["active"] = c["active"] & (
            jnp.max(c["throughput"], axis=-1) > MIN_THROUGHPUT
        )
    return framebuffer, (cand_a, cand_b)


def _shade_pass(dscene, state, framebuffer, intersect_fn, occluder_fn,
                last: bool, capacity: int | None = None, aligned: bool = False,
                chunk: int | None = None):
    """One UNCHUNKED wavefront pass (the primary): intersect, shade
    terminals into the framebuffer, emit compacted specular continuations.
    Returns (state', fb', stats).

    ``aligned=True`` (primary pass): rays are in framebuffer order, so the
    contribution is a plain add instead of a 2M-row scatter."""
    geo = dscene.geometry
    q = capacity or state["origins"].shape[0]
    framebuffer, cands = _shade_chunk(
        dscene, state, framebuffer, intersect_fn, occluder_fn, last,
        aligned=aligned)
    if cands is None:
        return None, framebuffer, {"alive": jnp.int32(0),
                                   "dropped": jnp.int32(0)}
    cand_a, cand_b = cands
    cand = {k: jnp.concatenate([cand_a[k], cand_b[k]]) for k in cand_a}
    # Branch A occupies the first half of the candidate list; split_at makes
    # overflow drop the Fresnel-reflection half (B) first.
    new_state, n_alive, n_drop = _compact_sort(
        cand, q, geo.scene_lo, geo.scene_hi,
        split_at=cand_a["origins"].shape[0], chunk=chunk,
    )
    return new_state, framebuffer, {"alive": n_alive, "dropped": n_drop}


def _shade_pass_bounce(dscene, state, framebuffer, n_alive, intersect_fn,
                       occluder_fn, last: bool, chunk: int):
    """One BOUNCE pass, chunked: only ceil(n_alive / chunk) slices execute.

    The queue is compacted (live rays first), so a ``while_loop`` over
    fixed-size slices stops after the live prefix — per-bounce cost then
    scales with the surviving wavefront instead of the full static queue
    (typically a few percent of it).  Shapes
    stay static and no host sync is needed: the loop bound ``n_alive``
    rides the device as the previous pass's compaction count.
    """
    geo = dscene.geometry
    q = state["origins"].shape[0]
    n_chunks = q // chunk

    zero3 = jnp.zeros((q, 3), jnp.float32)
    cand = {
        "origins": jnp.concatenate([zero3, zero3]),
        "dirs": jnp.ones((2 * q, 3), jnp.float32),
        "throughput": jnp.concatenate([zero3, zero3]),
        "pixel": jnp.full((2 * q,), PIXEL_SENTINEL, jnp.int32),
        "active": jnp.zeros((2 * q,), bool),
    }

    def body(carry):
        ci, cq, cand = carry
        off = ci * chunk
        sub = {k: jax.lax.dynamic_slice_in_dim(v, off, chunk)
               for k, v in state.items()}
        contrib, cands = _shade_chunk(dscene, sub, None, intersect_fn,
                                      occluder_fn, last, aligned=False,
                                      defer=True)
        cq = jax.lax.dynamic_update_slice_in_dim(cq, contrib, off, axis=0)
        if cands is not None:
            ca, cb = cands
            for k in cand:
                cand[k] = jax.lax.dynamic_update_slice_in_dim(
                    cand[k], ca[k], off, axis=0)
                cand[k] = jax.lax.dynamic_update_slice_in_dim(
                    cand[k], cb[k], q + off, axis=0)
        return ci + 1, cq, cand

    def cond(carry):
        return carry[0] * chunk < n_alive

    # Shading loop accumulates raw contributions into a slot-indexed queue
    # (contiguous dynamic_update_slice — no scatter); the framebuffer is
    # NOT part of this loop's carry.
    _, cq, cand = jax.lax.while_loop(
        cond, body, (jnp.int32(0), zero3, cand))

    # Deferred commit: a second live-prefix loop whose body is just one
    # slice + one chunk-row scatter-add, with the framebuffer as the ONLY
    # carry.
    def commit(carry):
        ci, fb = carry
        off = ci * chunk
        ids = jax.lax.dynamic_slice_in_dim(state["pixel"], off, chunk)
        vals = jax.lax.dynamic_slice_in_dim(cq, off, chunk)
        # The deferred path never traces _shade_chunk's in-pass range
        # check (its framebuffer is None) — enforce the queue invariant
        # here in the DXRT_CHECK build: live ids in range, parked ids
        # exactly the sentinel (a denormal-flushed id would trip this
        # instead of silently dropping).
        checks.check(
            jnp.all((ids >= 0) & ((ids < fb.shape[0])
                                  | (ids == PIXEL_SENTINEL))),
            "bounce commit pixel id outside framebuffer/sentinel range",
        )
        return ci + 1, fb.at[ids].add(vals, mode="drop")

    _, framebuffer = jax.lax.while_loop(
        cond, commit, (jnp.int32(0), framebuffer))

    if last:
        return None, framebuffer, {"alive": jnp.int32(0),
                                   "dropped": jnp.int32(0)}
    new_state, n_alive2, n_drop = _compact_sort(
        cand, q, geo.scene_lo, geo.scene_hi, split_at=q, chunk=chunk,
    )
    return new_state, framebuffer, {"alive": n_alive2, "dropped": n_drop}


def render_tile(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    offsets,
    weight: float,
    row_start=0,
    rows: int | None = None,
    max_depth: int = 5,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
    offset_weights=None,
    chunk_div: int = 16,
):
    """Core tile renderer (trace-level; callers jit / shard_map it).

    Renders the full-width row tile [row_start, row_start+rows) of an
    (height x width) frustum, accumulating one wavefront per subpixel offset.

    Args:
      offsets: (K, 2) f32 subpixel offsets — may be traced (sample sharding).
      weight: per-sample framebuffer weight, normally 1 / total_spp (total
        across all shards, not just this tile's K).
      row_start: traced or static first row of the tile.
      offset_weights: optional (K,) f32 per-offset multipliers on ``weight``
        (may be traced).  Used by the multichip path to pad the sample axis:
        a padding offset carries weight 0 and contributes nothing.

    Returns (rows, W, 3) image + stats {alive, dropped} per pass.
    """
    geo = dscene.geometry
    isect = intersect_fn or _default_intersect
    occluder = (occluder_factory or _default_occluder)(geo)
    rows = height if rows is None else rows
    offsets = jnp.asarray(offsets, jnp.float32)
    if queue_factor is None:
        # Without refractive materials rays never split: a bounce wavefront
        # can't outgrow the previous one, so capacity n_pix suffices and
        # every bounce pass halves its static workload.
        queue_factor = 2 if dscene.has_refractive else 1

    n_pix = width * rows
    # Static guard for the queue's f32 pixel-id lane (see PIXEL_SENTINEL).
    assert n_pix < PIXEL_SENTINEL, (n_pix, PIXEL_SENTINEL)
    # The primary wavefront is generated directly in tile-major order:
    # coherent ray tiles feed the binned BVH intersector, the framebuffer
    # lives in the same order (plain add on the primary pass), and the
    # final raster reorder is a pure reshape/transpose.
    tile = pick_tile(rows, width)

    if offset_weights is None:
        offset_weights = jnp.ones((offsets.shape[0],), jnp.float32)
    else:
        offset_weights = jnp.asarray(offset_weights, jnp.float32)

    # Bounce queues are chunk-aligned so the chunked bounce passes can walk
    # just the live prefix (see _shade_pass_bounce).  chunk_div=16: not
    # measured on the card.
    q = n_pix * queue_factor
    chunk = -(-max(q // chunk_div, 256) // 256) * 256
    q_pad = -(-q // chunk) * chunk

    framebuffer = jnp.zeros((n_pix, 3), jnp.float32)
    stats = []
    for k in range(offsets.shape[0]):
        if tile is None:
            origins, dirs = generate_rays(
                cam_position, cam_rotation, width, height, offsets[k],
                row_start, rows
            )
        else:
            origins, dirs = generate_rays_tiled(
                cam_position, cam_rotation, width, height, tile[0], tile[1],
                offsets[k], row_start, rows
            )
        state = {
            "origins": origins,
            "dirs": dirs,
            "throughput": jnp.full((n_pix, 3), weight, jnp.float32)
            * offset_weights[k],
            "pixel": jnp.arange(n_pix, dtype=jnp.int32),
            "active": jnp.ones((n_pix,), bool),
        }
        alive = jnp.int32(n_pix)
        for depth in range(max_depth):
            if depth == 0:
                state, framebuffer, s = _shade_pass(
                    dscene, state, framebuffer, isect, occluder,
                    last=(max_depth == 1),
                    capacity=q_pad,
                    aligned=True,
                    chunk=chunk,
                )
            else:
                state, framebuffer, s = _shade_pass_bounce(
                    dscene, state, framebuffer, alive, isect, occluder,
                    last=(depth == max_depth - 1),
                    chunk=chunk,
                )
            alive = s["alive"]
            stats.append(s)
            if state is None:
                break

    image = untile(framebuffer, width, rows, tile)
    return image, {
        "alive": jnp.stack([s["alive"] for s in stats]),
        "dropped": jnp.stack([s["dropped"] for s in stats]),
    }


def spp_offsets(spp: int):
    """Subpixel offsets for an arbitrary spp count.

    1 = the reference's pixel center (hlsl:35-36), 4 = rotated-grid AA
    (kept bit-identical to round 1's goldens), any other N = a deterministic
    Hammersley set (stratified (i+0.5)/N x van-der-Corput base 2) — no RNG,
    so Whitted AA stays reproducible across runs and chips.
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    if spp == 1:
        return ((0.5, 0.5),)
    if spp == 4:
        return RGSS_OFFSETS

    def _vdc(i: int) -> float:  # van der Corput radical inverse, base 2
        v, f = 0.0, 0.5
        while i:
            if i & 1:
                v += f
            f *= 0.5
            i >>= 1
        return v

    half = 0.5 / spp
    return tuple(((i + 0.5) / spp, _vdc(i) + half) for i in range(spp))


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_depth", "spp", "intersect_fn", "occluder_factory",
        "queue_factor", "chunk_div",
    ),
)
def render_whitted(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
    chunk_div: int = 16,
):
    """Render one Whitted frame (single chip).

    Args:
      dscene: device scene pytree.
      cam_position, cam_rotation: camera snapshot ((3,), (3,3)).
      width, height, max_depth: static.
      spp: 1 (pixel center, reference raygen) or 4 (rotated-grid AA).
      intersect_fn: (origins, dirs, geometry) -> Hit override (e.g. BVH).
      occluder_factory: geometry -> (origins, dirs, max_t) -> bool override.
      queue_factor: secondary-wavefront capacity as a multiple of H*W;
        None (default) auto-selects 2 for scenes with refractive materials
        (keeps both branches of a full-screen refractive surface alive) and
        1 otherwise (rays never split).  Deeper splits can still overflow —
        the transmission branch survives first and overflow is reported in
        stats.

    Returns:
      image (H, W, 3) f32 linear, stats dict {alive, dropped per pass}.
    """
    offs = spp_offsets(spp)
    return render_tile(
        dscene, cam_position, cam_rotation, width, height,
        offsets=jnp.asarray(offs, jnp.float32), weight=1.0 / len(offs),
        row_start=0, rows=height, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory,
        queue_factor=queue_factor, chunk_div=chunk_div,
    )


_checked_cache: dict = {}


def render_whitted_checked(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor=None,
):
    """``render_whitted`` under ``jax.experimental.checkify`` — the
    DXRT_CHECK=1 debug build (see utils.checks).  Raises
    ``checkify.JaxRuntimeError`` on a non-finite framebuffer contribution
    or an out-of-range wavefront pixel id; same return value otherwise.
    """
    from jax.experimental import checkify

    key = (width, height, max_depth, spp, intersect_fn, occluder_factory,
           queue_factor)
    fn = _checked_cache.get(key)
    if fn is None:
        offs = spp_offsets(spp)

        def impl(dscene, cam_position, cam_rotation):
            return render_tile(
                dscene, cam_position, cam_rotation, width, height,
                offsets=jnp.asarray(offs, jnp.float32),
                weight=1.0 / len(offs), row_start=0, rows=height,
                max_depth=max_depth, intersect_fn=intersect_fn,
                occluder_factory=occluder_factory, queue_factor=queue_factor,
            )

        fn = jax.jit(checkify.checkify(impl))
        _checked_cache[key] = fn
    err, out = fn(dscene, jnp.asarray(cam_position, jnp.float32),
                  jnp.asarray(cam_rotation, jnp.float32))
    err.throw()
    return out
