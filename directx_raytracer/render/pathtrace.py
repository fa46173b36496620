"""Progressive wavefront path tracer — BASELINE config 5 (stretch).

Monte Carlo extension of the Whitted wavefront (render/whitted.py): the same
fixed-capacity compacted ray queues, but stochastic transport instead of
deterministic splitting:

* DIFFUSE: full next-event estimation against ALL point lights through the
  Morton-sorted interleaved shadow machinery (ops.shading.direct_lighting;
  same ``intensity / (4 pi r^2) * cos`` model as the Whitted path, so
  1-bounce PT matches the Whitted direct term) + cosine-weighted
  hemisphere continuation (throughput *= albedo — the cos/pdf cancel);
* REFLECTIVE: deterministic mirror, throughput *= albedo;
* REFRACTIVE: one stochastic branch chosen with Fresnel probability
  (throughput unchanged — the probability cancels the weight; albedo is
  white by the parser's rule);
* CONSTANT: emissive-style flat terminal (albedo added, no lights);
* misses add throughput * background (the environment term);
* Russian roulette from bounce 3 keeps expected value unbiased while
  draining the queue.

Progressive accumulation lives in a ``PTState`` pytree (accumulated linear
radiance + sample count + PRNG key) that is checkpointable to ``.npz``
(save_state/load_state) — the checkpoint/resume surface the reference's
File->Save stub never implemented (DXRTMainWindow.cpp:155-158).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.material import MaterialType
from ..models.scene import DeviceScene
from ..ops.intersect import hit_record
from ..ops.rays import generate_rays, generate_rays_tiled, pick_tile
from ..ops.shading import RAY_BIAS, direct_lighting, hit_attributes, reflect, refract_fresnel
from ..utils import checks
from .debug import untile
from .whitted import (PIXEL_SENTINEL, _compact_sort, _default_intersect,
                      _default_occluder)

MIN_THROUGHPUT = 5e-3
RR_START = 3  # first bounce applying Russian roulette


def _onb(n):
    """Orthonormal basis around unit normal n (Duff et al. branchless)."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = jnp.stack([1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=1)
    bt = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=1)
    return t, bt


def _cosine_sample(key, n):
    """Cosine-weighted hemisphere directions about normals n (N, 3)."""
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, (n.shape[0],))
    u2 = jax.random.uniform(k2, (n.shape[0],))
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
    t, bt = _onb(n)
    return x[:, None] * t + y[:, None] * bt + z[:, None] * n


def _pt_shade_chunk(dscene, state, radiance, key, depth, intersect_fn,
                    occluder_fn, defer: bool = False):
    """Intersect + shade ONE wavefront slice stochastically; returns
    (radiance', candidate continuations of the slice's length).

    ``defer=True`` (bounce passes): returns the slice's raw (chunk, 3)
    contributions in place of ``radiance`` (ignored) — the caller commits
    them after its shading loop, mirroring whitted._shade_pass_bounce's
    minimal-carry scatter loop."""
    geo = dscene.geometry
    active = state["active"]
    hit = intersect_fn(state["origins"], state["dirs"], geo)
    hit, _, _, _, rec = hit_record(state["origins"], state["dirs"], geo.packed, hit)
    hit_mask = active & hit.mask
    miss_mask = active & ~hit.mask
    attrs = hit_attributes(dscene, state["origins"], state["dirs"], hit, rec)
    mtype = attrs["mtype"]
    thpt = state["throughput"]
    pixel = state["pixel"]

    is_diffuse = hit_mask & (mtype == MaterialType.DIFFUSE)
    is_constant = hit_mask & (mtype == MaterialType.CONSTANT)
    is_mirror = hit_mask & (mtype == MaterialType.REFLECTIVE)
    is_glass = hit_mask & (mtype == MaterialType.REFRACTIVE)

    k_nee, k_dir, k_branch, k_rr = jax.random.split(key, 4)

    # Terminal / direct contributions.  NEE sums ALL lights through the
    # Morton-sorted interleaved shadow machinery (ops.shading
    # direct_lighting), which also removes the light-pick variance.  k_nee
    # stays reserved so downstream RNG streams are unchanged.
    contrib = jnp.where(miss_mask[:, None], thpt * dscene.background_color[None, :], 0.0)
    del k_nee
    direct = direct_lighting(
        attrs["point"], attrs["normal"], dscene.lights, occluder_fn,
        mask=is_diffuse, sort_bounds=(geo.scene_lo, geo.scene_hi))
    contrib += jnp.where(is_diffuse[:, None], thpt * attrs["albedo"] * direct, 0.0)
    contrib += jnp.where(is_constant[:, None], thpt * attrs["albedo"], 0.0)
    # DXRT_CHECK=1 debug build (see utils.checks): guard what reaches the
    # accumulator; masked lanes are already zeroed so this flags real bugs.
    checks.check(jnp.all(jnp.isfinite(contrib)),
                 "non-finite radiance contribution in PT bounce")
    if radiance is not None:
        checks.check(
            jnp.all(~active | ((pixel >= 0) & (pixel < radiance.shape[0]))),
            "PT wavefront pixel id out of framebuffer range",
        )
    if defer:
        radiance = contrib  # caller-committed (see docstring)
    elif depth:
        radiance = radiance.at[pixel].add(contrib, mode="drop")
    else:
        radiance = radiance + contrib

    # Continuations (single stochastic branch per ray).
    n = attrs["normal"]
    d = state["dirs"]
    ng = attrs["n_geom"]
    side = jnp.sign(jnp.sum(d * ng, axis=-1, keepdims=True))

    diff_dir = _cosine_sample(k_dir, n)
    mirror_dir = reflect(d, n)
    refr_dir, refl_dir, fres, tir = refract_fresnel(d, n, attrs["ior"])
    pick_refl = jax.random.uniform(k_branch, (fres.shape[0],)) < fres
    glass_dir = jnp.where(pick_refl[:, None], refl_dir, refr_dir)
    glass_out = jnp.where(pick_refl[:, None], -side, side)

    new_dir = jnp.where(is_diffuse[:, None], diff_dir, d)
    new_dir = jnp.where(is_mirror[:, None], mirror_dir, new_dir)
    new_dir = jnp.where(is_glass[:, None], glass_dir, new_dir)
    # Glass offsets to the transmission/reflection side of the geometric
    # normal; diffuse/mirror continue off the shading normal.
    offset = jnp.where(is_glass[:, None], glass_out * ng * RAY_BIAS, n * RAY_BIAS)

    new_thpt = jnp.where(is_diffuse[:, None] | is_mirror[:, None],
                         thpt * attrs["albedo"], thpt)

    cont = is_diffuse | is_mirror | is_glass
    # Russian roulette: unbiased queue draining.
    if depth >= RR_START:
        p = jnp.clip(jnp.max(new_thpt, axis=-1), 0.05, 1.0)
        survive = jax.random.uniform(k_rr, p.shape) < p
        cont = cont & survive
        new_thpt = new_thpt / p[:, None]
    cont = cont & (jnp.max(new_thpt, axis=-1) > MIN_THROUGHPUT)

    cand = {
        "origins": attrs["point"] + offset,
        "dirs": new_dir,
        "throughput": new_thpt,
        "pixel": pixel,
        "active": cont,
    }
    return radiance, cand


def _pt_pass(dscene, state, radiance, key, depth, intersect_fn, occluder_fn,
             capacity, chunk=None):
    """One UNCHUNKED PT pass (the primary, rays in framebuffer order)."""
    geo = dscene.geometry
    radiance, cand = _pt_shade_chunk(dscene, state, radiance, key, depth,
                                     intersect_fn, occluder_fn)
    # Fused compaction + coherence sort + parking (see whitted._compact_sort).
    new_state, n_alive, _ = _compact_sort(cand, capacity, geo.scene_lo,
                                          geo.scene_hi, chunk=chunk)
    return new_state, radiance, n_alive


def _pt_pass_bounce(dscene, state, radiance, key, depth, intersect_fn,
                    occluder_fn, n_alive, chunk, last: bool = False):
    """One BOUNCE pass, chunked: only ceil(n_alive / chunk) slices execute.

    Same live-prefix discipline as whitted._shade_pass_bounce — the queue is
    compacted, so a while_loop over fixed-size slices stops after the live
    prefix; per-bounce cost (incl. the hit-record / attribute gathers, NEE
    and the survivor compaction gather) scales with the surviving wavefront
    instead of the full static queue.  Each chunk folds its index into the
    bounce key so streams stay independent across chunks.
    """
    geo = dscene.geometry
    q = state["origins"].shape[0]

    cand = {
        "origins": jnp.zeros((q, 3), jnp.float32),
        "dirs": jnp.ones((q, 3), jnp.float32),
        "throughput": jnp.zeros((q, 3), jnp.float32),
        "pixel": jnp.full((q,), PIXEL_SENTINEL, jnp.int32),
        "active": jnp.zeros((q,), bool),
    }

    def body(carry):
        ci, cq, cand = carry
        off = ci * chunk
        sub = {k: jax.lax.dynamic_slice_in_dim(v, off, chunk)
               for k, v in state.items()}
        contrib, sub_cand = _pt_shade_chunk(
            dscene, sub, None, jax.random.fold_in(key, ci), depth,
            intersect_fn, occluder_fn, defer=True)
        cq = jax.lax.dynamic_update_slice_in_dim(cq, contrib, off, axis=0)
        cand2 = {k: jax.lax.dynamic_update_slice_in_dim(
            cand[k], sub_cand[k], off, axis=0) for k in cand}
        return ci + 1, cq, cand2

    def cond(carry):
        return carry[0] * chunk < n_alive

    # Contributions land in a slot-indexed queue during shading; the
    # radiance buffer is committed by a second minimal-carry loop (one
    # slice + one chunk-row scatter-add) — same staging rationale as
    # whitted._shade_pass_bounce.
    _, cq, cand = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((q, 3), jnp.float32), cand))

    def commit(carry):
        ci, rad = carry
        off = ci * chunk
        ids = jax.lax.dynamic_slice_in_dim(state["pixel"], off, chunk)
        vals = jax.lax.dynamic_slice_in_dim(cq, off, chunk)
        # The deferred path never traces the in-chunk range check (the
        # radiance buffer is None there) — enforce the queue invariant
        # here in the debug build: a live slot's id is in range, a parked
        # slot's is exactly the sentinel.
        checks.check(
            jnp.all((ids >= 0) & ((ids < rad.shape[0])
                                  | (ids == PIXEL_SENTINEL))),
            "PT bounce commit pixel id outside framebuffer/sentinel range",
        )
        return ci + 1, rad.at[ids].add(vals, mode="drop")

    _, radiance = jax.lax.while_loop(
        cond, commit, (jnp.int32(0), radiance))

    if last:  # the continuations are never consumed: skip the compaction
        return None, radiance, jnp.int32(0)
    new_state, n_alive2, _ = _compact_sort(cand, q, geo.scene_lo,
                                           geo.scene_hi, chunk=chunk)
    return new_state, radiance, n_alive2


def pathtrace_tile(dscene: DeviceScene, cam_position, cam_rotation, key,
                   width: int, height: int, row_start=0,
                   rows: int | None = None, max_depth: int = 6,
                   intersect_fn=None, occluder_factory=None):
    """One sample of the full-width row tile [row_start, row_start+rows):
    (rows*W, 3) tile-major linear radiance.  Trace-level (callers jit)."""
    geo = dscene.geometry
    isect = intersect_fn or _default_intersect
    occluder = (occluder_factory or _default_occluder)(geo)
    rows = height if rows is None else rows
    n_pix = width * rows
    tile = pick_tile(rows, width)

    key, k_jit = jax.random.split(key)
    off = jax.random.uniform(k_jit, (2,))  # per-sample subpixel jitter
    if tile is None:
        origins, dirs = generate_rays(cam_position, cam_rotation, width,
                                      height, off, row_start, rows)
    else:
        origins, dirs = generate_rays_tiled(
            cam_position, cam_rotation, width, height, tile[0], tile[1], off,
            row_start, rows
        )

    state = {
        "origins": origins,
        "dirs": dirs,
        "throughput": jnp.ones((n_pix, 3), jnp.float32),
        "pixel": jnp.arange(n_pix, dtype=jnp.int32),
        "active": jnp.ones((n_pix,), bool),
    }
    radiance = jnp.zeros((n_pix, 3), jnp.float32)
    # Static guard for the queue's f32 pixel-id lane (same invariant as
    # whitted.render_tile — ids past the sentinel would be silently
    # clamped/dropped by the bounce commit instead of failing loud).
    assert n_pix < PIXEL_SENTINEL, (n_pix, PIXEL_SENTINEL)
    # Bounce queues are chunk-aligned so the chunked bounce passes can walk
    # just the live prefix (mirrors whitted.render_tile's sizing; PT rays
    # never split, so capacity n_pix suffices).
    chunk = -(-max(n_pix // 16, 256) // 256) * 256
    q_pad = -(-n_pix // chunk) * chunk
    for depth in range(max_depth):
        key, k = jax.random.split(key)
        if depth == 0:
            state, radiance, alive = _pt_pass(
                dscene, state, radiance, k, depth, isect, occluder,
                capacity=q_pad, chunk=chunk)
        else:
            state, radiance, alive = _pt_pass_bounce(
                dscene, state, radiance, k, depth, isect, occluder,
                alive, chunk, last=(depth == max_depth - 1))
        if state is None:
            break
    return radiance


@partial(jax.jit, static_argnames=("width", "height", "max_depth",
                                   "intersect_fn", "occluder_factory"))
def pathtrace_sample(dscene: DeviceScene, cam_position, cam_rotation, key,
                     width: int, height: int, max_depth: int = 6,
                     intersect_fn=None, occluder_factory=None):
    """One full-image sample: (H*W, 3) tile-major linear radiance."""
    return pathtrace_tile(
        dscene, cam_position, cam_rotation, key, width, height,
        row_start=0, rows=height, max_depth=max_depth,
        intersect_fn=intersect_fn, occluder_factory=occluder_factory,
    )


class PathTracer:
    """Progressive accumulator with checkpoint/resume."""

    def __init__(self, dscene, width: int, height: int, max_depth: int = 6,
                 intersect_fn=None, occluder_factory=None, seed: int = 0):
        self.dscene = dscene
        self.width = width
        self.height = height
        self.max_depth = max_depth
        self.intersect_fn = intersect_fn
        self.occluder_factory = occluder_factory
        self.accum = jnp.zeros((width * height, 3), jnp.float32)
        self.n_samples = 0
        self.key = jax.random.PRNGKey(seed)

    def step(self, cam_position, cam_rotation, n: int = 1):
        for _ in range(n):
            self.key, k = jax.random.split(self.key)
            self.accum = self.accum + self._sample(cam_position, cam_rotation,
                                                   k)
            self.n_samples += 1
        return self

    def _sample(self, cam_position, cam_rotation, k):
        if checks.enabled():  # DXRT_CHECK=1: functionalize + raise guards
            from jax.experimental import checkify

            fn = getattr(self, "_checked_fn", None)
            if fn is None:
                def impl(dscene, pos, rot, key):
                    return pathtrace_tile(
                        dscene, pos, rot, key, self.width, self.height,
                        row_start=0, rows=self.height,
                        max_depth=self.max_depth,
                        intersect_fn=self.intersect_fn,
                        occluder_factory=self.occluder_factory,
                    )

                fn = self._checked_fn = jax.jit(checkify.checkify(impl))
            err, out = fn(self.dscene, cam_position, cam_rotation, k)
            err.throw()
            return out
        return pathtrace_sample(
            self.dscene, cam_position, cam_rotation, k,
            self.width, self.height, self.max_depth,
            self.intersect_fn, self.occluder_factory,
        )

    def image(self):
        """(H, W, 3) mean radiance in raster order."""
        tile = pick_tile(self.height, self.width)
        mean = self.accum / max(self.n_samples, 1)
        return untile(mean, self.width, self.height, tile)

    def reset(self):
        self.accum = jnp.zeros_like(self.accum)
        self.n_samples = 0

    # -- checkpoint / resume ------------------------------------------------
    def save_state(self, path: str) -> None:
        np.savez(path, accum=np.asarray(self.accum), n_samples=self.n_samples,
                 key=np.asarray(self.key), width=self.width, height=self.height)

    def load_state(self, path: str) -> None:
        z = np.load(path)
        if int(z["width"]) != self.width or int(z["height"]) != self.height:
            raise ValueError("checkpoint resolution mismatch")
        self.accum = jnp.asarray(z["accum"])
        self.n_samples = int(z["n_samples"])
        self.key = jnp.asarray(z["key"])
