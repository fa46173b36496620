"""Material evaluation: texture sampling, direct lighting, reflection and
refraction — the Whitted feature set the reference *declares* (parsed
materials/lights/textures, CRTSceneParser.cpp:152-405) but never uploads to
the GPU or executes (SURVEY.md fact 2).  Semantics follow the Chaos Ray
Tracing course model the `.crtscene` format comes from:

* point light contribution = ``intensity / (4 pi r^2) * max(0, n . l)``,
  attenuated to zero by an any-hit shadow ray;
* DIFFUSE  — albedo * sum(light contributions);
* CONSTANT — flat albedo (no lights, no bounce);
* REFLECTIVE — perfect mirror, throughput *= albedo;
* REFRACTIVE — Fresnel-weighted (Schlick) reflection + refraction with total
  internal reflection, albedo forced to (1,1,1) by the parser
  (CRTSceneParser.cpp:360-370);
* textures by type per CRTTexture* formulas (see models/texture.py): EDGES
  samples *barycentric* (u, v); CHECKER / BITMAP sample interpolated mesh UVs.

Everything is batched over ray arrays; per-material dispatch is vectorized
selects, not branches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.material import MaterialType
from ..models.scene import DeviceScene, TextureTable
from ..models.texture import TextureType
from ..utils.vecmath import normalize

FOUR_PI = 4.0 * np.pi
SHADOW_BIAS = 1e-3
RAY_BIAS = 1e-3


def sample_textures(tex: TextureTable, tex_id, uv, bary_uv):
    """Batched texture lookup.

    Args:
      tex: texture table.
      tex_id: (N,) i32 — texture index per ray (>= 0).
      uv: (N, 2) f32 — interpolated mesh UVs (checker / bitmap).
      bary_uv: (N, 2) f32 — barycentric (u, v) (edges).
    Returns (N, 3) f32 colors.
    """
    tid = jnp.maximum(tex_id, 0)
    rec = tex.packed[tid]  # one wide gather instead of six narrow ones
    ttype = rec[:, 0].astype(jnp.int32)
    color_a = rec[:, 1:4]
    color_b = rec[:, 4:7]
    scalar = rec[:, 7]

    # EDGES (CRTTextureEdges.cpp:9-15) — barycentric space.
    bu, bv = bary_uv[:, 0], bary_uv[:, 1]
    is_edge = (bu < scalar) | (bv < scalar) | (1.0 - bu - bv < scalar)
    edges_color = jnp.where(is_edge[:, None], color_a, color_b)

    # CHECKER (CRTTextureChecker.cpp:9-20) — width truncated toward zero.
    width = (1.0 / scalar).astype(jnp.int32).astype(jnp.float32)
    u2 = jnp.floor(uv[:, 0] * width).astype(jnp.int32)
    v2 = jnp.floor(uv[:, 1] * width).astype(jnp.int32)
    checker_color = jnp.where((((u2 + v2) % 2) == 0)[:, None], color_a, color_b)

    # BITMAP (CRTTextureBitmap.cpp:13-36) — clamp, v-flip, nearest.
    bid = jnp.maximum(rec[:, 8].astype(jnp.int32), 0)
    h = rec[:, 9]
    w = rec[:, 10]
    cu = jnp.clip(uv[:, 0], 0.0, 1.0)
    cv = jnp.clip(uv[:, 1], 0.0, 1.0)
    row = ((1.0 - cv) * (h - 1.0)).astype(jnp.int32)
    col = (cu * (w - 1.0)).astype(jnp.int32)
    bitmap_color = tex.atlas[bid, row, col]

    out = color_a  # ALBEDO (CRTTextureAlbedo.cpp:8-11)
    out = jnp.where((ttype == TextureType.EDGES)[:, None], edges_color, out)
    out = jnp.where((ttype == TextureType.CHECKER)[:, None], checker_color, out)
    out = jnp.where((ttype == TextureType.BITMAP)[:, None], bitmap_color, out)
    return out


def hit_attributes(dscene: DeviceScene, origins, dirs, hit, rec):
    """Per-ray surface attributes for shading, sliced from the fused record
    already gathered by ops.intersect.hit_record — NO additional gathers
    (row gathers are the costliest op class at 2M rays; the one exception
    is the texture table lookup, statically skipped for texture-free
    scenes).

    Args:
      rec: (N, 40) fused rows from hit_record (Geometry.packed layout).

    Returns dict with point, normal (smooth/flat per material), geometric
    normal, albedo (texture-resolved), and material fields.
    """
    u = hit.u[:, None]
    v = hit.v[:, None]
    w = 1.0 - u - v

    n_geom = rec[:, 21:24]
    uv0, uv1, uv2 = rec[:, 24:26], rec[:, 26:28], rec[:, 28:30]

    point = origins + dirs * hit.t[:, None]
    # Smooth-normal interpolation componentwise on (N,) arrays rather than
    # (N, 3) vector math (see ops.intersect.hit_record).
    uw, vw, ww = hit.u, hit.v, 1.0 - hit.u - hit.v
    nsx = ww * rec[:, 12] + uw * rec[:, 15] + vw * rec[:, 18]
    nsy = ww * rec[:, 13] + uw * rec[:, 16] + vw * rec[:, 19]
    nsz = ww * rec[:, 14] + uw * rec[:, 17] + vw * rec[:, 20]
    nlen = jnp.maximum(jnp.sqrt(nsx * nsx + nsy * nsy + nsz * nsz), 1e-12)
    n_smooth = jnp.stack([nsx / nlen, nsy / nlen, nsz / nlen], axis=-1)

    mtype = rec[:, 30].astype(jnp.int32)
    albedo = rec[:, 31:34]
    ior = rec[:, 34]
    smooth = rec[:, 35] > 0.5
    tex_id = rec[:, 36].astype(jnp.int32)
    specular = rec[:, 37]
    shininess = rec[:, 38]
    normal = jnp.where(smooth[:, None], n_smooth, n_geom)

    if dscene.has_textures:  # static — texture-free scenes skip the gather
        uv = w * uv0 + u * uv1 + v * uv2
        bary_uv = jnp.concatenate([hit.u[:, None], hit.v[:, None]], axis=1)
        tex_color = sample_textures(dscene.textures, tex_id, uv, bary_uv)
        albedo = jnp.where((tex_id >= 0)[:, None], tex_color, albedo)

    return {
        "point": point,
        "normal": normal,
        "n_geom": n_geom,
        "albedo": albedo,
        "mtype": mtype,
        "ior": ior,
        "specular": specular,
        "shininess": shininess,
    }


def _morton_key_points(p, lo, hi, armed):
    """30-bit Morton cell of each point; disarmed rays sort last."""
    ext = jnp.maximum(hi - lo, 1e-12)
    cell = jnp.clip((p - lo) / ext * 1024.0, 0.0, 1023.0).astype(jnp.int32)
    key = jnp.zeros((p.shape[0],), jnp.int32)
    for bit in range(10):
        for ax in range(3):
            key = key | (((cell[:, ax] >> bit) & 1) << (3 * bit + ax))
    return jnp.where(armed, key, jnp.int32(2**31 - 1))


def direct_lighting(points, normals, lights, occluder_fn, mask=None,
                    view=None, shininess=None, sort_bounds=None):
    """Lambert-weighted point-light sum with shadow rays (+ optional
    Blinn-Phong specular, BASELINE config 3).

    All L lights' shadow rays go to the occluder as ONE (L*N,) batch: each
    occluder call pays fixed binning/launch costs, and interleaving the
    lights keeps per-tile ray coherence (every tile's rays still aim at a
    single light).

    Args:
      points, normals: (N, 3).
      lights: LightTable.
      occluder_fn: (origins, dirs, max_t) -> (M,) bool any-hit test, or None
        to disable shadows.
      mask: optional (N,) bool — rays that actually need shadows; the rest
        are parked (origin 1e30, strictly-positive direction) so their
        tiles bin to zero BVH work.
      view: optional (N, 3) incident ray directions (pointing AT the
        surface).  When given, also returns the Blinn-Phong specular sum
        ``Σ_l intensity/(4πr²) · max(0, n·h)^shininess`` with
        h = normalize(l - view), shadow-gated like the diffuse term.
      shininess: (N,) f32 Blinn-Phong exponent (required with ``view``).
      sort_bounds: optional (scene_lo, scene_hi).  When given, the shadow
        work is done in MORTON-SORTED surface-point order: shadow tiles then
        hold spatially tight groups of armed rays (pixel-order tiles mix
        fore/background points at silhouettes and bin 7x more BVH clusters
        — measured 93 vs 12.5 clusters/tile on the 100k bench scene), and
        disarmed rays segregate to fully-parked tiles that bin to nothing.
        Costs one wide gather + one narrow unsort scatter at N rows.

    Returns (N, 1) un-albedo'd irradiance factor, or a tuple
    ((N, 1) diffuse, (N, 1) specular) when ``view`` is given.
    """
    n = points.shape[0]
    n_lights = lights.n_lights
    if n_lights == 0:
        zero = jnp.zeros((n, 1), jnp.float32)
        return (zero, zero) if view is not None else zero
    n_l = min(n_lights, lights.position.shape[0])
    lpos = lights.position[:n_l]  # (L, 3)
    linten = lights.intensity[:n_l]  # (L,)

    unsort = None
    if sort_bounds is not None and occluder_fn is not None:
        armed = mask if mask is not None else jnp.ones((n,), bool)
        armed = (armed & jnp.isfinite(points).all(axis=-1)
                 & jnp.isfinite(normals).all(axis=-1))
        key = _morton_key_points(points, jnp.asarray(sort_bounds[0]),
                                 jnp.asarray(sort_bounds[1]), armed)
        _, perm = jax.lax.sort_key_val(key, jnp.arange(n, dtype=jnp.int32))
        cols = [points, normals, armed.astype(jnp.float32)[:, None]]
        if view is not None:
            cols += [view, shininess[:, None]]
        packed = jnp.concatenate(cols, axis=1)[perm]  # ONE wide gather
        points, normals = packed[:, 0:3], packed[:, 3:6]
        mask = packed[:, 6] > 0.5
        if view is not None:
            view, shininess = packed[:, 7:10], packed[:, 10]
        unsort = perm

    # COMPONENTWISE (L, N) math throughout, rays on the minor axis: an
    # (L, N, 3)-shaped formulation materializes ~96 MB per intermediate at
    # 2M rays x 4 lights.
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    nxc, nyc, nzc = normals[:, 0], normals[:, 1], normals[:, 2]
    tx = lpos[:, 0:1] - px[None, :]  # (L, N)
    ty = lpos[:, 1:2] - py[None, :]
    tz = lpos[:, 2:3] - pz[None, :]
    d2 = tx * tx + ty * ty + tz * tz
    dist = jnp.sqrt(d2)  # (L, N)
    inv_d = 1.0 / jnp.maximum(dist, 1e-12)
    lxd, lyd, lzd = tx * inv_d, ty * inv_d, tz * inv_d
    cos = jnp.maximum(
        nxc[None, :] * lxd + nyc[None, :] * lyd + nzc[None, :] * lzd, 0.0)
    irrad = linten[:, None] / (FOUR_PI * jnp.maximum(dist, 1e-12) ** 2)  # (L, N)
    contrib = irrad * cos
    spec = None
    if view is not None:
        # half = normalize(ldir - view); n.h == n.(ldir - view) / |ldir - view|
        hx = lxd - view[None, :, 0]
        hy = lyd - view[None, :, 1]
        hz = lzd - view[None, :, 2]
        hinv = 1.0 / jnp.maximum(
            jnp.sqrt(hx * hx + hy * hy + hz * hz), 1e-12)
        ndoth = jnp.maximum(
            (nxc[None, :] * hx + nyc[None, :] * hy + nzc[None, :] * hz)
            * hinv, 0.0)
        # Gate on the diffuse cosine so back-facing lights never highlight.
        spec = irrad * jnp.where(cos > 0.0, ndoth ** shininess[None, :], 0.0)

    if occluder_fn is not None:
        sox = px + nxc * SHADOW_BIAS  # (N,) each
        soy = py + nyc * SHADOW_BIAS
        soz = pz + nzc * SHADOW_BIAS
        # Parked/degenerate wavefront slots carry non-finite points; give
        # them a strictly-positive far ray so their tiles bin to nothing
        # (see render/whitted.py parking note).  Masked-but-live rays KEEP
        # their true geometry — replacing it would blow up the conservative
        # box of any tile mixing masked and unmasked rays — and are disarmed
        # via t_max = 0 instead (zero kernel work, tight boxes).
        finite = (jnp.isfinite(sox) & jnp.isfinite(soy) & jnp.isfinite(soz))
        live = finite
        if unsort is not None and mask is not None:
            # Sorted mode: disarmed rays are segregated to the tail, so
            # parking them cannot blow up an armed tile's box — park them
            # and their tiles bin to zero visits.
            live = finite & mask
        sox = jnp.where(live, sox, 1e30)
        soy = jnp.where(live, soy, 1e30)
        soz = jnp.where(live, soz, 1e30)
        ok_l = (live[None, :] & jnp.isfinite(lxd) & jnp.isfinite(lyd)
                & jnp.isfinite(lzd))
        # Gated on cos > 0: a backfacing lane's diffuse AND specular terms
        # are zero regardless of occlusion, so disarming it (t_max = 0) is
        # exact and costs the kernel nothing.
        t_shadow = jnp.where(cos > 0.0, dist - 2.0 * SHADOW_BIAS, 0.0)
        if mask is not None:
            t_shadow = jnp.where((mask & finite)[None, :], t_shadow, 0.0)
        # The only (L, N, 3) materializations left: the occluder's SoA args.
        origins = jnp.stack(
            [jnp.broadcast_to(sox[None, :], (n_l, n)),
             jnp.broadcast_to(soy[None, :], (n_l, n)),
             jnp.broadcast_to(soz[None, :], (n_l, n))], axis=-1)
        dirs_occ = jnp.stack(
            [jnp.where(ok_l, lxd, 1.0), jnp.where(ok_l, lyd, 1.0),
             jnp.where(ok_l, lzd, 1.0)], axis=-1)
        blocked = occluder_fn(
            origins.reshape(-1, 3), dirs_occ.reshape(-1, 3),
            t_shadow.reshape(-1)
        ).reshape(n_l, n)
        contrib = jnp.where(blocked, 0.0, contrib)
        if spec is not None:
            spec = jnp.where(blocked, 0.0, spec)
    if mask is not None:
        contrib = jnp.where(mask[None, :], contrib, 0.0)
        if spec is not None:
            spec = jnp.where(mask[None, :], spec, 0.0)
    diffuse = jnp.sum(contrib, axis=0)[:, None]
    spec_sum = None if spec is None else jnp.sum(spec, axis=0)[:, None]
    if unsort is not None:  # scatter sorted results back to ray order
        diffuse = jnp.zeros_like(diffuse).at[unsort].set(diffuse)
        if spec_sum is not None:
            spec_sum = jnp.zeros_like(spec_sum).at[unsort].set(spec_sum)
    if spec_sum is None:
        return diffuse
    return diffuse, spec_sum


def reflect(d, n):
    """Mirror direction: d - 2 (d.n) n."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def refract_fresnel(d, n, ior):
    """Dielectric interaction for unit incident d, outward surface normal n.

    Handles rays entering (d.n < 0) and exiting (d.n > 0) the medium, total
    internal reflection, and Schlick's Fresnel approximation.

    Returns (refr_dir (N,3), refl_dir (N,3), fresnel_r (N,), tir (N,)):
      fresnel_r is the reflection weight; refraction weight = 1 - fresnel_r
      (forced to 1 on TIR).
    """
    cos_i = jnp.sum(d * n, axis=-1)  # negative when entering
    entering = cos_i < 0.0
    n_oriented = jnp.where(entering[:, None], n, -n)
    cos_i = jnp.abs(cos_i)
    eta = jnp.where(entering, 1.0 / ior, ior)  # n1/n2

    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))

    refr = eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n_oriented
    refr = normalize(refr, eps=1e-12)
    refl = reflect(d, n_oriented)

    r0 = ((eta - 1.0) / (eta + 1.0)) ** 2
    # Use the grazing-side cosine (cos_i when entering denser, else cos_t).
    cos_x = jnp.where(eta < 1.0, cos_i, cos_t)
    fres = r0 + (1.0 - r0) * (1.0 - cos_x) ** 5
    fres = jnp.where(tir, 1.0, fres)
    return refr, refl, fres, tir
