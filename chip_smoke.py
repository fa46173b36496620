"""Smoke test of the renderer on an NVIDIA GPU, in one process.

    python chip_smoke.py           # phases (a)-(c) on one card
    python chip_smoke.py --multi   # phase (d) only, on four cards

Phases (every failure is reported; any failure exits 1 with no result line):

  (a) device: JAX's default platform is "gpu"; the card's name and power
      limit (nvidia-smi) are printed before the first time.
  (b) kernel parity at real width: the compiled tile kernel on every ray of
      a 1920x1080 primary frame of ``bench_scene(100_000)``, compared with
      brute force at full f32 precision on a fixed subset of 65,536 rays;
      closest hit at 1M triangles as well.
  (c) main path through ``Renderer``: debug modes 0-6 and two Whitted frames
      (depth 3, 4 lights) at 1920x1080 / 100k triangles, a 480x270 Whitted
      frame compared with the brute-force renderer, four PathTracer
      samples, one 1M-triangle primary frame, and
      ``compiled.memory_analysis()`` of each jitted step.
  (d) --multi: ``render_whitted_multichip`` and ``pathtrace_multichip`` on a
      (tiles=2, samples=2) mesh of four cards against one card.

The last line of stdout is ``{"ok": true, "device": {...}}``.  Without a GPU
(or outside the repository) the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# Parity tolerances (the kernel and brute force evaluate the Woop test in
# different f32 orders, so sliver edges may disagree on a thin fringe; a
# real regression — lost clusters, wrong binning — misses by whole percent).
HIT_AGREE = 0.995  # hit/miss agreement
WINNER_AGREE = 0.99  # same triangle, among rays both call a hit
T_REL = 1e-3  # relative t error ...
T_BAD_FRAC = 0.005  # ... may exceed T_REL on at most this share of rays
SUBSET = 65_536
# Whitted vs brute force: at most 1% of pixels differ by more than 2/255.
PIX_TOL, PIX_BAD_FRAC = 2.0 / 255.0, 0.01
W, H = 1920, 1080

CARD = ""


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str, fn, *args, **kw):
    """Run ``fn`` to completion; print its wall time beside the card."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    log(f"  [{CARD}] {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_device(n_cards: int) -> None:
    global CARD
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"default platform is {devs[0].platform!r}, not 'gpu'")
    check(len(devs) >= n_cards, f"need {n_cards} cards, found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    for ln in lines:
        log(ln)
    CARD = lines[0]
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")


def _primary_rays(scene):
    from directx_raytracer.ops.rays import generate_rays_tiled, pick_tile

    pos, rot = scene.camera.snapshot()
    th, tw = pick_tile(H, W)
    return generate_rays_tiled(jnp.asarray(pos), jnp.asarray(rot), W, H,
                               th, tw)


def _compare_hits(label, got, ref):
    g_hit, r_hit = np.asarray(got.tri >= 0), np.asarray(ref.tri >= 0)
    hit_agree = float((g_hit == r_hit).mean())
    both = g_hit & r_hit
    same = np.asarray(got.tri)[both] == np.asarray(ref.tri)[both]
    winner = float(same.mean()) if both.any() else 1.0
    rel = (np.abs(np.asarray(got.t)[both] - np.asarray(ref.t)[both])
           / np.maximum(np.asarray(ref.t)[both], 1e-6))
    t_bad = float((rel > T_REL).mean()) if both.any() else 0.0
    log(f"  {label}: hit/miss {hit_agree:.5f} (>= {HIT_AGREE}), winner "
        f"{winner:.5f} (>= {WINNER_AGREE}), t err > {T_REL} on {t_bad:.5f} "
        f"(<= {T_BAD_FRAC}); hits {float(r_hit.mean()):.3f}")
    check(r_hit.mean() > 0.1, f"{label}: vacuous, few hits")
    check(hit_agree >= HIT_AGREE, f"{label}: hit/miss agreement {hit_agree}")
    check(winner >= WINNER_AGREE, f"{label}: winner agreement {winner}")
    check(t_bad <= T_BAD_FRAC, f"{label}: t mismatch on {t_bad}")


def phase_parity(n_tris: int, anyhit: bool) -> None:
    from directx_raytracer import testscenes
    from directx_raytracer.bvh import build_bvh
    from directx_raytracer.bvh.pallas_intersect import (intersect_pallas,
                                                            occluded_pallas)
    from directx_raytracer.models.scene import build_device_scene
    from directx_raytracer.ops.intersect import (intersect_bruteforce,
                                                     occluded_bruteforce)

    scene = testscenes.bench_scene(n_tris=n_tris, width=W, height=H)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    o, dd = _primary_rays(scene)
    idx = jnp.asarray(np.arange(SUBSET) * (o.shape[0] // SUBSET))
    hit = timed(f"{n_tris} tris: kernel closest hit, {o.shape[0]} rays "
                "(incl. compile)", intersect_pallas, o, dd, bvh.clusters,
                bvh.wplanar, refine=True)
    hit = timed(f"{n_tris} tris: kernel closest hit, {o.shape[0]} rays",
                intersect_pallas, o, dd, bvh.clusters, bvh.wplanar,
                refine=True)
    so, sd = o[idx], dd[idx]
    ref = timed(f"{n_tris} tris: brute force, {SUBSET} rays (incl. compile)",
                intersect_bruteforce, so, sd, d.geometry.woop)
    sub = jax.tree.map(lambda x: x[idx], hit)
    _compare_hits(f"{n_tris} closest", sub, ref)
    if not anyhit:
        return
    # Shadow-style bound: half the hit rays end before their first hit.
    t_hit = np.asarray(ref.t)[np.asarray(ref.tri >= 0)]
    t_max = jnp.full((o.shape[0],), float(np.median(t_hit)), jnp.float32)
    occ = timed(f"{n_tris} tris: kernel any hit, {o.shape[0]} rays "
                "(incl. compile)", occluded_pallas, o, dd, bvh.clusters,
                bvh.wplanar, t_max)
    occ = timed(f"{n_tris} tris: kernel any hit, {o.shape[0]} rays",
                occluded_pallas, o, dd, bvh.clusters, bvh.wplanar, t_max)
    occ_ref = occluded_bruteforce(so, sd, d.geometry.woop, t_max[idx])
    agree = float((np.asarray(occ)[np.asarray(idx)]
                   == np.asarray(occ_ref)).mean())
    log(f"  {n_tris} any hit: agreement {agree:.5f} (>= {HIT_AGREE}); "
        f"occluded {float(np.asarray(occ_ref).mean()):.3f}")
    check(agree >= HIT_AGREE, f"any-hit agreement {agree}")


def _memory(label, jitted, *args, **kw):
    mem = jitted.lower(*args, **kw).compile().memory_analysis()
    if mem is None:
        log(f"  {label}: memory analysis unavailable")
        return
    log(f"  {label}: args {mem.argument_size_in_bytes / 2**20:.1f} MiB, "
        f"out {mem.output_size_in_bytes / 2**20:.1f} MiB, "
        f"temp {mem.temp_size_in_bytes / 2**20:.1f} MiB")


def phase_renderer() -> None:
    from directx_raytracer import testscenes
    from directx_raytracer.render import render_whitted
    from directx_raytracer.render.debug import render_debug
    from directx_raytracer.render.pathtrace import (PathTracer,
                                                        pathtrace_sample)
    from directx_raytracer.render.renderer import Renderer

    r = Renderer(testscenes.bench_scene(n_tris=100_000, width=W, height=H))
    check(r.method == "kernel", f"Renderer chose {r.method!r}, not 'kernel'")
    for mode in range(7):
        img = timed(f"debug mode {mode} 1080p (first call compiles)",
                    r.render_frame, mode)
        img = timed(f"debug mode {mode} 1080p", r.render_frame, mode)
        check(np.isfinite(np.asarray(img)).all(), f"mode {mode} not finite")
    img, stats = timed("whitted depth 3 1080p (incl. compile)",
                       r.render_whitted_frame, 3)
    img, stats = timed("whitted depth 3 1080p", r.render_whitted_frame, 3)
    check(np.isfinite(np.asarray(img)).all(), "whitted frame not finite")
    log(f"  whitted wavefront alive {np.asarray(stats['alive']).tolist()}, "
        f"dropped {np.asarray(stats['dropped']).tolist()}")

    pos, rot = r.camera.snapshot()
    small = dict(width=480, height=270, max_depth=3)
    got, _ = timed("whitted 480x270 kernel (incl. compile)", render_whitted,
                   r.dscene, pos, rot, intersect_fn=r.intersect_fn,
                   occluder_factory=r.occluder_factory, **small)
    ref, _ = timed("whitted 480x270 brute force (incl. compile)",
                   render_whitted, r.dscene, pos, rot, **small)
    bad = float((np.abs(np.asarray(got) - np.asarray(ref))
                 > PIX_TOL).any(-1).mean())
    log(f"  whitted 480x270 vs brute force: {bad:.5f} of pixels differ by "
        f"> 2/255 (<= {PIX_BAD_FRAC})")
    check(bad <= PIX_BAD_FRAC, f"whitted differs on {bad:.2%} of pixels")

    pt = PathTracer(r.dscene, W, H, max_depth=4, intersect_fn=r.intersect_fn,
                    occluder_factory=r.occluder_factory, seed=1)
    p32, r32 = jnp.asarray(pos, jnp.float32), jnp.asarray(rot, jnp.float32)
    timed("path tracer sample 1080p (incl. compile)", pt.step, p32, r32)
    timed("path tracer 3 samples 1080p", pt.step, p32, r32, 3)
    pt_img = np.asarray(pt.image())
    check(pt.n_samples == 4 and np.isfinite(pt_img).all(),
          "path-traced image not finite")
    check(pt_img.mean() > 1e-3, "no light reached the path-traced film")

    log("  memory analysis of the jitted steps (100k, 1080p):")
    dbg = dict(width=W, height=H, intersect_fn=r.intersect_fn)
    _memory("render_debug modes 0-3", render_debug, r.dscene, pos, rot,
            jnp.int32(0), fetch_record=True, **dbg)
    _memory("render_debug modes 4-6", render_debug, r.dscene, pos, rot,
            jnp.int32(5), fetch_record=False, **dbg)
    _memory("render_whitted depth 3", render_whitted, r.dscene, pos, rot,
            width=W, height=H, max_depth=3, intersect_fn=r.intersect_fn,
            occluder_factory=r.occluder_factory)
    _memory("pathtrace_sample depth 4", pathtrace_sample, r.dscene, p32, r32,
            jax.random.PRNGKey(0), W, H, 4, r.intersect_fn,
            r.occluder_factory)

    big = Renderer(testscenes.bench_scene(n_tris=1_000_000, width=W,
                                          height=H))
    check(big.method == "kernel", f"1M Renderer chose {big.method!r}")
    img = timed("1M tris primary frame, mode 5 (incl. compile)",
                big.render_frame, 5)
    img = timed("1M tris primary frame, mode 5", big.render_frame, 5)
    check(np.isfinite(np.asarray(img)).all(), "1M frame not finite")
    bpos, brot = big.camera.snapshot()
    _memory("render_debug 1M modes 4-6", render_debug, big.dscene, bpos,
            brot, jnp.int32(5), width=W, height=H,
            intersect_fn=big.intersect_fn, fetch_record=False)


def phase_multi() -> None:
    from directx_raytracer import testscenes
    from directx_raytracer.parallel import (make_mesh,
                                                pathtrace_multichip,
                                                render_whitted_multichip)
    from directx_raytracer.parallel.sharding import untile_multichip
    from directx_raytracer.render import render_whitted
    from directx_raytracer.render.pathtrace import PathTracer
    from directx_raytracer.render.renderer import Renderer

    r = Renderer(testscenes.bench_scene(n_tris=100_000, width=W, height=H))
    check(r.method == "kernel", f"Renderer chose {r.method!r}")
    mesh = make_mesh(n_tiles=2, n_samples=2, devices=jax.devices()[:4])
    pos, rot = r.camera.snapshot()
    fns = dict(intersect_fn=r.intersect_fn, occluder_factory=r.occluder_factory)
    multi, _ = timed("whitted 1080p spp 4, 4 cards (incl. compile)",
                     render_whitted_multichip, r.dscene, pos, rot, W, H, mesh,
                     max_depth=3, spp=4, **fns)
    multi, _ = timed("whitted 1080p spp 4, 4 cards", render_whitted_multichip,
                     r.dscene, pos, rot, W, H, mesh, max_depth=3, spp=4, **fns)
    one, _ = timed("whitted 1080p spp 4, 1 card (incl. compile)",
                   render_whitted, r.dscene, pos, rot, W, H, max_depth=3,
                   spp=4, **fns)
    one, _ = timed("whitted 1080p spp 4, 1 card", render_whitted, r.dscene,
                   pos, rot, W, H, max_depth=3, spp=4, **fns)
    bad = float((np.abs(np.asarray(multi) - np.asarray(one))
                 > PIX_TOL).any(-1).mean())
    log(f"  whitted 4 cards vs 1 card: {bad:.6f} of pixels differ by > 2/255"
        f" (<= {PIX_BAD_FRAC})")
    check(bad <= PIX_BAD_FRAC, f"multichip whitted differs on {bad:.2%}")

    spp = 8
    p32, r32 = jnp.asarray(pos, jnp.float32), jnp.asarray(rot, jnp.float32)
    acc = timed(f"path tracer {spp} spp 1080p, 4 cards (incl. compile)",
                pathtrace_multichip, r.dscene, p32, r32, jax.random.key(0), W,
                H, mesh, spp=spp, max_depth=4, **fns)
    acc = timed(f"path tracer {spp} spp 1080p, 4 cards", pathtrace_multichip,
                r.dscene, p32, r32, jax.random.key(1), W, H, mesh, spp=spp,
                max_depth=4, **fns)
    multi_pt = np.asarray(untile_multichip(acc, W, H, 2)) / spp
    pt = PathTracer(r.dscene, W, H, max_depth=4, seed=3, **fns)
    timed(f"path tracer {spp} spp 1080p, 1 card", pt.step, p32, r32, spp)
    one_pt = np.asarray(pt.image())
    # Independent random streams: compare converged means, not pixels.
    rel = abs(multi_pt.mean() - one_pt.mean()) / one_pt.mean()
    log(f"  path tracer 4 cards vs 1 card: mean radiance {multi_pt.mean():.5f}"
        f" vs {one_pt.mean():.5f} (relative {rel:.4f} <= 0.02)")
    check(np.isfinite(multi_pt).all(), "multichip path tracer not finite")
    check(rel <= 0.02, f"multichip path tracer mean off by {rel:.2%}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (d)")
    args = ap.parse_args(argv)
    n_cards = 4 if args.multi else 1
    try:
        phase_device(n_cards)
    except Exception:  # noqa: BLE001 — report and stop: nothing else can run
        traceback.print_exc()
        log("FAILED: (a) device")
        return 2
    from directx_raytracer.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    if args.multi:
        phases = [("(d) four cards", phase_multi)]
    else:
        phases = [("(b) parity 100k", lambda: phase_parity(100_000, True)),
                  ("(b) parity 1M", lambda: phase_parity(1_000_000, False)),
                  ("(c) renderer", phase_renderer)]
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 — every phase reports
            traceback.print_exc()
            failed.append(name)
            log(f"FAILED: {name}")
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
