"""Frame times of the main rendering path on one NVIDIA GPU.

    python bench.py [--method kernel|clustered] [--frames N]

On ``testscenes.bench_scene`` at 1920x1080 (the reference's fixed dispatch,
DXRTRenderer.cpp:1348-1350) it times

* primary rays at 100k triangles (debug mode 5: closest hit + distance
  shade), as ms per frame and Mrays/s;
* one Whitted frame (depth 3, 4 lights) at 100k triangles;
* primary rays at 1M triangles.

Each number is the median over ``--frames`` calls, each ended by
``block_until_ready``, after a warm-up call that compiles.  ``--method``
overrides the platform's intersection path (``bvh.intersect_method``) to
time the XLA clustered walker against the tile kernel.

Before timing, the intersection path is compared with brute force on a
small scene.  The device (platform, kind, count) and the card's name and
power limit are printed first; the last line of stdout is one JSON object.
A platform other than the GPU, a failed check or any error exits non-zero
and prints no result.  No peak rate is assumed for any device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

WIDTH, HEIGHT = 1920, 1080


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, frames: int) -> float:
    """Median wall time of ``fn()`` over ``frames`` calls, after one
    warm-up call (which compiles)."""
    jax.block_until_ready(fn())
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def kernel_check(method: str) -> None:
    """The intersection path vs brute force on a small scene (hit/miss and
    winner agreement, as in chip_smoke.py)."""
    from directx_raytracer import testscenes
    from directx_raytracer.bvh import build_bvh, make_bvh_intersect_fn
    from directx_raytracer.models.scene import build_device_scene
    from directx_raytracer.ops.intersect import intersect_bruteforce
    from directx_raytracer.ops.rays import generate_rays_tiled

    scene = testscenes.bench_scene(n_tris=3_000, width=128, height=64)
    d = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    o, dd = generate_rays_tiled(pos, rot, 128, 64, 8, 32)
    bvh = build_bvh(d.geometry)
    got = make_bvh_intersect_fn(bvh, method)(o, dd, d.geometry)
    ref = intersect_bruteforce(o, dd, d.geometry.woop)
    g_hit, r_hit = np.asarray(got.tri >= 0), np.asarray(ref.tri >= 0)
    both = g_hit & r_hit
    hit_agree = float((g_hit == r_hit).mean())
    winner = float((np.asarray(got.tri)[both] == np.asarray(ref.tri)[both]).mean())
    if hit_agree < 0.995 or winner < 0.99:
        raise SystemExit(f"kernel check FAILED: hit/miss {hit_agree}, "
                         f"winner {winner}")


def scene_setup(n_tris: int, method: str | None):
    from directx_raytracer import testscenes
    from directx_raytracer.bvh import (build_bvh, intersect_method,
                                       make_bvh_intersect_fn,
                                       make_bvh_occluder_factory)
    from directx_raytracer.models.scene import build_device_scene

    scene = testscenes.bench_scene(n_tris=n_tris, width=WIDTH, height=HEIGHT)
    d = build_device_scene(scene)
    method = method or intersect_method(d.geometry.n_tris)
    bvh = build_bvh(d.geometry)
    d.geometry.accel = bvh  # a jit argument, not a closure constant
    pos, rot = (jnp.asarray(x, jnp.float32) for x in scene.camera.snapshot())
    return (d, pos, rot, make_bvh_intersect_fn(bvh, method),
            make_bvh_occluder_factory(bvh, method), method)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=("kernel", "clustered"),
                    help="intersection path (default: the platform's)")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args(argv)

    devs = jax.devices()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs)}
    log(f"device {device}")
    if device["platform"] != "gpu":
        log("no GPU: nothing to measure")
        return 2
    card = card_name_and_power()
    log(f"card {card}")

    from directx_raytracer.render import render_whitted
    from directx_raytracer.render.debug import render_debug
    from directx_raytracer.utils.compile_cache import enable_compile_cache

    log(f"compile cache {enable_compile_cache()}")
    out = {"device": device, "card": card, "frames": args.frames}

    d, pos, rot, ifn, occf, method = scene_setup(100_000, args.method)
    out["method"] = method
    log(f"kernel check ({method})")
    kernel_check(method)
    n_rays = WIDTH * HEIGHT
    mode = jnp.int32(5)

    def primaries(d, pos, rot, ifn):
        return lambda: render_debug(d, pos, rot, mode, WIDTH, HEIGHT,
                                    intersect_fn=ifn, fetch_record=False)

    log("primaries, 100k triangles")
    ms = median_ms(primaries(d, pos, rot, ifn), args.frames)
    out["primary_100k_ms"] = ms
    out["primary_100k_mrays"] = n_rays / ms / 1e3
    log("whitted depth 3, 100k triangles")
    out["whitted_100k_ms"] = median_ms(
        lambda: render_whitted(d, pos, rot, WIDTH, HEIGHT, max_depth=3,
                               intersect_fn=ifn, occluder_factory=occf)[0],
        args.frames)

    del d, ifn, occf
    log("primaries, 1M triangles")
    d, pos, rot, ifn, _, _ = scene_setup(1_000_000, args.method)
    ms = median_ms(primaries(d, pos, rot, ifn), args.frames)
    out["primary_1m_ms"] = ms
    out["primary_1m_mrays"] = n_rays / ms / 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
