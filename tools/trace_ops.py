"""Where a frame's device time goes, from a profiler trace.

    python tools/trace_ops.py [--tris 100000] [--out traces]

On ``bench_scene(--tris)`` at 1920x1080 (GPU only) it

1. times each stage of the intersection path on its own (median of 5
   calls, each ended by ``block_until_ready``): cluster binning
   (``bin_clusters_bits``), the rank table, the whole search
   (binning + table + kernel launches) and a primary frame (debug mode 5);
2. traces three primary frames and three Whitted frames (depth 3) with
   ``jax.profiler`` and reduces the trace: for every device line, the
   device time per operation name, summed over the window, and the busy
   share of the window (union of operation intervals over the window).

Binning is one elementwise slab test per (tile, cluster) pair; its least
time is its output bytes (entry distances (T, C) f32 + occupancy words)
over the card's memory bandwidth, which is printed beside the measured
time (3.35 TB/s, the H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

W, H = 1920, 1080
# Device-memory bandwidth by device_kind (NVIDIA data sheets).  A device not
# listed is an error, not a default.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def median_ms(fn, reps=5):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def reduce_trace(trace_dir: str, top: int = 15) -> list[str]:
    """Per device line: busy share of the window and the ``top`` operations
    by summed device time."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            if not events:
                continue
            spans = sorted((e.start_ns, e.end_ns) for e in events)
            lo, hi = spans[0][0], max(e for _, e in spans)
            busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += cur_e - cur_s
            per_op = defaultdict(lambda: [0.0, 0])
            for e in events:
                per_op[e.name][0] += e.duration_ns
                per_op[e.name][1] += 1
            out.append(f"{plane.name} | {line.name}: {len(events)} events, "
                       f"window {(hi - lo) / 1e6:.3f} ms, busy "
                       f"{busy / 1e6:.3f} ms ({busy / max(hi - lo, 1):.4f})")
            for name, (ns, n) in sorted(per_op.items(),
                                        key=lambda kv: -kv[1][0])[:top]:
                out.append(f"    {ns / 1e6:10.3f} ms  x{n:<5d} {name[:110]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tris", type=int, default=100_000)
    ap.add_argument("--out", default="traces",
                    help="directory for the profiler traces")
    args = ap.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform!r})", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)

    from directx_raytracer import testscenes
    from directx_raytracer.bvh import (build_bvh, make_bvh_intersect_fn,
                                       make_bvh_occluder_factory)
    from directx_raytracer.bvh import pallas_intersect as pi
    from directx_raytracer.models.scene import build_device_scene
    from directx_raytracer.ops.rays import generate_rays_tiled
    from directx_raytracer.render import render_whitted
    from directx_raytracer.render.debug import render_debug
    from directx_raytracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    scene = testscenes.bench_scene(n_tris=args.tris, width=W, height=H)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    d.geometry.accel = bvh
    pos, rot = (jnp.asarray(x, jnp.float32) for x in scene.camera.snapshot())
    o, dd = generate_rays_tiled(pos, rot, W, H, 8, 32)
    tiles = o.shape[0] // pi.TILE_R
    ot, dt = o.reshape(tiles, pi.TILE_R, 3), dd.reshape(tiles, pi.TILE_R, 3)
    cs = bvh.clusters
    c = cs.aabb_min.shape[0]
    t_init = jnp.full((o.shape[0],), 1e4, jnp.float32)
    print(f"{args.tris} triangles, {c} clusters, {tiles} tiles of "
          f"{pi.TILE_R} rays", flush=True)

    binning = jax.jit(pi.bin_clusters_bits)
    words, cum, entry, counts = jax.block_until_ready(binning(ot, dt, cs))
    table = jax.jit(pi.rank_table_bits, static_argnums=2)
    ifn = make_bvh_intersect_fn(bvh, "kernel")
    occf = make_bvh_occluder_factory(bvh, "kernel")
    mode = jnp.int32(5)

    def frame():
        return render_debug(d, pos, rot, mode, W, H, intersect_fn=ifn,
                            fetch_record=False)

    def whitted():
        return render_whitted(d, pos, rot, W, H, max_depth=3,
                              intersect_fn=ifn, occluder_factory=occf)[0]

    n = np.asarray(counts)
    print(f"clusters per tile: mean {n.mean():.2f}, p99 "
          f"{np.percentile(n, 99):.0f}, max {n.max()}; tiles past the "
          f"rank table: {(n > pi.RANK_CAP).mean():.5f}", flush=True)
    bin_ms = median_ms(lambda: binning(ot, dt, cs))
    out_bytes = entry.size * 4 + words.size * 4 * 2 + counts.size * 4
    floor_ms = out_bytes / HBM_BYTES_PER_S[dev.device_kind] * 1e3
    print(f"[{card}] binning: {bin_ms:.4f} ms; output {out_bytes / 1e6:.1f} MB"
          f", memory floor {floor_ms:.4f} ms ({floor_ms / bin_ms:.4f} of it)",
          flush=True)
    print(f"[{card}] rank table: "
          f"{median_ms(lambda: table(words, cum, pi.RANK_CAP)):.4f} ms",
          flush=True)
    print(f"[{card}] search (binning + table + kernel): " + "%.4f ms" % median_ms(
        lambda: pi._search(o, dd, t_init, cs, bvh.wplanar, anyhit=False)),
        flush=True)
    print(f"[{card}] primary frame, mode 5: {median_ms(frame):.4f} ms",
          flush=True)
    print(f"[{card}] whitted frame, depth 3: {median_ms(whitted, 3):.4f} ms",
          flush=True)

    for label, fn in (("primary", frame), ("whitted", whitted)):
        trace_dir = os.path.join(args.out, label)
        with jax.profiler.trace(trace_dir):
            for _ in range(3):
                jax.block_until_ready(fn())
        print(f"--- trace of 3 {label} frames ({trace_dir})")
        for ln in reduce_trace(trace_dir):
            print(ln)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
