"""The compiled tile kernel and full frames on an NVIDIA GPU.

Every test here is marked ``gpu``: it skips on other platforms and runs on
the card with ``python -m pytest tests -m gpu -p no:xdist``.  The same
kernel code runs in the interpreter on every CPU run
(test_pallas_interpret.py); these tests catch what only the GPU compiler and
its f32 arithmetic can change.  Tolerances: the kernel and brute force
evaluate the Woop test in different f32 orders, so sliver edges may disagree
on a thin fringe; a real regression (lost clusters, wrong binning) misses by
whole percent.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from directx_raytracer import testscenes
from directx_raytracer.bvh import (
    build_bvh,
    intersect_method,
    make_bvh_intersect_fn,
    make_bvh_occluder_factory,
)
from directx_raytracer.bvh.pallas_intersect import (
    intersect_pallas,
    occluded_pallas,
)
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.ops.intersect import (
    intersect_bruteforce,
    occluded_bruteforce,
)
from directx_raytracer.ops.rays import generate_rays_tiled

pytestmark = pytest.mark.gpu

W, H = 192, 96


@pytest.fixture(scope="module")
def scene_geo():
    scene = testscenes.bench_scene(n_tris=20_000, width=W, height=H)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    pos, rot = scene.camera.snapshot()
    return scene, d, bvh, generate_rays_tiled(pos, rot, W, H, 8, 32)


def test_platform_takes_the_kernel():
    assert intersect_method(100_000) == "kernel"


def test_closest_matches_bruteforce(scene_geo):
    _, d, bvh, (o, dd) = scene_geo
    ref = intersect_bruteforce(o, dd, d.geometry.woop)
    got = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar, refine=True)
    g_hit, r_hit = np.asarray(got.tri >= 0), np.asarray(ref.tri >= 0)
    assert r_hit.mean() > 0.1, "vacuous: few hits"
    assert (g_hit == r_hit).mean() >= 0.995
    both = g_hit & r_hit
    assert (np.asarray(got.tri)[both] == np.asarray(ref.tri)[both]).mean() >= 0.99
    rel = (np.abs(np.asarray(got.t)[both] - np.asarray(ref.t)[both])
           / np.asarray(ref.t)[both])
    assert (rel > 1e-3).mean() <= 0.005


def test_occlusion_matches_bruteforce(scene_geo):
    _, d, bvh, (o, dd) = scene_geo
    t_max = jnp.where(jnp.arange(o.shape[0]) % 3 == 0, 0.0, 25.0)
    ref = np.asarray(occluded_bruteforce(o, dd, d.geometry.woop, t_max))
    got = np.asarray(occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, t_max))
    assert ref.any(), "vacuous: nothing occluded"
    assert not got[::3].any(), "a disarmed shadow ray blocked"
    assert (got == ref).mean() >= 0.995


def test_whitted_frame_matches_bruteforce():
    """A shaded Whitted frame (4 lights, shadows, mirror bounces) through the
    kernel's closest and any hit, against the brute-force renderer."""
    from directx_raytracer.render import render_whitted

    scene = testscenes.bench_scene(n_tris=20_000, width=W, height=H)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    d.geometry.accel = bvh
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted(
        d, pos, rot, W, H, max_depth=3,
        intersect_fn=make_bvh_intersect_fn(bvh, "kernel"),
        occluder_factory=make_bvh_occluder_factory(bvh, "kernel"))
    ref, _ = render_whitted(d, pos, rot, W, H, max_depth=3)
    bad = (np.abs(np.asarray(img) - np.asarray(ref)) > 2 / 255).any(-1)
    assert bad.mean() <= 0.01, f"{bad.mean():.2%} of pixels differ"


def test_pathtracer_converges_on_card():
    """Path-traced samples are finite, light arrives, and the running mean
    converges (fixed seed)."""
    from directx_raytracer.render.pathtrace import PathTracer

    scene = testscenes.cornell_box(64, 64)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    d.geometry.accel = bvh
    pt = PathTracer(d, 64, 64, max_depth=4,
                    intersect_fn=make_bvh_intersect_fn(bvh, "kernel"),
                    occluder_factory=make_bvh_occluder_factory(bvh, "kernel"),
                    seed=3)
    pos, rot = (jnp.asarray(x, jnp.float32) for x in scene.camera.snapshot())
    means = {}
    for target in (2, 8, 16):
        pt.step(pos, rot, n=target - pt.n_samples)
        means[target] = np.asarray(pt.image())
    final = means[16]
    assert np.isfinite(final).all()
    assert final.mean() > 1e-3, "no light reached the film"
    assert np.abs(means[8] - final).mean() < np.abs(means[2] - final).mean()
