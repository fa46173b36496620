"""End-to-end debug-mode rendering (SURVEY §2b closestHit + miss semantics)."""

import jax.numpy as jnp
import numpy as np

from directx_raytracer import testscenes
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.ops.debug_shading import MISS_COLOR, NUM_MODES
from directx_raytracer.render.debug import render_debug


def _render(scene, mode, w=64, h=48):
    ds = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    img = render_debug(ds, pos, rot, jnp.int32(mode), w, h)
    return np.asarray(img)


def test_miss_is_cyan_not_background():
    """miss shader returns (0,1,1) regardless of settings.background_color
    (hlsl:72-76) — the reference never uses the parsed background."""
    scene = testscenes.single_triangle()
    img = _render(scene, 0)
    corner = img[0, 0]
    np.testing.assert_allclose(corner, MISS_COLOR, atol=1e-6)


def test_center_hits_triangle():
    scene = testscenes.single_triangle()
    img = _render(scene, 5, w=65, h=49)
    center = img[24, 32]
    # camera at z=2, triangle at z=0 -> t = 2, c = saturate(2*0.05) = 0.1
    np.testing.assert_allclose(center, [0.1, 0.1, 0.1], atol=1e-4)


def test_barycentric_mode_sums_to_one():
    scene = testscenes.single_triangle()
    img = _render(scene, 3)
    hits = ~np.all(np.isclose(img, MISS_COLOR, atol=1e-5), axis=-1)
    assert hits.sum() > 50
    sums = img[hits].sum(axis=-1)
    np.testing.assert_allclose(sums, 1.0, atol=1e-4)
    assert np.all(img[hits] >= -1e-5)


def test_height_gradient_mode():
    scene = testscenes.single_triangle()
    img = _render(scene, 4, w=65, h=49)
    # triangle spans y in [-1, 1]; h = (y+10)/20 in [0.45, 0.55]
    hits = ~np.all(np.isclose(img, MISS_COLOR, atol=1e-5), axis=-1)
    lo = np.array([0.1, 0.2, 0.6])
    hi = np.array([0.9, 0.9, 0.9])
    hmin, hmax = 0.44, 0.56
    expect_min = lo * (1 - hmin) + hi * hmin
    expect_max = lo * (1 - hmax) + hi * hmax
    assert np.all(img[hits] >= np.minimum(expect_min, expect_max) - 1e-3)
    assert np.all(img[hits] <= np.maximum(expect_min, expect_max) + 1e-3)


def test_world_checker_mode():
    """Mode 6: c = ((floor(x) ^ floor(z)) & 1) ? 0.9 : 0.2 on a ground plane."""
    scene = testscenes.cornell_box()
    ds = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    img = np.asarray(render_debug(ds, pos, rot, jnp.int32(6), 64, 48))
    vals = np.unique(np.round(img, 4))
    for v in vals:
        assert v in (0.2, 0.9) or np.isclose(v, 0.0) or np.isclose(v, 1.0)


def test_all_modes_render_and_differ():
    scene = testscenes.cornell_box()
    ds = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    imgs = [np.asarray(render_debug(ds, pos, rot, jnp.int32(m), 32, 24))
            for m in range(NUM_MODES)]
    for img in imgs:
        assert img.shape == (24, 32, 3)
        assert np.all(np.isfinite(img))
    # pairwise distinct (procedural modes shouldn't coincide)
    for i in range(NUM_MODES):
        for j in range(i + 1, NUM_MODES):
            assert not np.allclose(imgs[i], imgs[j]), (i, j)


def test_per_triangle_colors_constant_within_triangle():
    scene = testscenes.single_triangle()
    img = _render(scene, 0)
    hits = ~np.all(np.isclose(img, MISS_COLOR, atol=1e-5), axis=-1)
    colors = img[hits]
    assert np.allclose(colors, colors[0], atol=1e-6)  # one tri -> one color
