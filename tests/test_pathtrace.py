"""Path tracer: convergence toward the Whitted direct term, unbiasedness
smoke checks, checkpoint round-trip."""

import numpy as np
import pytest

from directx_raytracer import testscenes
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.render.pathtrace import PathTracer
from directx_raytracer.render.whitted import render_whitted


@pytest.fixture(scope="module")
def cornell():
    scene = testscenes.cornell_box(48, 36, light_intensity=60.0)
    return scene, build_device_scene(scene)


def test_direct_term_matches_whitted_at_depth1(cornell):
    # depth-1 PT = primary hit + NEE only; on an all-diffuse scene with one
    # light this is exactly the Whitted direct-lighting image (modulo the
    # subpixel jitter -> compare means loosely over many samples).
    scene, d = cornell
    pt = PathTracer(d, 48, 36, max_depth=1, seed=1)
    pos, rot = scene.camera.snapshot()
    pt.step(pos, rot, n=24)
    img_pt = np.asarray(pt.image())
    img_w, _ = render_whitted(d, pos, rot, 48, 36, max_depth=1)
    img_w = np.asarray(img_w)
    lit = img_w.max(axis=-1) > 0.02
    err = np.abs(img_pt - img_w).mean(axis=-1)
    # jittered sampling blurs edges; compare the robust central tendency
    assert np.median(err[lit]) < 0.02

    # Indirect light only ADDS energy: deeper tracing must not darken.
    pt6 = PathTracer(d, 48, 36, max_depth=5, seed=2)
    pt6.step(pos, rot, n=24)
    img6 = np.asarray(pt6.image())
    assert img6.sum() > img_pt.sum() * 0.98


def test_variance_decreases_with_samples(cornell):
    scene, d = cornell
    pos, rot = scene.camera.snapshot()
    a = PathTracer(d, 48, 36, max_depth=3, seed=3).step(pos, rot, n=2)
    b = PathTracer(d, 48, 36, max_depth=3, seed=4).step(pos, rot, n=2)
    few = np.abs(np.asarray(a.image()) - np.asarray(b.image())).mean()
    a2 = PathTracer(d, 48, 36, max_depth=3, seed=5).step(pos, rot, n=16)
    b2 = PathTracer(d, 48, 36, max_depth=3, seed=6).step(pos, rot, n=16)
    many = np.abs(np.asarray(a2.image()) - np.asarray(b2.image())).mean()
    assert many < few  # ~1/sqrt(n) shrinkage

    assert np.isfinite(np.asarray(a.image())).all()


def test_checkpoint_roundtrip(tmp_path, cornell):
    scene, d = cornell
    pos, rot = scene.camera.snapshot()
    pt = PathTracer(d, 48, 36, max_depth=2, seed=7).step(pos, rot, n=3)
    ckpt = str(tmp_path / "state.npz")
    pt.save_state(ckpt)

    resumed = PathTracer(d, 48, 36, max_depth=2, seed=0)
    resumed.load_state(ckpt)
    assert resumed.n_samples == 3
    np.testing.assert_allclose(np.asarray(resumed.image()), np.asarray(pt.image()))

    # Continue sampling after resume: identical to never having stopped.
    pt.step(pos, rot, n=2)
    resumed.step(pos, rot, n=2)
    np.testing.assert_allclose(
        np.asarray(resumed.image()), np.asarray(pt.image()), atol=1e-6
    )

    bad = PathTracer(d, 24, 18, max_depth=2)
    with pytest.raises(ValueError, match="resolution mismatch"):
        bad.load_state(ckpt)


def test_glass_scene_is_finite():
    scene = testscenes.cornell_box(32, 24)
    # make the tall block glass
    from directx_raytracer.models.material import Material, MaterialType

    scene.materials[0] = Material(
        type=MaterialType.REFRACTIVE, ior=1.5,
        albedo=np.ones(3, np.float32), smooth_shading=False,
    )
    d = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    pt = PathTracer(d, 32, 24, max_depth=6, seed=11).step(pos, rot, n=4)
    img = np.asarray(pt.image())
    assert np.isfinite(img).all() and (img >= 0).all()
