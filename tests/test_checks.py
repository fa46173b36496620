"""DXRT_CHECK=1 debug build: checkify guards catch NaN / OOB corruption
(SURVEY §5 sanitizer row; the D3D12-debug-layer analog)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify

from directx_raytracer import testscenes
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.render import render_whitted, render_whitted_checked
from directx_raytracer.utils import checks


@pytest.fixture(autouse=True)
def _armed(monkeypatch):
    monkeypatch.setenv("DXRT_CHECK", "1")
    assert checks.enabled()


@pytest.fixture(scope="module")
def small_scene():
    scene = testscenes.cornell_box(64, 48)
    return scene, build_device_scene(scene)


def test_clean_render_passes(small_scene):
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted_checked(d, pos, rot, 64, 48, max_depth=2)
    assert np.isfinite(np.asarray(img)).all()


def test_checked_matches_unchecked(small_scene, monkeypatch):
    scene, d = small_scene
    pos, rot = scene.camera.snapshot()
    got, _ = render_whitted_checked(d, pos, rot, 64, 48, max_depth=2)
    monkeypatch.setenv("DXRT_CHECK", "0")
    ref, _ = render_whitted(d, pos, rot, 64, 48, max_depth=2)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)


def test_seeded_nan_is_caught(small_scene):
    scene, d = small_scene
    # Corrupt a light intensity: NaN flows through direct lighting into the
    # framebuffer contribution of every lit diffuse hit.
    bad_lights = dataclasses.replace(
        d.lights, intensity=d.lights.intensity.at[0].set(jnp.nan)
    ) if dataclasses.is_dataclass(d.lights) else None
    if bad_lights is None:
        d2 = d
        d2.lights.intensity = d.lights.intensity.at[0].set(jnp.nan)
    else:
        d2 = dataclasses.replace(d, lights=bad_lights)
    pos, rot = scene.camera.snapshot()
    with pytest.raises(checkify.JaxRuntimeError, match="non-finite"):
        render_whitted_checked(d2, pos, rot, 64, 48, max_depth=2)


def test_pathtracer_checked_step(small_scene):
    from directx_raytracer.render.pathtrace import PathTracer

    scene, d = small_scene
    pt = PathTracer(d, 48, 32, max_depth=2)
    pos, rot = scene.camera.snapshot()
    pt.step(pos, rot, n=1)  # clean scene: guards pass
    assert np.isfinite(np.asarray(pt.image())).all()
