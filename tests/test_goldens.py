"""Golden-image regression tests on the reference's shipped asset.

The goldens are self-generated (the reference publishes no images — its
debug modes are the de-facto correctness instrumentation, SURVEY.md §4) and
pinned on the CPU backend, where the hash-based modes are deterministic.
Any change to raygen math, intersection, debug-shade formulas, Whitted
transport, material/light plumbing, Morton ordering or the framebuffer
layout shows up here as pixel drift.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from directx_raytracer.io import crtscene
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.render import render_debug, render_whitted
from directx_raytracer.utils.image import to_u8

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "dragon_192x108.npz")
W, H = 192, 108


@pytest.fixture(scope="module")
def dragon(dragon_path):
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    scene = crtscene.load(dragon_path)
    return scene, build_device_scene(scene), np.load(GOLDENS)


def _diff_frac(a, b, tol=2):
    """Fraction of pixels whose u8 value differs by more than ``tol``."""
    return (np.abs(a.astype(int) - b.astype(int)) > tol).any(axis=-1).mean()


@pytest.mark.parametrize("mode", range(7))
def test_debug_mode_golden(dragon, mode):
    scene, d, gold = dragon
    pos, rot = scene.camera.snapshot()
    img = to_u8(np.asarray(render_debug(d, pos, rot, jnp.int32(mode), W, H)))
    # Tiny drift allowance for compiler-version float jitter on edges.
    assert _diff_frac(img, gold[f"debug{mode}"]) < 0.002


def test_whitted_golden(dragon):
    scene, d, gold = dragon
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted(d, pos, rot, W, H, max_depth=4)
    img = to_u8(np.clip(np.asarray(img), 0, 1))
    assert _diff_frac(img, gold["whitted"]) < 0.002
