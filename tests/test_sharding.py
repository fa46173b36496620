"""Multi-chip sharding tests on the virtual 8-device CPU mesh (conftest sets
--xla_force_host_platform_device_count=8; SURVEY.md §4's fake-multi-device
harness)."""

import jax
import numpy as np
import pytest

from directx_raytracer import testscenes
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.parallel import make_mesh, render_whitted_multichip
from directx_raytracer.render import render_whitted


@pytest.fixture(scope="module")
def cornell():
    scene = testscenes.cornell_box(64, 48)
    return scene, build_device_scene(scene)


def _single_chip(scene, d, **kw):
    img, _ = render_whitted(
        d, scene.camera.position, scene.camera.rotation, 64, 48, **kw
    )
    return np.asarray(img)


def test_tile_sharding_matches_single_chip(cornell):
    scene, d = cornell
    assert jax.device_count() >= 8
    mesh = make_mesh(n_tiles=8)
    img, stats = render_whitted_multichip(
        d, scene.camera.position, scene.camera.rotation, 64, 48, mesh, max_depth=3
    )
    ref = _single_chip(scene, d, max_depth=3)
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)


def test_tile_x_sample_sharding_matches_single_chip(cornell):
    scene, d = cornell
    mesh = make_mesh(n_tiles=2, n_samples=4)
    img, stats = render_whitted_multichip(
        d, scene.camera.position, scene.camera.rotation, 64, 48, mesh,
        max_depth=2, spp=4,
    )
    ref = _single_chip(scene, d, max_depth=2, spp=4)
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)


def test_indivisible_height_pads(cornell):
    """47 rows on an 8-chip tile axis: stripes pad to ceil(47/8)=6 rows and
    the surplus below the frustum is cropped (1080 is
    not divisible by 16/32-chip meshes)."""
    scene, d = cornell
    mesh = make_mesh(n_tiles=8)
    img, _ = render_whitted_multichip(
        d, scene.camera.position, scene.camera.rotation, 64, 47, mesh,
        max_depth=2,
    )
    img2, _ = render_whitted(
        d, scene.camera.position, scene.camera.rotation, 64, 47, max_depth=2
    )
    assert img.shape == (47, 64, 3)
    np.testing.assert_allclose(np.asarray(img), np.asarray(img2), atol=1e-5)


def test_indivisible_spp_pads(cornell):
    """spp=3 on a 2-chip sample axis: the offset table pads with a
    zero-weight dummy sample; the result matches single-chip spp=3."""
    scene, d = cornell
    mesh = make_mesh(n_tiles=4, n_samples=2)
    img, _ = render_whitted_multichip(
        d, scene.camera.position, scene.camera.rotation, 64, 48, mesh,
        max_depth=2, spp=3,
    )
    ref = _single_chip(scene, d, max_depth=2, spp=3)
    # psum order differs from the sequential sum: tolerance covers f32
    # accumulation noise only.
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-4)


def test_spp16_sample_axis_8(cornell):
    """Arbitrary spp (Hammersley set) scales the sample mesh axis past 4
    (spp=16 renders, sharding with n_samples=8)."""
    scene, d = cornell
    mesh = make_mesh(n_tiles=1, n_samples=8)
    img, stats = render_whitted_multichip(
        d, scene.camera.position, scene.camera.rotation, 64, 48, mesh,
        max_depth=2, spp=16,
    )
    ref = _single_chip(scene, d, max_depth=2, spp=16)
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-5)


def test_pathtrace_multichip_converges_like_single_chip():
    import jax
    from directx_raytracer.parallel import pathtrace_multichip, untile_multichip
    from directx_raytracer.render.pathtrace import PathTracer

    scene = testscenes.cornell_box(64, 48, light_intensity=60.0)
    d = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    mesh = make_mesh(n_tiles=4, n_samples=2)
    spp = 16
    acc = pathtrace_multichip(
        d, pos, rot, jax.random.PRNGKey(0), 64, 48, mesh, spp=spp, max_depth=3
    )
    img_mc = np.asarray(untile_multichip(acc / spp, 64, 48, 4))
    assert img_mc.shape == (48, 64, 3)
    assert np.isfinite(img_mc).all() and (img_mc >= 0).all()

    pt = PathTracer(d, 64, 48, max_depth=3, seed=9)
    pt.step(pos, rot, n=spp)
    img_sc = np.asarray(pt.image())
    # Independent RNG streams at 16 spp are individually noisy; block
    # averaging (12x16 pixels) collapses the Monte Carlo error so the two
    # estimators must agree structurally.
    blk = lambda im: im.reshape(4, 12, 4, 16, 3).mean(axis=(1, 3))
    a, b = blk(img_mc), blk(img_sc)
    rel = np.abs(a - b).mean(axis=-1) / (0.5 + b.mean(axis=-1))
    assert rel.max() < 0.2
    # 16 spp with independent RNG streams: the global-mean gap is pure
    # Monte Carlo noise (its scale shifts when the tile-major ray<->pixel
    # mapping, and hence the per-pixel sample streams, changes).
    assert abs(img_mc.mean() - img_sc.mean()) < 0.05


class TestMultihost:
    """DCN-tier hooks (SURVEY.md §5 distributed row) — mesh logic only;
    no cluster on this rig."""

    def test_global_mesh_shape(self):
        from directx_raytracer.parallel import global_mesh_shape

        assert global_mesh_shape(8, 1) == (8, 1)
        assert global_mesh_shape(8, 4) == (2, 4)
        assert global_mesh_shape(8, 3) == (4, 2)  # clamped to a divisor
        assert global_mesh_shape(1, 4) == (1, 1)
        with pytest.raises(ValueError):
            global_mesh_shape(0)

    def test_make_global_mesh_local(self):
        from directx_raytracer.parallel import make_global_mesh

        mesh = make_global_mesh(n_samples=2)
        assert mesh.axis_names == ("tiles", "samples")
        assert mesh.shape["tiles"] * mesh.shape["samples"] == jax.device_count()

    def test_single_process_init_noop(self):
        from directx_raytracer.parallel import init_distributed

        assert init_distributed() == 1
