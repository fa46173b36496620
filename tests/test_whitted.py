"""Whitted renderer tests: shadows, mirrors, dielectrics, textures, AA.

The reference parses all of this but never runs it (SURVEY.md facts 1-2), so
these tests check against analytic expectations of the Chaos-course shading
model rather than reference images.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from directx_raytracer.models.light import Light
from directx_raytracer.models.material import Material, MaterialType
from directx_raytracer.models.mesh import Mesh
from directx_raytracer.models.scene import Scene, SceneSettings, build_device_scene
from directx_raytracer.models.camera import Camera
from directx_raytracer.render.whitted import render_whitted
from directx_raytracer import testscenes

FOUR_PI = 4.0 * np.pi


def _mesh(vertices, triangles, material_index=0):
    m = Mesh(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        indices=np.asarray(triangles, np.int32).reshape(-1),
        material_index=material_index,
    )
    m.calculate_vertex_normals()
    return m


def _render(scene, w, h, **kw):
    d = build_device_scene(scene)
    img, stats = render_whitted(
        d, scene.camera.position, scene.camera.rotation, w, h, **kw
    )
    return np.asarray(img), stats


def _floor_scene(mtype=MaterialType.DIFFUSE, albedo=(0.5, 0.5, 0.5), lights=None):
    """A big ground plane at y=0 viewed from above-ish."""
    scene = Scene()
    scene.settings = SceneSettings(background_color=np.array([0.0, 0.0, 0.0], np.float32))
    scene.camera = Camera(position=(0.0, 2.0, 0.0))
    scene.camera.rotate(0.0, 89.0)  # view = -forward, so +pitch looks down
    scene.meshes.append(
        _mesh([[-50, 0, 50], [50, 0, 50], [-50, 0, -50], [50, 0, -50]], [0, 1, 2, 3, 2, 1])
    )
    scene.materials.append(Material(type=mtype, albedo=np.array(albedo, np.float32)))
    for l in lights or [Light(position=np.array([0, 3, 0], np.float32), intensity=100.0)]:
        scene.lights.append(l)
    return scene


class TestDiffuse:
    def test_analytic_point_light(self):
        # Plane at y=0, camera looking straight down from (0,2,0), light at
        # (0,3,0) i=100: center pixel hits ~(0,0,0); n.l=1, r=3.
        scene = _floor_scene()
        img, _ = _render(scene, 33, 33, max_depth=2)
        expected = 0.5 * 100.0 / (FOUR_PI * 9.0)
        center = img[16, 16]
        np.testing.assert_allclose(center, expected, rtol=2e-2)

    def test_shadow_ray_occlusion(self):
        # A small occluder between the light and part of the floor darkens it.
        scene = _floor_scene()
        # quad hovering at y=1.5 over x,z in [0.2, 1.4] blocks light for
        # floor points directly underneath (light straight above at 3).
        scene.meshes.append(
            _mesh(
                [[0.2, 1.5, 1.4], [1.4, 1.5, 1.4], [0.2, 1.5, 0.2], [1.4, 1.5, 0.2]],
                [0, 1, 2, 3, 2, 1],
                material_index=0,
            )
        )
        img, _ = _render(scene, 65, 65, max_depth=2)
        # Camera looks down -y; +x is to the right, +z toward the bottom of
        # the image.  The shadowed floor region maps to lower-right quadrant.
        lit = img[32, 10]     # left of center: unshadowed floor
        shaded = img[45, 45]  # lower-right: under the occluder
        assert shaded.max() <= 1e-5
        assert lit.min() > 0.1 * lit.max() and lit.max() > 0.2

    def test_background_on_miss(self):
        scene = Scene()
        scene.settings = SceneSettings(background_color=np.array([0.1, 0.5, 0.9], np.float32))
        scene.camera = Camera(position=(0.0, 0.0, 5.0))
        img, _ = _render(scene, 8, 8, max_depth=2)
        np.testing.assert_allclose(img, np.broadcast_to([0.1, 0.5, 0.9], img.shape), atol=1e-6)


class TestConstant:
    def test_flat_albedo_ignores_lights(self):
        scene = _floor_scene(mtype=MaterialType.CONSTANT, albedo=(0.3, 0.6, 0.9))
        img, _ = _render(scene, 17, 17, max_depth=2)
        np.testing.assert_allclose(img[8, 8], [0.3, 0.6, 0.9], atol=1e-6)


class TestReflective:
    def test_mirror_reflects_background_tinted(self):
        # Mirror floor, nothing else: reflection ray hits the background; the
        # pixel is albedo * background.
        scene = _floor_scene(mtype=MaterialType.REFLECTIVE, albedo=(0.8, 0.4, 0.2))
        scene.settings.background_color = np.array([1.0, 1.0, 1.0], np.float32)
        img, _ = _render(scene, 17, 17, max_depth=3)
        np.testing.assert_allclose(img[8, 8], [0.8, 0.4, 0.2], rtol=1e-5)

    def test_mirror_sees_constant_object(self):
        # Mirror floor + constant-red ceiling: floor pixels show red * albedo.
        scene = _floor_scene(mtype=MaterialType.REFLECTIVE, albedo=(1.0, 1.0, 1.0))
        scene.meshes.append(
            _mesh([[-50, 4, 50], [50, 4, 50], [-50, 4, -50], [50, 4, -50]],
                  [0, 1, 2, 1, 3, 2], material_index=1)
        )
        scene.materials.append(
            Material(type=MaterialType.CONSTANT, albedo=np.array([1.0, 0.0, 0.0], np.float32))
        )
        img, _ = _render(scene, 17, 17, max_depth=3)
        np.testing.assert_allclose(img[8, 8], [1.0, 0.0, 0.0], atol=1e-5)

    def test_depth_exhaustion_shades_diffuse(self):
        # max_depth=1: the mirror's first hit is the last pass, shaded diffuse.
        scene = _floor_scene(mtype=MaterialType.REFLECTIVE, albedo=(0.8, 0.8, 0.8))
        img, _ = _render(scene, 9, 9, max_depth=1)
        expected = 0.8 * 100.0 / (FOUR_PI * 9.0)
        np.testing.assert_allclose(img[4, 4], expected, rtol=3e-2)


class TestRefractive:
    def test_glass_slab_transmits_plus_reflects(self):
        # Glass floor over a constant blue plane, white background above.
        # Straight-down center ray: transmitted weight (1-F)^2 hits blue,
        # Fresnel reflections pick up white background.
        scene = _floor_scene(mtype=MaterialType.REFRACTIVE)
        scene.materials[0].ior = 1.5
        scene.settings.background_color = np.array([1.0, 1.0, 1.0], np.float32)
        scene.meshes.append(
            _mesh([[-50, -2, 50], [50, -2, 50], [-50, -2, -50], [50, -2, -50]],
                  [0, 1, 2, 3, 2, 1], material_index=1)
        )
        scene.materials.append(
            Material(type=MaterialType.CONSTANT, albedo=np.array([0.0, 0.0, 1.0], np.float32))
        )
        img, _ = _render(scene, 9, 9, max_depth=6)
        center = img[4, 4]
        # Normal-incidence Fresnel for ior 1.5: F0 = 0.04.
        f0 = ((1.5 - 1.0) / (1.5 + 1.0)) ** 2
        # Blue channel: transmitted (1-F)^2 * 1 + reflected F * 1 (background
        # blue) + higher-order terms; Red: only reflected-background terms.
        assert center[2] > (1 - f0) ** 2 - 0.02
        assert 0.0 < center[0] < 3 * f0 + 0.02
        assert center[2] > center[0]

    def test_total_internal_reflection_terminates(self):
        # Grazing rays inside glass TIR; renders without NaN.
        scene = _floor_scene(mtype=MaterialType.REFRACTIVE)
        scene.materials[0].ior = 1.5
        img, _ = _render(scene, 33, 33, max_depth=4)
        assert np.isfinite(img).all()


class TestWavefront:
    def test_stats_shape_and_overflow_counter(self):
        scene = testscenes.cornell_box(64, 48)
        d = build_device_scene(scene)
        img, stats = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 64, 48, max_depth=3
        )
        assert stats["alive"].shape == (3,)
        assert int(stats["dropped"].sum()) == 0  # diffuse box spawns nothing
        # After pass 1 of an all-diffuse scene no rays survive.
        assert int(stats["alive"][0]) == 0

    def test_supersampling_reduces_edge_aliasing(self):
        scene = testscenes.single_triangle()
        d = build_device_scene(scene)
        img1, _ = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 64, 48, max_depth=2, spp=1
        )
        img4, _ = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 64, 48, max_depth=2, spp=4
        )
        img1, img4 = np.asarray(img1), np.asarray(img4)
        # 4x RGSS must produce intermediate coverage values on edges (red
        # channel: background 0, full triangle coverage 1.0).
        frac1 = ((img1[..., 0] > 0.05) & (img1[..., 0] < 0.95)).any()
        frac4 = ((img4[..., 0] > 0.05) & (img4[..., 0] < 0.95)).any()
        assert not frac1 and frac4
        # Interior pixels identical (both fully covered).
        assert abs(img1[24, 32, 0] - img4[24, 32, 0]) < 1e-5


class TestCornell:
    def test_cornell_box_walls_colored(self):
        scene = testscenes.cornell_box(96, 72)
        img, _ = _render(scene, 96, 72, max_depth=2)
        assert np.isfinite(img).all()
        # The box spans roughly cols 32-63, rows 20-51 at this camera.
        left = img[36, 34]   # red wall
        right = img[36, 62]  # green wall
        back = img[36, 48]   # white wall
        assert left[0] > 3 * left[1]
        assert right[1] > 2 * right[0]
        assert back.min() > 0.0 and abs(back[0] - back[1]) < 0.05 * back.max()


class TestSppOffsets:
    """Arbitrary-spp offset sets."""

    def test_reference_cases_unchanged(self):
        from directx_raytracer.render.whitted import spp_offsets
        from directx_raytracer.ops.rays import RGSS_OFFSETS

        assert spp_offsets(1) == ((0.5, 0.5),)
        assert spp_offsets(4) == RGSS_OFFSETS

    @pytest.mark.parametrize("spp", [2, 3, 8, 16, 64])
    def test_hammersley_properties(self, spp):
        from directx_raytracer.render.whitted import spp_offsets

        offs = np.asarray(spp_offsets(spp))
        assert offs.shape == (spp, 2)
        assert (offs > 0).all() and (offs < 1).all()
        assert len({tuple(o) for o in offs.tolist()}) == spp  # distinct
        # x is stratified: exactly one sample per 1/spp column.
        cols = np.floor(offs[:, 0] * spp).astype(int)
        assert sorted(cols.tolist()) == list(range(spp))

    def test_spp_zero_raises(self):
        from directx_raytracer.render.whitted import spp_offsets

        with pytest.raises(ValueError):
            spp_offsets(0)

    def test_spp16_renders(self):
        scene = testscenes.cornell_box(32, 24)
        d = build_device_scene(scene)
        img, _ = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 32, 24,
            max_depth=2, spp=16,
        )
        img = np.asarray(img)
        assert img.shape == (24, 32, 3)
        assert np.isfinite(img).all()


class TestBlinnPhong:
    """Blinn-Phong specular extension (BASELINE config 3)."""

    def test_analytic_highlight(self):
        from directx_raytracer.models.scene import LightTable
        from directx_raytracer.ops.shading import FOUR_PI, direct_lighting

        lights = LightTable(
            position=jnp.array([[0.0, 0.0, 2.0]], jnp.float32),
            intensity=jnp.array([50.0], jnp.float32),
            n_lights=1,
        )
        pts = jnp.zeros((1, 3), jnp.float32)
        nrm = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
        view = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)  # looking straight down
        shin = jnp.array([16.0], jnp.float32)
        diff, spec = direct_lighting(pts, nrm, lights, None, view=view,
                                     shininess=shin)
        expect = 50.0 / (FOUR_PI * 4.0)  # cos=1, n.h=1
        np.testing.assert_allclose(float(diff[0, 0]), expect, rtol=1e-5)
        np.testing.assert_allclose(float(spec[0, 0]), expect, rtol=1e-5)

    def test_off_axis_follows_cos_power(self):
        from directx_raytracer.models.scene import LightTable
        from directx_raytracer.ops.shading import FOUR_PI, direct_lighting

        # Light 45 deg off normal, viewer mirrored: half vector == normal
        # after normalize, so the highlight is maximal; tilting the viewer
        # to straight-down drops it by (n.h)^s.
        s = 32.0
        lights = LightTable(
            position=jnp.array([[1.0, 0.0, 1.0]], jnp.float32),
            intensity=jnp.array([FOUR_PI * 2.0], jnp.float32),
            n_lights=1,
        )
        pts = jnp.zeros((1, 3), jnp.float32)
        nrm = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)
        shin = jnp.array([s], jnp.float32)
        mirror_view = jnp.array([[1.0, 0.0, -1.0]], jnp.float32) / np.sqrt(2)
        down_view = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
        _, spec_m = direct_lighting(pts, nrm, lights, None, view=mirror_view,
                                    shininess=shin)
        _, spec_d = direct_lighting(pts, nrm, lights, None, view=down_view,
                                    shininess=shin)
        ldir = np.array([1.0, 0.0, 1.0]) / np.sqrt(2)
        irrad = 2.0 / 2.0 * ldir[2]  # intensity/(4 pi r^2)=1, cos = l.n
        np.testing.assert_allclose(float(spec_m[0, 0]), 2.0 / 2.0,
                                   rtol=1e-5)  # n.h = 1
        h = (ldir + np.array([0, 0, 1.0]))
        h /= np.linalg.norm(h)
        np.testing.assert_allclose(float(spec_d[0, 0]), 2.0 / 2.0 * h[2] ** s,
                                   rtol=1e-4)

    def test_specular_material_brightens_render(self):
        scene = testscenes.cornell_box(32, 24)
        d0 = build_device_scene(scene)
        assert d0.has_specular is False
        for m in scene.materials:
            if m.type == MaterialType.DIFFUSE:
                m.specular = 0.8
                m.shininess = 8.0
        d1 = build_device_scene(scene)
        assert d1.has_specular is True
        img0, _ = render_whitted(d0, scene.camera.position,
                                 scene.camera.rotation, 32, 24, max_depth=2)
        img1, _ = render_whitted(d1, scene.camera.position,
                                 scene.camera.rotation, 32, 24, max_depth=2)
        img0, img1 = np.asarray(img0), np.asarray(img1)
        assert (img1 >= img0 - 1e-6).all()  # specular only adds energy
        assert img1.sum() > img0.sum() + 1e-3


class TestConstColorConfig:
    """Named bring-up config (BASELINE config 1 / reference ConstColor)."""

    def test_flat_albedo_exact(self):
        scene = testscenes.const_color(32, 32)
        d = build_device_scene(scene)
        img, _ = render_whitted(d, scene.camera.position,
                                scene.camera.rotation, 32, 32, max_depth=1)
        img = np.asarray(img)
        # center pixel = foreground triangle albedo, exactly (flat shade)
        np.testing.assert_allclose(img[16, 16], [1.0, 0.45, 0.1], atol=1e-6)
        # corners = backdrop quad albedo
        np.testing.assert_allclose(img[1, 1], [0.1, 0.35, 0.1], atol=1e-6)


def test_backfacing_shadow_disarm_is_exact():
    """cos>0 shadow disarm: a surface facing AWAY from every light
    contributes zero diffuse AND specular with or without an occluder, so
    disarming its shadow ray (t_max=0) cannot change the image."""
    import jax.numpy as jnp

    from directx_raytracer.models import LightTable
    from directx_raytracer.ops.shading import direct_lighting

    lights = LightTable(
        position=jnp.array([[0.0, 10.0, 0.0]], jnp.float32),
        intensity=jnp.array([1000.0], jnp.float32), n_lights=1)
    points = jnp.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
    # First point faces the light, second faces away.
    normals = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]], jnp.float32)
    mask = jnp.array([True, True])

    calls = []

    def occluder(o, d, t):
        calls.append(jnp.asarray(t))
        return jnp.zeros((o.shape[0],), bool)

    lit = direct_lighting(points, normals, lights, occluder, mask=mask)
    unlit = direct_lighting(points, normals, lights, None, mask=mask)
    assert float(lit[1, 0]) == 0.0 and float(unlit[1, 0]) == 0.0
    assert float(lit[0, 0]) > 0.0
    # The backfacing lane's shadow ray was disarmed (t_max == 0).
    (t,) = calls
    assert float(jnp.sort(t)[0]) == 0.0 and float(jnp.sort(t)[-1]) > 0.0
