"""End-to-end texture rendering: the 4 CRTTexture types through the full
Whitted pipeline (parse-level coverage lives in test_parser)."""

import numpy as np
import pytest

from directx_raytracer.models.camera import Camera
from directx_raytracer.models.light import Light
from directx_raytracer.models.material import Material, MaterialType
from directx_raytracer.models.mesh import Mesh
from directx_raytracer.models.scene import Scene, SceneSettings, build_device_scene
from directx_raytracer.models.texture import Texture, TextureType
from directx_raytracer.render.whitted import render_whitted

FOUR_PI = 4.0 * np.pi


def _textured_floor(tex: Texture, uv_scale: float = 1.0):
    """Unit-UV floor quad at y=0 under a bright overhead light, camera
    looking straight down from (0.5 u, 2, 0.5 v) world alignment."""
    scene = Scene()
    scene.settings = SceneSettings(background_color=np.zeros(3, np.float32))
    scene.camera = Camera(position=(0.5, 1.0, 0.5))
    scene.camera.rotate(0.0, 89.0)  # look down
    m = Mesh(
        vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1]], np.float32),
        indices=np.array([0, 2, 1, 3, 1, 2], np.int32),  # +y winding
        material_index=0,
    )
    m.uvs = np.array([[0, 0, 0], [uv_scale, 0, 0], [0, uv_scale, 0],
                      [uv_scale, uv_scale, 0]], np.float32)
    m.calculate_vertex_normals()
    scene.meshes.append(m)
    mat = Material(type=MaterialType.CONSTANT)  # texture color passthrough
    mat.texture_name = tex.name
    scene.materials.append(mat)
    scene.textures.append(tex)
    scene.lights.append(Light(position=np.array([0.5, 3, 0.5], np.float32),
                              intensity=200.0))
    return scene


def _render(scene, w=64, h=64):
    d = build_device_scene(scene)
    img, _ = render_whitted(d, *scene.camera.snapshot(), w, h, max_depth=2)
    return np.asarray(img)


def test_albedo_texture_flat_color():
    tex = Texture(name="flat", type=TextureType.ALBEDO,
                  color_a=np.array([0.2, 0.9, 0.4], np.float32))
    img = _render(_textured_floor(tex))
    np.testing.assert_allclose(img[32, 32], [0.2, 0.9, 0.4], atol=1e-5)


def test_checker_texture_alternates():
    tex = Texture(name="check", type=TextureType.CHECKER,
                  color_a=np.array([1.0, 0.0, 0.0], np.float32),
                  color_b=np.array([0.0, 0.0, 1.0], np.float32),
                  scalar=0.5)  # 2x2 squares over the unit UV
    img = _render(_textured_floor(tex))
    # The floor fills the central view; sample two diagonal quadrants.
    colors = {tuple(np.round(img[y, x]).astype(int)) for (y, x) in
              [(20, 20), (20, 44), (44, 20), (44, 44)]}
    assert (1, 0, 0) in colors and (0, 0, 1) in colors
    # Diagonal quadrants share a color (checker property).
    assert tuple(np.round(img[20, 20]).astype(int)) == tuple(
        np.round(img[44, 44]).astype(int))
    assert tuple(np.round(img[20, 44]).astype(int)) == tuple(
        np.round(img[44, 20]).astype(int))


def test_edges_texture_marks_triangle_borders():
    tex = Texture(name="wire", type=TextureType.EDGES,
                  color_a=np.array([1.0, 1.0, 0.0], np.float32),  # edge
                  color_b=np.array([0.1, 0.1, 0.1], np.float32),  # inner
                  scalar=0.08)
    img = _render(_textured_floor(tex))
    # Edge color appears along the quad diagonal (shared triangle edge);
    # inner color in triangle centers.
    edge_frac = (np.abs(img - [1, 1, 0]).sum(-1) < 0.05).mean()
    inner_frac = (np.abs(img - [0.1, 0.1, 0.1]).sum(-1) < 0.05).mean()
    assert 0.02 < edge_frac < 0.6
    # The floor covers ~25% of the frame at this fov; inner fills most of it.
    assert inner_frac > 0.08


def test_bitmap_texture_nearest_sampling(tmp_path):
    # 4x4 png with distinct quadrant colors (the reference's sampler
    # truncates (u*(w-1)), so a 2x2 texture shows mostly texel (0,0)).
    from PIL import Image

    q = np.zeros((4, 4, 3), np.uint8)
    q[:2, :2] = (255, 0, 0)
    q[:2, 2:] = (0, 255, 0)
    q[2:, :2] = (0, 0, 255)
    q[2:, 2:] = (255, 255, 0)
    p = tmp_path / "t.png"
    Image.fromarray(q).save(p)
    tex = Texture(name="bmp", type=TextureType.BITMAP, file_path=str(p))
    scene = _textured_floor(tex)
    d = build_device_scene(scene, base_dir=str(tmp_path))
    img, _ = render_whitted(d, *scene.camera.snapshot(), 64, 64, max_depth=2)
    img = np.asarray(img)
    # v-flip: low v samples the BOTTOM rows of the png.
    seen = {tuple(np.round(img[y, x]).astype(int)) for (y, x) in
            [(20, 20), (20, 44), (44, 20), (44, 44)]}
    assert len(seen) >= 3  # multiple distinct texels actually sampled
    for c in seen:
        assert c in {(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0)}


def test_diffuse_material_modulated_by_texture():
    tex = Texture(name="check", type=TextureType.CHECKER,
                  color_a=np.array([1.0, 1.0, 1.0], np.float32),
                  color_b=np.array([0.0, 0.0, 0.0], np.float32),
                  scalar=0.5)
    scene = _textured_floor(tex)
    scene.materials[0] = Material(type=MaterialType.DIFFUSE)
    scene.materials[0].texture_name = "check"
    img = _render(scene)
    lit = img.max(-1)
    # White squares receive diffuse lighting; black squares stay black.
    assert (lit > 0.5).any() and (lit < 1e-4).any()
