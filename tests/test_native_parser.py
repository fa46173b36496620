"""Native C++ .crtscene parser == pure-Python parser (field-for-field)."""

import json
import os

import numpy as np
import pytest

from directx_raytracer.io import crtscene
from directx_raytracer.native import build, crtscene_native


def _native_available():
    return build.get_library() is not None


pytestmark = pytest.mark.skipif(
    not _native_available(), reason="native parser did not build"
)


def _compare_scenes(a, b):
    assert a.settings.image_width == b.settings.image_width
    assert a.settings.image_height == b.settings.image_height
    np.testing.assert_allclose(a.settings.background_color,
                               b.settings.background_color)
    np.testing.assert_allclose(a.camera.position, b.camera.position)
    np.testing.assert_allclose(a.camera.rotation, b.camera.rotation)

    assert len(a.lights) == len(b.lights)
    for la, lb in zip(a.lights, b.lights):
        np.testing.assert_allclose(la.position, lb.position)
        assert la.intensity == lb.intensity

    assert len(a.materials) == len(b.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert ma.type == mb.type
        np.testing.assert_allclose(ma.albedo, mb.albedo)
        assert ma.smooth_shading == mb.smooth_shading
        assert ma.ior == pytest.approx(mb.ior, rel=1e-6)  # c_float rounding
        assert ma.texture_name == mb.texture_name
        assert ma.specular == pytest.approx(mb.specular, rel=1e-6)
        assert ma.shininess == pytest.approx(mb.shininess, rel=1e-6)

    assert len(a.textures) == len(b.textures)
    for ta, tb in zip(a.textures, b.textures):
        assert (ta.name, ta.type, ta.file_path) == (tb.name, tb.type, tb.file_path)
        np.testing.assert_allclose(ta.color_a, tb.color_a)
        np.testing.assert_allclose(ta.color_b, tb.color_b)
        assert ta.scalar == pytest.approx(tb.scalar)

    assert len(a.meshes) == len(b.meshes)
    for sa, sb in zip(a.meshes, b.meshes):
        assert sa.material_index == sb.material_index
        np.testing.assert_allclose(sa.vertices, sb.vertices)
        np.testing.assert_array_equal(sa.indices, sb.indices)
        np.testing.assert_allclose(sa.uvs, sb.uvs)
        if sb.normals is None:
            sb.calculate_vertex_normals()
        np.testing.assert_allclose(sa.normals, sb.normals, atol=1e-5)


def test_dragon_parity(dragon_path):
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    native = crtscene_native.load(dragon_path)
    python = crtscene.load(dragon_path, use_native=False)
    assert native is not None
    _compare_scenes(native, python)


def test_synthetic_scene_parity(tmp_path):
    doc = {
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": 320, "height": 200}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1], "position": [1, 2, 3]},
        "lights": [{"intensity": 500, "position": [0, 5, 0]},
                   {"intensity": 40.5, "position": [-1, 2, 3.5]}],
        "materials": [
            {"type": "diffuse", "albedo": [0.9, 0.1, 0.2], "smooth_shading": True,
             "specular": 0.45, "shininess": 12.5},
            {"type": "reflective", "albedo": [0.8, 0.8, 0.8], "smooth_shading": False},
            {"type": "refractive", "ior": 1.51, "smooth_shading": True},
            {"type": "constant", "albedo": "checkers", "smooth_shading": False},
            {"type": "???", "albedo": [0.5, 0.5, 0.5], "smooth_shading": False},
        ],
        "textures": [
            {"name": "flat", "type": "albedo", "albedo": [1, 0, 1]},
            {"name": "edgy", "type": "edges", "edge_color": [1, 0, 0],
             "inner_color": [0, 1, 0], "edge_width": 0.05},
            {"name": "checkers", "type": "checker", "color_A": [0, 0, 0],
             "color_B": [1, 1, 1], "square_size": 0.25},
            {"name": "pic", "type": "bitmap", "file_path": "img.png"},
            {"name": "odd", "type": "wat", "file_path": "other.png"},
        ],
        "objects": [
            {"material_index": 1,
             "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0],
             "uvs": [0, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0],
             "triangles": [0, 1, 2, 1, 3, 2]},
            {"material_index": 0,
             "vertices": [0, 0, 1, 2, 0, 1, 1, 2, 1],
             "triangles": [0, 1, 2]},
        ],
    }
    p = tmp_path / "scene.crtscene"
    p.write_text(json.dumps(doc))
    native = crtscene_native.load(str(p))
    python = crtscene.load(str(p), use_native=False)
    _compare_scenes(native, python)
    # quirks: unknown material type -> refractive with white albedo;
    # string albedo -> texture reference
    assert native.materials[4].type.name == "REFRACTIVE"
    np.testing.assert_allclose(native.materials[4].albedo, 1.0)
    assert native.materials[3].texture_name == "checkers"


def test_parse_error_reported(tmp_path):
    p = tmp_path / "broken.crtscene"
    p.write_text('{"objects": [{"vertices": [1, 2, }]}')
    with pytest.raises(ValueError, match="parse failed"):
        crtscene_native.load(str(p))


def test_native_vertex_normals_match_numpy():
    from directx_raytracer.models.mesh import vertex_normals

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    tris = rng.integers(0, 50, size=(80, 3)).astype(np.int32).reshape(-1)
    lib = build.get_library()
    got = build.vertex_normals(lib, verts, tris)
    ref = vertex_normals(verts, tris)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_unicode_escape_parity(tmp_path):
    """Non-ASCII names: \\uXXXX escapes (incl. surrogate pairs) and raw
    UTF-8 must decode identically in both parsers."""
    doc = {
        "settings": {"background_color": [0, 0, 0],
                     "image_settings": {"width": 8, "height": 8}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 0]},
        "materials": [
            {"type": "diffuse", "albedo": "décor-木纹",
             "smooth_shading": False},
        ],
        "textures": [
            {"name": "décor-木纹", "type": "albedo",
             "albedo": [0.5, 0.5, 0.5]},
            {"name": "emoji-\U0001f409", "type": "checker",
             "color_A": [0, 0, 0], "color_B": [1, 1, 1],
             "square_size": 0.25},
        ],
        "objects": [{
            "material_index": 0,
            "vertices": [0, 0, 0, 1, 0, 0, 0, 1, 0],
            "triangles": [0, 1, 2],
        }],
    }
    # ensure_ascii=True forces every non-ASCII char through \uXXXX (the
    # dragon emoji becomes a surrogate pair); a second file keeps raw UTF-8.
    for name, ensure in (("esc.crtscene", True), ("raw.crtscene", False)):
        path = tmp_path / name
        path.write_text(json.dumps(doc, ensure_ascii=ensure),
                        encoding="utf-8")
        native = crtscene_native.load(str(path))
        python = crtscene.load(str(path), use_native=False)
        assert native is not None
        assert native.materials[0].texture_name == "décor-木纹"
        assert native.textures[1].name == "emoji-\U0001f409"
        _compare_scenes(native, python)
