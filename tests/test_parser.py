"""Parser round-trip + schema quirks (CRTSceneParser.cpp semantics)."""

import os

import numpy as np
import pytest

from directx_raytracer.io import crtscene
from directx_raytracer.models.material import MaterialType
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.models.texture import TextureType


def test_dragon_roundtrip(dragon_path):
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    scene = crtscene.load(dragon_path)
    assert scene.settings.image_width == 1920
    assert scene.settings.image_height == 1080
    np.testing.assert_allclose(scene.settings.background_color, [0, 0.5, 0])
    np.testing.assert_allclose(scene.camera.position, [0, 14, 26])
    np.testing.assert_allclose(scene.camera.rotation, np.eye(3))
    assert len(scene.meshes) == 2
    assert scene.meshes[0].num_vertices == 4
    assert scene.meshes[0].num_triangles == 2
    assert scene.meshes[1].num_vertices == 2008
    assert scene.meshes[1].num_triangles == 4012
    assert len(scene.lights) == 4
    assert [l.intensity for l in scene.lights] == [2000, 2000, 500, 500]
    assert len(scene.materials) == 2
    assert scene.materials[0].type == MaterialType.REFLECTIVE
    assert scene.materials[0].smooth_shading
    assert scene.materials[1].type == MaterialType.DIFFUSE
    np.testing.assert_allclose(scene.materials[1].albedo, [0.9, 0.6, 0.9], atol=1e-7)


def test_dragon_device_scene(dragon_path):
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    scene = crtscene.load(dragon_path)
    ds = build_device_scene(scene)
    geo = ds.geometry
    assert geo.n_real_tris == 4014
    assert geo.n_tris % 128 == 0  # treelet leaves padded to CLUSTER_K
    assert geo.v0.shape[0] % 128 == 0
    # mesh ids survive treelet reordering: 2 plane tris + 4012 dragon tris
    mid = np.asarray(geo.mesh_id)
    assert (mid == 0).sum() == 2 and (mid == 1).sum() == 4012
    # local ids (PrimitiveIndex) per mesh form complete 0..n-1 sets
    lid = np.asarray(geo.local_id)
    assert sorted(lid[mid == 0].tolist()) == [0, 1]
    assert sorted(lid[mid == 1].tolist()) == list(range(4012))
    # interleaved + tail padding is inert (guaranteed-miss sentinels)
    pad = np.asarray(geo.mat_id) == -1
    assert pad.sum() == geo.v0.shape[0] - 4014
    assert np.all(np.asarray(geo.e1)[pad] == 0)
    assert ds.lights.n_lights == 4


def test_string_albedo_becomes_texture_name():
    scene = crtscene.loads(
        '{"materials": [{"type": "diffuse", "albedo": "wood", "smooth_shading": false}]}'
    )
    assert scene.materials[0].texture_name == "wood"
    assert scene.materials[0].is_texture()


def test_refractive_forces_unit_albedo_and_reads_ior():
    scene = crtscene.loads(
        '{"materials": [{"type": "refractive", "ior": 1.51, "albedo": [0.2, 0.2, 0.2],'
        ' "smooth_shading": true}]}'
    )
    mat = scene.materials[0]
    assert mat.type == MaterialType.REFRACTIVE
    assert mat.ior == pytest.approx(1.51)
    np.testing.assert_allclose(mat.albedo, [1, 1, 1])  # CRTSceneParser.cpp:368


def test_unknown_material_type_falls_back_to_refractive():
    scene = crtscene.loads('{"materials": [{"type": "plasma", "smooth_shading": false}]}')
    assert scene.materials[0].type == MaterialType.REFRACTIVE


def test_unknown_texture_type_falls_back_to_bitmap():
    scene = crtscene.loads(
        '{"textures": [{"name": "t", "type": "weird", "file_path": "img.png"}]}'
    )
    tex = scene.textures[0]
    assert tex.type == TextureType.BITMAP
    assert tex.file_path == "img.png"


def test_texture_types_parse():
    scene = crtscene.loads(
        """{"textures": [
          {"name": "a", "type": "albedo", "albedo": [1, 0, 0]},
          {"name": "e", "type": "edges", "edge_color": [0,0,0], "inner_color": [1,1,1],
           "edge_width": 0.05},
          {"name": "c", "type": "checker", "color_A": [0,0,0], "color_B": [1,1,1],
           "square_size": 0.25}
        ]}"""
    )
    types = [t.type for t in scene.textures]
    assert types == [TextureType.ALBEDO, TextureType.EDGES, TextureType.CHECKER]
    assert scene.textures[2].scalar == pytest.approx(0.25)
    assert scene.get_texture_by_name("e").name == "e"
    assert scene.get_texture_by_name("nope") is None


def test_vertex_normals_accumulation():
    """CRTMesh::calculateVertexNormals: sum adjacent unit face normals, then
    normalize (CRTMesh.cpp:66-94)."""
    scene = crtscene.loads(
        """{"objects": [{"material_index": 0,
            "vertices": [0,0,0, 1,0,0, 0,0,-1, 0,1,0],
            "triangles": [0,1,3, 0,3,2]}]}"""
    )
    mesh = scene.meshes[0]
    # face 0 normal: cross((1,0,0),(0,1,0)) = (0,0,1)
    # face 1 normal: cross((0,1,0),(0,0,-1)) = (-1,0,0)
    n = mesh.normals
    np.testing.assert_allclose(n[1], [0, 0, 1], atol=1e-6)
    np.testing.assert_allclose(n[2], [-1, 0, 0], atol=1e-6)
    s = np.float32(1 / np.sqrt(2))
    np.testing.assert_allclose(n[0], [-s, 0, s], atol=1e-6)
    np.testing.assert_allclose(n[3], [-s, 0, s], atol=1e-6)


def test_empty_scene_parses():
    scene = crtscene.loads("{}")
    ds = build_device_scene(scene)
    assert ds.geometry.n_tris == 0


def test_scene_writer_roundtrip(dragon_path):
    """dump -> load reproduces the scene (File->Save, which the reference
    stubs but never wires: DXRTMainWindow.cpp:155-158)."""
    if not os.path.exists(dragon_path):
        pytest.skip("reference Dragon.crtscene not available")
    a = crtscene.load(dragon_path)
    text = crtscene.dumps(a)
    b = crtscene.loads(text)
    assert b.settings.image_width == a.settings.image_width
    np.testing.assert_allclose(b.camera.position, a.camera.position)
    np.testing.assert_allclose(b.camera.rotation, a.camera.rotation)
    assert len(b.lights) == len(a.lights)
    assert len(b.materials) == len(a.materials)
    for ma, mb in zip(a.materials, b.materials):
        assert (ma.type, ma.smooth_shading, ma.texture_name) == (
            mb.type, mb.smooth_shading, mb.texture_name)
        np.testing.assert_allclose(mb.albedo, ma.albedo)
    assert len(b.meshes) == len(a.meshes)
    for sa, sb in zip(a.meshes, b.meshes):
        np.testing.assert_allclose(sb.vertices, sa.vertices)
        np.testing.assert_array_equal(sb.indices, sa.indices)


def test_blinn_phong_extension_keys_roundtrip():
    scene = crtscene.loads(
        '{"materials": [{"type": "diffuse", "albedo": [0.5, 0.5, 0.5], '
        '"smooth_shading": true, "specular": 0.6, "shininess": 24}]}'
    )
    m = scene.materials[0]
    assert m.specular == pytest.approx(0.6)
    assert m.shininess == pytest.approx(24.0)
    # writer emits them, re-parse agrees
    b = crtscene.loads(crtscene.dumps(scene))
    assert b.materials[0].specular == pytest.approx(0.6)
    assert b.materials[0].shininess == pytest.approx(24.0)
    # absent keys keep reference defaults (no specular term)
    plain = crtscene.loads('{"materials": [{"type": "diffuse"}]}')
    assert plain.materials[0].specular == 0.0


def test_shininess_survives_roundtrip_without_specular():
    """A zero-specular material with customized shininess
    must keep the shininess through dumps/loads (keys are independent)."""
    scene = crtscene.loads(
        '{"materials": [{"type": "diffuse", "albedo": [0.5, 0.5, 0.5], '
        '"smooth_shading": false, "shininess": 7.5}]}'
    )
    b = crtscene.loads(crtscene.dumps(scene))
    assert b.materials[0].specular == 0.0
    assert b.materials[0].shininess == pytest.approx(7.5)
