"""Camera ray generation vs the raygen shader math (hlsl:21-70)."""

import numpy as np

from directx_raytracer.ops.rays import generate_rays
from directx_raytracer.utils import vecmath as vm


def test_center_pixel_looks_down_minus_z():
    w, h = 101, 101  # odd size -> exact center pixel
    o, d = generate_rays(np.zeros(3, np.float32), np.eye(3, dtype=np.float32), w, h)
    center = (h // 2) * w + (w // 2)
    np.testing.assert_allclose(np.asarray(d[center]), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(o[center]), [0, 0, 0], atol=1e-7)


def test_raster_order_and_y_flip():
    w, h = 8, 6
    _, d = generate_rays(np.zeros(3, np.float32), np.eye(3, dtype=np.float32), w, h)
    d = np.asarray(d).reshape(h, w, 3)
    assert d[0, 0, 1] > 0  # top-left pixel points up
    assert d[-1, 0, 1] < 0  # bottom-left points down
    assert d[0, 0, 0] < 0  # left points -x
    assert d[0, -1, 0] > 0  # right points +x


def test_exact_ndc_math():
    """Pixel (px, py): x = ((px+.5)/W*2-1)*W/H, y = 1-2*(py+.5)/H, dir =
    normalize(x, y, -1)."""
    w, h = 64, 48
    _, d = generate_rays(np.zeros(3, np.float32), np.eye(3, dtype=np.float32), w, h)
    d = np.asarray(d).reshape(h, w, 3)
    px, py = 10, 33
    x = ((px + 0.5) / w * 2 - 1) * (w / h)
    y = 1 - 2 * (py + 0.5) / h
    v = np.array([x, y, -1.0], np.float32)
    v /= np.linalg.norm(v)
    np.testing.assert_allclose(d[py, px], v, atol=1e-6)


def test_rotation_applied_as_column_vector():
    """world = R @ cam_dir (hlsl:47 mul(cameraRotation, v))."""
    w = h = 51
    r = vm.rot_y(90.0)
    _, d = generate_rays(np.zeros(3, np.float32), r, w, h)
    center = (h // 2) * w + (w // 2)
    np.testing.assert_allclose(np.asarray(d[center]), r @ [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(d[center]), [1, 0, 0], atol=1e-6)


def test_directions_unit_length():
    _, d = generate_rays(np.zeros(3, np.float32), vm.rot_y(33.0) @ vm.rot_x(10.0), 32, 24)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(d), axis=1), 1.0, atol=1e-6)


def test_pick_schedule_production_shapes():
    """Primary schedule: 8x32 pixel tiles (256 rays, one kernel tile) where
    they divide the frame; otherwise the divisibility search shrinks them."""
    from directx_raytracer.bvh.pallas_intersect import TILE_R
    from directx_raytracer.ops.rays import pick_tile

    assert pick_tile(1080, 1920) == (8, 32)
    assert 8 * 32 == TILE_R
    assert pick_tile(360, 640) == (8, 32)
    # 270 rows: 8 does not divide, 6 does.
    assert pick_tile(270, 480) == (6, 32)
    # Degenerate tilings buy nothing.
    assert pick_tile(7, 13) is None


def test_pick_schedule_tile_covers_rows():
    """Every returned tile divides the frame it is returned for (the
    renderers reshape (rows*W) into whole tiles)."""
    from directx_raytracer.ops.rays import pick_tile

    for rows, width in ((1080, 1920), (540, 960), (270, 480), (108, 192),
                        (360, 640), (300, 400), (47, 100)):
        tile = pick_tile(rows, width)
        if tile is not None:
            th, tw = tile
            assert rows % th == 0 and width % tw == 0
            assert th <= 8 and tw <= 32
