"""The tile intersection kernel under the Pallas interpreter — CPU gate.

The kernel compiles only for the GPU (tests marked ``gpu`` run it there);
this module executes the SAME kernel code — rank-table walk, ranks past
the table resolved from the occupancy words, the entry gate, padding of
partial tiles — through
``interpret=True`` on every CPU run.  Scenes are kept small: the
interpreter runs programs serially.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from directx_raytracer import testscenes
from directx_raytracer.bvh import (
    build_bvh,
    make_bvh_intersect_fn,
    make_bvh_occluder_factory,
)
from directx_raytracer.bvh.pallas_intersect import (
    TILE_R,
    _search,
    bin_clusters_bits,
    intersect_pallas,
    occluded_pallas,
    planar_woop,
)
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.ops.intersect import (
    intersect_bruteforce,
    occluded_bruteforce,
)
from directx_raytracer.ops.rays import generate_rays_tiled


@pytest.fixture(scope="module")
def scene_geo():
    scene = testscenes.bench_scene(n_tris=3_000, width=96, height=48)
    d = build_device_scene(scene)
    return scene, d, build_bvh(d.geometry)


@pytest.fixture(scope="module")
def rays(scene_geo):
    scene, _, _ = scene_geo
    pos, rot = scene.camera.snapshot()
    return generate_rays_tiled(pos, rot, 96, 48, 8, 32)


def _agree_closest(got, ref, frac=0.999):
    hm = np.asarray(got.tri >= 0) == np.asarray(ref.tri >= 0)
    assert hm.mean() > frac
    hits = np.asarray(ref.tri >= 0) & np.asarray(got.tri >= 0)
    close = np.isclose(np.asarray(got.t)[hits], np.asarray(ref.t)[hits],
                       rtol=1e-3)
    assert close.mean() > frac


def test_closest_matches_bruteforce(scene_geo, rays):
    scene, d, bvh = scene_geo
    o, dd = rays
    ref = intersect_bruteforce(o, dd, d.geometry.woop)
    got = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar, refine=True,
                           interpret=True)
    assert np.asarray(ref.tri >= 0).mean() > 0.1, "vacuous: few hits"
    _agree_closest(got, ref)


def test_occlusion_matches_bruteforce(scene_geo, rays):
    scene, d, bvh = scene_geo
    o, dd = rays
    t_max = jnp.full((o.shape[0],), 25.0)
    ref = occluded_bruteforce(o, dd, d.geometry.woop, t_max)
    got = occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, t_max,
                          interpret=True)
    assert (np.asarray(got) == np.asarray(ref)).mean() > 0.999


def test_occlusion_tcap_short_rays(scene_geo, rays):
    """Binning-time t-cap: clusters whose conservative entry lies beyond a
    tile's max t_max are never scheduled.  Short shadow rays (the cap
    biting hard) must still agree with brute force, and mixed per-lane
    t_max (the cap is a tile-level MAX) must stay conservative."""
    scene, d, bvh = scene_geo
    o, dd = rays
    for dist in (2.0, 8.0):
        t_max = jnp.full((o.shape[0],), dist)
        ref = occluded_bruteforce(o, dd, d.geometry.woop, t_max)
        got = occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, t_max,
                              interpret=True)
        assert (np.asarray(got) == np.asarray(ref)).mean() > 0.999, dist
    # Mixed lanes: half the rays short, half long, interleaved.
    t_mix = jnp.where(jnp.arange(o.shape[0]) % 2 == 0, 3.0, 30.0)
    ref = occluded_bruteforce(o, dd, d.geometry.woop, t_mix)
    got = occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, t_mix,
                          interpret=True)
    assert (np.asarray(got) == np.asarray(ref)).mean() > 0.999


def test_disarmed_shadow_rays_never_block(scene_geo, rays):
    """t_max <= T_MIN disarms a shadow ray: it blocks nothing, whether the
    whole batch is disarmed or only every other lane."""
    scene, d, bvh = scene_geo
    o, dd = rays
    zero = occluded_pallas(o, dd, bvh.clusters, bvh.wplanar,
                           jnp.zeros((o.shape[0],)), interpret=True)
    assert not np.asarray(zero).any()
    armed = jnp.arange(o.shape[0]) % 2 == 0
    t_max = jnp.where(armed, 30.0, 0.0)
    got = np.asarray(occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, t_max,
                                     interpret=True))
    ref = np.asarray(occluded_bruteforce(o, dd, d.geometry.woop, t_max))
    assert not got[~np.asarray(armed)].any()
    assert ref.any(), "vacuous: nothing occluded"
    assert (got == ref).mean() > 0.999


def test_closest_respects_t_max(scene_geo, rays):
    """Per-ray t_max is an exact exclusive bound on the reported hit."""
    scene, d, bvh = scene_geo
    o, dd = rays
    far = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar, interpret=True)
    t_hit = np.asarray(far.t)[np.asarray(far.tri >= 0)]
    cut = float(np.median(t_hit))
    near = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar,
                            t_max=jnp.full((o.shape[0],), cut),
                            interpret=True)
    np.testing.assert_array_equal(
        np.asarray(near.tri >= 0),
        np.asarray((far.tri >= 0) & (far.t < cut)))
    assert np.all(np.asarray(near.t)[np.asarray(near.tri >= 0)] < cut)


@pytest.mark.parametrize("n_rays", [1, TILE_R - 1, 2 * TILE_R + 37])
def test_partial_tiles_are_padded(scene_geo, rays, n_rays):
    """Ray counts that are not whole tiles: padding lanes repeat the last
    real ray with a zero bound, so results match brute force exactly on
    the real rays and the padded ones never leak out."""
    scene, d, bvh = scene_geo
    o, dd = rays
    # Rays from the middle of the frame, where the scene is.
    o, dd = o[1024:1024 + n_rays], dd[1024:1024 + n_rays]
    got = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar, refine=True,
                           interpret=True)
    ref = intersect_bruteforce(o, dd, d.geometry.woop)
    assert got.t.shape == (n_rays,) and got.tri.shape == (n_rays,)
    np.testing.assert_array_equal(np.asarray(got.tri >= 0),
                                  np.asarray(ref.tri >= 0))
    occ = occluded_pallas(o, dd, bvh.clusters, bvh.wplanar,
                          jnp.full((n_rays,), 25.0), interpret=True)
    assert occ.shape == (n_rays,)


def test_empty_tiles_report_misses(scene_geo):
    """Tiles whose rays point away from the scene bin no cluster at all;
    the kernel's walk is empty and every ray misses."""
    scene, d, bvh = scene_geo
    pos, rot = scene.camera.snapshot()
    o, dd = generate_rays_tiled(pos, -np.asarray(rot), 96, 48, 8, 32)
    tiles = o.shape[0] // TILE_R
    *_, counts = bin_clusters_bits(o.reshape(tiles, TILE_R, 3),
                                   dd.reshape(tiles, TILE_R, 3), bvh.clusters)
    ref = intersect_bruteforce(o, dd, d.geometry.woop)
    got = intersect_pallas(o, dd, bvh.clusters, bvh.wplanar, interpret=True)
    assert (np.asarray(counts) == 0).any(), "vacuous: no empty tile"
    np.testing.assert_array_equal(np.asarray(got.tri >= 0),
                                  np.asarray(ref.tri >= 0))


def test_bitwalk_binning_matches_xla_walker():
    """The kernel finds the same hits as the independent XLA clustered
    walker, including ranks resolved past the rank table."""
    from directx_raytracer.bvh.clustered import (intersect_clustered,
                                                     occluded_clustered)

    scene = testscenes.bench_scene(n_tris=3_000, width=64, height=32)
    d = build_device_scene(scene)
    pos, rot = scene.camera.snapshot()
    o, dd = generate_rays_tiled(jnp.asarray(pos), jnp.asarray(rot), 64, 32,
                                8, 32)
    bvh = build_bvh(d.geometry)
    ref = intersect_clustered(o, dd, bvh.clusters)
    bt, bs = _search(o, dd, jnp.full((o.shape[0],), 1e4, jnp.float32),
                     bvh.clusters, bvh.wplanar, anyhit=False, interpret=True,
                     cap=2)
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(bs))
    hit = np.asarray(bs) >= 0
    np.testing.assert_allclose(np.asarray(ref.t)[hit], np.asarray(bt)[hit],
                               rtol=1e-5)
    tmax = jnp.full((o.shape[0],), 25.0)
    occ_ref = np.asarray(occluded_clustered(o, dd, bvh.clusters, tmax))
    occ = np.asarray(occluded_pallas(o, dd, bvh.clusters, bvh.wplanar, tmax,
                                     interpret=True))
    np.testing.assert_array_equal(occ, occ_ref)


def test_rank_table_matches_oracle_walk(scene_geo, rays):
    """rank_table_bits[t, j] must equal the j-th set bit of tile t's words."""
    from directx_raytracer.bvh.pallas_intersect import rank_table_bits

    scene, d, bvh = scene_geo
    o, dd = rays
    tiles = o.shape[0] // TILE_R
    words, cum, entry, counts = bin_clusters_bits(
        o.reshape(tiles, TILE_R, 3), dd.reshape(tiles, TILE_R, 3),
        bvh.clusters)
    cap = 16
    table = np.asarray(rank_table_bits(words, cum, cap))
    wn = np.asarray(words)
    cn = np.asarray(counts)
    assert cn.max() > 0
    for t in range(tiles):
        bits = [w * 32 + b for w in range(wn.shape[1]) for b in range(32)
                if (wn[t, w] >> b) & 1]
        for j in range(min(len(bits), cap)):
            assert table[t, j] == bits[j], (t, j)


@pytest.mark.parametrize("cap", [1, 4])
def test_small_cap_forces_hi_phase(scene_geo, rays, cap):
    """A small rank table pushes most ranks past the table, where the
    kernel resolves them from the occupancy words — results must equal the
    full-table path."""
    scene, d, bvh = scene_geo
    o, dd = rays
    t_init = jnp.full((o.shape[0],), 10000.0, jnp.float32)
    bt_a, bs_a = _search(o, dd, t_init, bvh.clusters, bvh.wplanar,
                         anyhit=False, interpret=True)
    bt_b, bs_b = _search(o, dd, t_init, bvh.clusters, bvh.wplanar,
                         anyhit=False, interpret=True, cap=cap)
    np.testing.assert_array_equal(np.asarray(bs_a), np.asarray(bs_b))
    np.testing.assert_array_equal(np.asarray(bt_a), np.asarray(bt_b))
    t_max = jnp.full((o.shape[0],), 25.0, jnp.float32)
    _, occ_a = _search(o, dd, t_max, bvh.clusters, bvh.wplanar, anyhit=True,
                       interpret=True)
    _, occ_b = _search(o, dd, t_max, bvh.clusters, bvh.wplanar, anyhit=True,
                       interpret=True, cap=cap)
    np.testing.assert_array_equal(np.asarray(occ_a >= 0),
                                  np.asarray(occ_b >= 0))


def test_hier_rank_table_matches_flat():
    """The two-level (wide-C) rank table must equal the plain bit walk on
    synthetic word rows."""
    from directx_raytracer.bvh.pallas_intersect import (
        _rank_table_bits_hier)

    rng = np.random.default_rng(7)
    t, w = 13, 96  # forces the hier path (w > 64)
    words = rng.integers(0, 2**32, size=(t, w), dtype=np.uint32)
    words[rng.random((t, w)) < 0.5] = 0  # sprinkle empty words
    wn = jnp.asarray(words.view("int32"))
    cnt = np.zeros((t, w), np.int32)
    for ti in range(t):
        for wi in range(w):
            cnt[ti, wi] = bin(int(words[ti, wi])).count("1")
    cum = jnp.asarray(np.cumsum(cnt, axis=1).astype(np.int32))
    cap = 64
    got = np.asarray(_rank_table_bits_hier(wn, cum, cap))
    assert got.shape == (t, cap)
    for ti in range(t):
        bits = [wi * 32 + b for wi in range(w) for b in range(32)
                if (int(words[ti, wi]) >> b) & 1]
        for j in range(min(len(bits), cap)):
            assert got[ti, j] == bits[j], (ti, j, got[ti, j], bits[j])


def test_nth_set_bit_matches_python():
    from directx_raytracer.bvh.pallas_intersect import _nth_set_bit

    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=64, dtype=np.uint32)
    words[0] = 0x80000001  # sign bit set
    ws, ns, want = [], [], []
    for wv in words:
        bits = [b for b in range(32) if (int(wv) >> b) & 1]
        for n, b in enumerate(bits):
            ws.append(wv)
            ns.append(n)
            want.append(b)
    got = _nth_set_bit(jnp.asarray(np.asarray(ws, np.uint32).view(np.int32)),
                       jnp.asarray(ns, jnp.int32))
    np.testing.assert_array_equal(np.asarray(got), want)


def test_planar_woop_layout(scene_geo):
    """Row 4a+j of cluster c holds woop[c, :, a, j] for every triangle."""
    _, _, bvh = scene_geo
    w = np.asarray(planar_woop(bvh.clusters))
    woop = np.asarray(bvh.clusters.woop)
    c, k = woop.shape[:2]
    assert w.shape == (c, 12, k) and w.dtype == np.float32
    for a in range(3):
        for j in range(4):
            np.testing.assert_array_equal(w[:, 4 * a + j, :],
                                          woop[:, :, a, j])


def test_kernel_renders_whitted_frame():
    """The kernel path through the renderer-facing factories: a small
    Whitted frame (shadows + a mirror bounce) matches brute force."""
    from directx_raytracer.render import render_whitted

    scene = testscenes.bench_scene(n_tris=2_000, width=64, height=32)
    d = build_device_scene(scene)
    bvh = build_bvh(d.geometry)
    d.geometry.accel = bvh
    pos, rot = scene.camera.snapshot()
    img, _ = render_whitted(
        d, pos, rot, 64, 32, max_depth=2,
        intersect_fn=make_bvh_intersect_fn(bvh, "kernel", interpret=True),
        occluder_factory=make_bvh_occluder_factory(bvh, "kernel",
                                                   interpret=True))
    ref, _ = render_whitted(d, pos, rot, 64, 32, max_depth=2)
    bad = (np.abs(np.asarray(img) - np.asarray(ref)) > 2 / 255).any(-1)
    assert bad.mean() < 0.01, f"{bad.mean():.2%} of pixels differ"
