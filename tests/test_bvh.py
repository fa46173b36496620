"""LBVH invariants + traversal == brute force (SURVEY.md §4 test strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from directx_raytracer import testscenes
from directx_raytracer.bvh import (
    build_bvh,
    build_clusters,
    build_lbvh,
    intersect_clustered,
    make_bvh_intersect_fn,
    make_bvh_occluder_factory,
    occluded_clustered,
    traverse_closest,
    traverse_occluded,
)
from directx_raytracer.models.scene import build_device_scene
from directx_raytracer.ops.intersect import intersect_bruteforce, occluded_bruteforce
from directx_raytracer.ops.rays import generate_rays


def _scene_geo(scene):
    return build_device_scene(scene).geometry


def _rays(scene, w=48, h=36):
    return generate_rays(scene.camera.position, scene.camera.rotation, w, h)


class TestInvariants:
    @pytest.mark.parametrize("n_tris", [1, 2, 7, 100, 1000])
    def test_structure(self, n_tris):
        geo = _scene_geo(testscenes.random_soup(n_tris, seed=n_tris))
        bvh = build_lbvh(geo)
        t = bvh.n_tris
        # device slots: treelet leaves padded to CLUSTER_K (sentinels never hit)
        assert t == geo.n_tris and geo.n_real_tris == n_tris
        left = np.asarray(bvh.left)
        skip = np.asarray(bvh.skip)

        # Every triangle appears exactly once in the sorted order.
        assert sorted(np.asarray(bvh.order).tolist()) == list(range(t))

        if t == 1:
            return
        n_nodes = 2 * t - 1
        # Walk the skip-threaded tree from the root; every node must be
        # visited exactly once when we always descend.
        visited = np.zeros(n_nodes, bool)
        cur = bvh.root
        steps = 0
        while cur != -1 and steps <= n_nodes + 1:
            assert not visited[cur]
            visited[cur] = True
            cur = left[cur] if left[cur] != -1 else skip[cur]
            steps += 1
        assert visited.all()

    @pytest.mark.parametrize("n_tris", [2, 50, 500])
    def test_parent_aabbs_contain_children(self, n_tris):
        geo = _scene_geo(testscenes.random_soup(n_tris, seed=7 * n_tris + 1))
        bvh = build_lbvh(geo)
        t = bvh.n_tris
        amin = np.asarray(bvh.aabb_min)
        amax = np.asarray(bvh.aabb_max)
        left = np.asarray(bvh.left)[: t - 1]
        skip = np.asarray(bvh.skip)
        # For internal node i: children are left[i] and its sibling skip[left[i]].
        right = skip[left]
        for i in range(t - 1):
            for c in (left[i], right[i]):
                assert (amin[i] <= amin[c] + 1e-6).all()
                assert (amax[i] >= amax[c] - 1e-6).all()

    def test_leaf_aabbs_are_triangle_bounds(self):
        geo = _scene_geo(testscenes.random_soup(64, seed=3))
        bvh = build_lbvh(geo)
        t = bvh.n_tris
        p0 = np.asarray(bvh.v0)
        p1 = p0 + np.asarray(bvh.e1)
        p2 = p0 + np.asarray(bvh.e2)
        lo = np.minimum(np.minimum(p0, p1), p2)
        hi = np.maximum(np.maximum(p0, p1), p2)
        np.testing.assert_allclose(np.asarray(bvh.aabb_min)[t - 1 :], lo, atol=1e-6)
        np.testing.assert_allclose(np.asarray(bvh.aabb_max)[t - 1 :], hi, atol=1e-6)


class TestTraversalEqualsBruteForce:
    @pytest.mark.parametrize("n_tris,seed", [(1, 0), (13, 1), (300, 2), (2000, 3)])
    def test_closest_hit_matches(self, n_tris, seed):
        scene = testscenes.random_soup(n_tris, seed=seed)
        geo = _scene_geo(scene)
        o, d = _rays(scene)
        ref = intersect_bruteforce(o, d, geo.woop)
        bvh = build_lbvh(geo)
        got = traverse_closest(o, d, bvh)
        ref_hit = np.asarray(ref.tri >= 0)
        got_hit = np.asarray(got.tri >= 0)
        np.testing.assert_array_equal(got_hit, ref_hit)
        # Same triangle except near-exact ties; t always matches.
        np.testing.assert_allclose(
            np.asarray(got.t)[got_hit], np.asarray(ref.t)[ref_hit], rtol=1e-3
        )
        same_tri = np.asarray(got.tri) == np.asarray(ref.tri)
        if got_hit.any():
            assert same_tri[got_hit].mean() > 0.99

    def test_structured_scene_matches(self):
        scene = testscenes.bench_scene(n_tris=5000, width=64, height=36)
        geo = _scene_geo(scene)
        o, d = generate_rays(scene.camera.position, scene.camera.rotation, 64, 36)
        ref = intersect_bruteforce(o, d, geo.woop)
        got = traverse_closest(o, d, build_lbvh(geo))
        np.testing.assert_array_equal(np.asarray(got.tri >= 0), np.asarray(ref.tri >= 0))
        hits = np.asarray(ref.tri >= 0)
        np.testing.assert_allclose(
            np.asarray(got.t)[hits], np.asarray(ref.t)[hits], rtol=1e-3
        )

    def test_occlusion_matches(self):
        scene = testscenes.random_soup(200, seed=11)
        geo = _scene_geo(scene)
        o, d = _rays(scene, 32, 24)
        t_max = jnp.full((o.shape[0],), 40.0)
        ref = occluded_bruteforce(o, d, geo.woop, t_max)
        got = traverse_occluded(o, d, build_lbvh(geo), t_max)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


class TestClusteredEqualsBruteForce:
    @pytest.mark.parametrize("n_tris,seed,k", [(13, 1, 128), (300, 2, 64), (2000, 3, 128)])
    def test_closest_hit_matches(self, n_tris, seed, k):
        scene = testscenes.random_soup(n_tris, seed=seed)
        geo = _scene_geo(scene)
        o, d = _rays(scene)
        ref = intersect_bruteforce(o, d, geo.woop)
        cs = build_clusters(geo, k=k)
        got = intersect_clustered(o, d, cs)
        np.testing.assert_array_equal(np.asarray(got.tri >= 0), np.asarray(ref.tri >= 0))
        hits = np.asarray(ref.tri >= 0)
        np.testing.assert_allclose(
            np.asarray(got.t)[hits], np.asarray(ref.t)[hits], rtol=1e-3
        )

    def test_occlusion_matches(self):
        scene = testscenes.random_soup(200, seed=11)
        geo = _scene_geo(scene)
        o, d = _rays(scene, 32, 24)
        t_max = jnp.full((o.shape[0],), 40.0)
        ref = occluded_bruteforce(o, d, geo.woop, t_max)
        got = occluded_clustered(o, d, build_clusters(geo), t_max)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    def test_per_ray_t_max_respected(self):
        # Rays with a short t_max must miss geometry beyond it.
        scene = testscenes.random_soup(100, seed=5)
        geo = _scene_geo(scene)
        o, d = _rays(scene, 16, 12)
        cs = build_clusters(geo)
        far = intersect_clustered(o, d, cs)
        near = intersect_clustered(
            o, d, cs, t_max=jnp.full((o.shape[0],), 1.0)
        )
        np.testing.assert_array_equal(
            np.asarray(near.tri >= 0),
            np.asarray((far.tri >= 0) & (far.t < 1.0)),
        )


class TestRendererIntegration:
    def test_whitted_with_bvh_matches_bruteforce(self):
        from directx_raytracer.render import render_whitted

        scene = testscenes.cornell_box(48, 32)
        d = build_device_scene(scene)
        bvh = build_bvh(d.geometry)
        # XLA clustered path (the tile kernel runs here only in the
        # interpreter: see test_pallas_interpret.py).
        img_bvh, _ = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 48, 32, max_depth=2,
            intersect_fn=make_bvh_intersect_fn(bvh, "clustered"),
            occluder_factory=make_bvh_occluder_factory(bvh, "clustered"),
        )
        img_ref, _ = render_whitted(
            d, scene.camera.position, scene.camera.rotation, 48, 32, max_depth=2
        )
        a, b = np.asarray(img_bvh), np.asarray(img_ref)
        # Shared-edge hits may resolve to either coincident triangle
        # (different winner between intersectors); allow a handful of pixels.
        mismatch = (np.abs(a - b) > 1e-4).any(axis=-1)
        assert mismatch.mean() < 0.002, f"{mismatch.sum()} mismatched pixels"


class TestBinnerOracleEquivalence:
    """The production sort-free bit-walk binner must schedule exactly the
    visit set of the independently-derived sorted oracle."""

    def test_bits_visit_sets_match_sorted_oracle(self):
        from directx_raytracer.bvh.binning_oracle import bin_clusters
        from directx_raytracer.bvh.pallas_intersect import (
            bin_clusters_bits,
        )
        from directx_raytracer.ops.rays import generate_rays_tiled

        scene = testscenes.bench_scene(n_tris=5_000, width=96, height=48)
        d = build_device_scene(scene)
        bvh = build_bvh(d.geometry)
        pos, rot = scene.camera.snapshot()
        o, dd = generate_rays_tiled(jnp.asarray(pos), jnp.asarray(rot),
                                    96, 48, 8, 8)
        tiles = o.shape[0] // 64
        ot = o.reshape(tiles, 64, 3)
        dt = dd.reshape(tiles, 64, 3)

        ids, _, counts_s = bin_clusters(ot, dt, bvh.clusters)
        words, cum, entry, counts_b = bin_clusters_bits(ot, dt, bvh.clusters)

        np.testing.assert_array_equal(np.asarray(counts_s),
                                      np.asarray(counts_b))
        ids_n = np.asarray(ids)
        counts_n = np.asarray(counts_s)
        words_n = np.asarray(words)
        c = bvh.clusters.aabb_min.shape[0]
        assert counts_n.sum() > 0, "vacuous: no overlaps binned"
        for t in range(tiles):
            sorted_set = set(ids_n[t, : counts_n[t]].tolist())
            bit_set = {
                w * 32 + b
                for w in range(words_n.shape[1])
                for b in range(32)
                if (words_n[t, w] >> b) & 1
            }
            assert bit_set == sorted_set, f"tile {t} visit sets differ"
            assert all(cl < c for cl in bit_set)


class TestIntersectMethod:
    """One function picks the intersection path from the platform and the
    scene size; a platform without a compiled path fails loudly."""

    @pytest.mark.parametrize("backend,n_tris,want", [
        ("gpu", 100_000, "kernel"),
        ("gpu", 513, "kernel"),
        ("cpu", 100_000, "clustered"),
        ("gpu", 512, "bruteforce"),
        ("cpu", 12, "bruteforce"),
    ])
    def test_choice(self, backend, n_tris, want):
        from directx_raytracer.bvh import intersect_method

        assert intersect_method(n_tris, backend) == want

    @pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
    def test_unknown_platform_has_no_fallback(self, backend):
        from directx_raytracer.bvh import intersect_method

        with pytest.raises(ValueError, match="no intersection path"):
            intersect_method(100_000, backend)

    def test_default_backend_is_this_process(self):
        import jax

        from directx_raytracer.bvh import intersect_method

        assert intersect_method(10_000) == intersect_method(
            10_000, jax.default_backend())

    def test_factories_reject_unknown_method(self):
        geo = _scene_geo(testscenes.random_soup(50, seed=2))
        bvh = build_bvh(geo)
        with pytest.raises(ValueError, match="unknown BVH"):
            make_bvh_intersect_fn(bvh, "bruteforce")
        with pytest.raises(ValueError, match="unknown BVH"):
            make_bvh_occluder_factory(bvh, "pallas")

    def test_renderer_takes_the_platform_path(self):
        from directx_raytracer.render.renderer import Renderer

        big = Renderer(testscenes.bench_scene(n_tris=2_000, width=32,
                                              height=16))
        assert big.method == "clustered" and big.bvh is not None
        img = np.asarray(big.render_frame(mode=5))
        assert img.shape == (16, 32, 3) and np.isfinite(img).all()
        small = Renderer(testscenes.cornell_box(32, 16))
        assert small.method == "bruteforce" and small.bvh is None
