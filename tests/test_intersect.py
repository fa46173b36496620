"""Woop-matmul intersection vs the Möller-Trumbore oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from directx_raytracer.models.mesh import Mesh
from directx_raytracer.models.scene import build_geometry, _woop_transforms
from directx_raytracer.ops import intersect as isect


def _random_geometry(n_tris, seed=0, spread=5.0):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    return v0, e1, e2


def _random_rays(n_rays, seed=1, spread=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_woop_matches_moller_trumbore():
    v0, e1, e2 = _random_geometry(64)
    o, d = _random_rays(128)
    woop = _woop_transforms(v0, e1, e2)

    tt, u, v, valid = isect.intersect_block(jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop))

    mt = jax.vmap(
        lambda oo, dd: jax.vmap(
            lambda a, b, c: isect.moller_trumbore(oo, dd, a, b, c)
        )(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    )(jnp.asarray(o), jnp.asarray(d))
    mt_t, mt_u, mt_v, mt_hit = (np.asarray(x) for x in mt)

    valid = np.asarray(valid)
    # Ignore borderline hits where f32 roundoff flips the inequality tests.
    margin = (
        (np.abs(mt_u) > 1e-4)
        & (np.abs(mt_v) > 1e-4)
        & (np.abs(1 - mt_u - mt_v) > 1e-4)
        & (np.abs(mt_t - isect.T_MIN) > 1e-4)
    )
    agree = (valid == mt_hit) | ~margin
    assert agree.mean() > 0.9999, f"mask disagreement {1 - agree.mean():.2e}"

    both = valid & mt_hit
    np.testing.assert_allclose(np.asarray(tt)[both], mt_t[both], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(u)[both], mt_u[both], rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(v)[both], mt_v[both], rtol=2e-2, atol=2e-2)


def test_refine_hit_restores_precision():
    """After the Woop search, refine_hit's per-winner Möller-Trumbore pass
    must match the MT oracle tightly even on sliver triangles."""
    v0, e1, e2 = _random_geometry(64)
    o, d = _random_rays(128)
    woop = _woop_transforms(v0, e1, e2)
    hit = isect.intersect_bruteforce(jnp.asarray(o), jnp.asarray(d), jnp.asarray(woop),
                                     tri_block=64)
    refined = isect.refine_hit(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), hit)
    tri = np.asarray(hit.tri)
    mask = tri >= 0
    idx = tri[mask]
    oo, dd = jnp.asarray(o[mask]), jnp.asarray(d[mask])
    mt = jax.vmap(isect.moller_trumbore)(
        oo, dd, jnp.asarray(v0[idx]), jnp.asarray(e1[idx]), jnp.asarray(e2[idx])
    )
    mt_t, mt_u, mt_v, _ = (np.asarray(x) for x in mt)
    np.testing.assert_allclose(np.asarray(refined.t)[mask], mt_t, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(refined.u)[mask], mt_u, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(refined.v)[mask], mt_v, rtol=1e-5, atol=1e-5)


def test_single_triangle_analytic():
    v0 = np.array([[-1.0, -1.0, 0.0]], np.float32)
    e1 = np.array([[2.0, 0.0, 0.0]], np.float32)  # v1 = (1,-1,0)
    e2 = np.array([[1.0, 2.0, 0.0]], np.float32)  # v2 = (0,1,0)
    woop = jnp.asarray(_woop_transforms(v0, e1, e2))

    o = jnp.array([[0.0, -0.333, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit = isect.intersect_bruteforce(o, d, woop, tri_block=1)
    assert int(hit.tri[0]) == 0
    assert float(hit.t[0]) == np.float32(3.0)
    # point (0,-0.333,0) = v0 + u*e1 + v*e2 -> v = 0.3335, u = (1-v)/2 = 0.33325
    np.testing.assert_allclose(float(hit.u[0]), 0.33325, atol=1e-4)
    np.testing.assert_allclose(float(hit.v[0]), 0.33350, atol=1e-4)

    # ray missing the triangle
    miss = isect.intersect_bruteforce(
        jnp.array([[5.0, 5.0, 3.0]]), d, woop, tri_block=1
    )
    assert int(miss.tri[0]) == -1
    assert np.isinf(float(miss.t[0]))


def test_closest_hit_among_stacked_triangles():
    # Two triangles facing +z at z=0 and z=-2; ray from z=+3 must hit z=0 one.
    base_v0 = np.array([-1.0, -1.0, 0.0], np.float32)
    v0 = np.stack([base_v0 + [0, 0, -2], base_v0])  # farther one FIRST
    e1 = np.tile(np.array([[2.0, 0.0, 0.0]], np.float32), (2, 1))
    e2 = np.tile(np.array([[1.0, 2.0, 0.0]], np.float32), (2, 1))
    woop = jnp.asarray(_woop_transforms(v0, e1, e2))

    o = jnp.array([[0.0, -0.5, 3.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit = isect.intersect_bruteforce(o, d, woop, tri_block=2)
    assert int(hit.tri[0]) == 1
    assert float(hit.t[0]) == np.float32(3.0)


def test_padding_never_hits():
    mesh = Mesh(
        vertices=np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32),
        indices=np.array([0, 1, 2], np.int32),
    )
    geo = build_geometry([mesh])
    assert geo.woop.shape[0] == 128
    o, d = _random_rays(256, seed=3)
    hit = isect.intersect_bruteforce(jnp.asarray(o), jnp.asarray(d), jnp.asarray(geo.woop))
    tri = np.asarray(hit.tri)
    assert np.all(tri < geo.n_tris)  # never a padded index


def test_tmin_respected():
    """TMin = 0.001 (hlsl:51): origin exactly on the triangle doesn't self-hit."""
    v0 = np.array([[-1.0, -1.0, 0.0]], np.float32)
    e1 = np.array([[2.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[1.0, 2.0, 0.0]], np.float32)
    woop = jnp.asarray(_woop_transforms(v0, e1, e2))
    o = jnp.array([[0.0, -0.5, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    hit = isect.intersect_bruteforce(o, d, woop, tri_block=1)
    assert int(hit.tri[0]) == -1
