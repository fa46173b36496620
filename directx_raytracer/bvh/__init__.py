"""Acceleration structures and the choice of intersection path.

``intersect_method`` is the one place that decides how rays meet triangles
on this platform; ``build_bvh`` / ``make_bvh_intersect_fn`` /
``make_bvh_occluder_factory`` are the renderer-facing API (drop-in for the
brute-force defaults in render/whitted.py and render/debug.py).
"""

import jax

from .clustered import (
    ClusterSet,
    build_clusters,
    intersect_clustered,
    occluded_clustered,
)
from .lbvh import LBVH, build_lbvh
from .pallas_intersect import intersect_pallas, occluded_pallas, planar_woop
from .traverse import traverse_closest, traverse_occluded

# Below this many triangles the dense brute-force sweep needs no BVH.
BRUTE_FORCE_MAX_TRIS = 512
# Rays per lax.map block of the XLA clustered walker.
CLUSTERED_BLOCK = 1536
# The BVH path each platform compiles: the Pallas tile kernel on the GPU,
# the XLA clustered walker on the CPU (the kernel runs there only in the
# interpreter, which tests ask for explicitly).
_BVH_METHODS = {"gpu": "kernel", "cpu": "clustered"}


def intersect_method(n_tris: int, backend: str | None = None) -> str:
    """'bruteforce', 'kernel' or 'clustered' for a scene of ``n_tris`` on
    ``backend`` (default: ``jax.default_backend()``).

    A platform without a compiled path is an error, never a fallback."""
    backend = backend or jax.default_backend()
    if backend not in _BVH_METHODS:
        raise ValueError(f"no intersection path for platform {backend!r}")
    if n_tris <= BRUTE_FORCE_MAX_TRIS:
        return "bruteforce"
    return _BVH_METHODS[backend]


class BVH:
    """Production acceleration structure: treelet clusters + the planar
    Woop operand the tile kernel reads.  (The per-node LBVH in lbvh.py is
    the correctness oracle.)

    Registered as a pytree so it can ride ``Geometry.accel`` through jit
    as an argument (see models/scene.py)."""

    def __init__(self, clusters: ClusterSet, wplanar):
        self.clusters = clusters
        self.wplanar = wplanar


jax.tree_util.register_pytree_node(
    BVH,
    lambda b: ((b.clusters, b.wplanar), None),
    lambda _, children: BVH(*children),
)


def build_bvh(geometry, k: int = 128) -> BVH:
    # k: triangles per cluster — balances cluster-level culling (binning
    # scales with the cluster count) against per-visit triangle waste.
    cs = build_clusters(geometry, k=k)
    return BVH(cs, planar_woop(cs))


def _accel(geometry, bvh: BVH) -> BVH:
    # Prefer the geometry-bound accel (a jit ARGUMENT); the closure fallback
    # embeds the arrays in the program as constants.
    return geometry.accel if getattr(geometry, "accel", None) is not None else bvh


def _check_method(method: str) -> None:
    if method not in ("kernel", "clustered"):
        raise ValueError(f"unknown BVH intersection method {method!r}")


def make_bvh_intersect_fn(bvh: BVH, method: str, interpret: bool = False):
    """(origins, dirs, geometry) -> Hit, closing over a prebuilt BVH.

    ``method``: 'kernel' (the Pallas tile kernel; ``interpret=True`` runs it
    in the interpreter) or 'clustered' (the XLA walker) — see
    :func:`intersect_method`."""
    _check_method(method)

    def intersect(origins, dirs, geometry):
        b = _accel(geometry, bvh)
        if method == "kernel":
            return intersect_pallas(origins, dirs, b.clusters, b.wplanar,
                                    interpret=interpret)
        return intersect_clustered(origins, dirs, b.clusters,
                                   block=CLUSTERED_BLOCK)

    return intersect


def make_bvh_occluder_factory(bvh: BVH, method: str, interpret: bool = False):
    """geometry -> (origins, dirs, max_t) -> bool occluder for shadow rays
    (``method`` as in :func:`make_bvh_intersect_fn`)."""
    _check_method(method)

    def factory(geometry):
        b = _accel(geometry, bvh)

        def occluded(origins, dirs, max_t):
            if method == "kernel":
                return occluded_pallas(origins, dirs, b.clusters, b.wplanar,
                                       max_t, interpret=interpret)
            return occluded_clustered(origins, dirs, b.clusters, max_t,
                                      block=CLUSTERED_BLOCK)

        return occluded

    return factory


__all__ = [
    "BRUTE_FORCE_MAX_TRIS",
    "BVH",
    "LBVH",
    "build_lbvh",
    "ClusterSet",
    "build_clusters",
    "intersect_clustered",
    "occluded_clustered",
    "intersect_method",
    "intersect_pallas",
    "occluded_pallas",
    "planar_woop",
    "build_bvh",
    "traverse_closest",
    "traverse_occluded",
    "make_bvh_intersect_fn",
    "make_bvh_occluder_factory",
]
