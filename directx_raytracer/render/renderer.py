"""Renderer — the orchestration layer (the ``DXRTRenderer`` analog).

The reference's renderer (DXRTRenderer.{h,cpp}, 258+1409 LoC) owns device
setup, geometry upload, acceleration-structure build, pipeline state and the
per-frame dispatch.  Here they collapse into a small object:

* device selection      -> jax.devices() (``describe_devices``)
* geometry upload       -> build_device_scene (one-time SoA flatten)
* BLAS/TLAS build       -> bvh.build_bvh (Morton clusters + planar operands)
* RTPSO + SBT           -> jitted render functions (compiled on first frame)
* camera/debug CBs      -> (position, rotation) snapshot + traced mode int
* DispatchRays          -> render_frame()/render_whitted_frame()

The intersection path comes from ``bvh.intersect_method``: the Pallas tile
kernel on the GPU, the XLA clustered walker on the CPU, or brute force for
tiny scenes.
"""

from __future__ import annotations

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..bvh import (build_bvh, intersect_method, make_bvh_intersect_fn,
                   make_bvh_occluder_factory)
from ..models.scene import Scene, build_device_scene
from ..ops.debug_shading import MODE_NAMES
from ..utils import checks
from .debug import render_debug
from .whitted import render_whitted, render_whitted_checked

log = logging.getLogger("directx_raytracer")


def describe_devices() -> str:
    """Device enumeration report (the ``printAdapters`` analog,
    Application.cpp:13-46)."""
    lines = []
    for d in jax.devices():
        lines.append(
            f"{d.platform}:{d.id} {getattr(d, 'device_kind', '?')}"
        )
    return "\n".join(lines)


class FrameStats:
    """Per-second FPS / Mrays stat line (DXRTApp.cpp:82-90 analog)."""

    def __init__(self):
        self.frames = 0
        self.rays = 0
        self._t0 = time.perf_counter()
        self.fps = 0.0
        self.mrays = 0.0

    def tick(self, n_rays: int) -> bool:
        self.frames += 1
        self.rays += n_rays
        dt = time.perf_counter() - self._t0
        if dt >= 1.0:
            self.fps = self.frames / dt
            self.mrays = self.rays / dt / 1e6
            self.frames = 0
            self.rays = 0
            self._t0 = time.perf_counter()
            return True
        return False


class Renderer:
    def __init__(self, scene: Scene, width: int | None = None,
                 height: int | None = None, base_dir: str = "."):
        self.scene = scene
        # Honor the scene file's image size (the reference parses but
        # ignores it, hard-coding 1920x1080 — documented divergence).
        self.width = width or scene.settings.image_width
        self.height = height or scene.settings.image_height
        self.dscene = build_device_scene(scene, base_dir=base_dir)

        n_tris = self.dscene.geometry.n_tris
        self.method = intersect_method(n_tris)
        self.intersect_fn = None
        self.occluder_factory = None
        if self.method != "bruteforce":
            t0 = time.perf_counter()
            self.bvh = build_bvh(self.dscene.geometry)
            jax.block_until_ready(self.bvh.clusters.aabb_min)
            log.info("BVH: %d tris -> %d clusters in %.2fs (%s)",
                     n_tris, self.bvh.clusters.aabb_min.shape[0],
                     time.perf_counter() - t0, self.method)
            # Bind the accel to the geometry so it rides jit as an ARGUMENT
            # instead of being embedded in the program as constants.
            self.dscene.geometry.accel = self.bvh
            self.intersect_fn = make_bvh_intersect_fn(self.bvh, self.method)
            self.occluder_factory = make_bvh_occluder_factory(self.bvh,
                                                              self.method)
        else:
            self.bvh = None
            log.info("brute-force intersection (%d tris)", n_tris)
        self.stats = FrameStats()

    @property
    def camera(self):
        return self.scene.camera

    _u8_jit = staticmethod(jax.jit(
        lambda im: (jnp.clip(im, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)))

    def render_frame(self, mode: int = 0):
        """One debug-shaded frame (the reference's only executed path)."""
        pos, rot = self.camera.snapshot()
        img = render_debug(
            self.dscene, pos, rot, jnp.int32(mode), self.width, self.height,
            intersect_fn=self.intersect_fn,
            fetch_record=(mode <= 3),  # static: 2 cached variants
        )
        self.stats.tick(self.width * self.height)
        return img

    def render_whitted_frame(self, max_depth: int = 5, spp: int = 1):
        """One Whitted frame (the capability surface the reference parses
        but never executes — materials, lights, shadows, specular)."""
        pos, rot = self.camera.snapshot()
        fn = render_whitted_checked if checks.enabled() else render_whitted
        img, stats = fn(
            self.dscene, pos, rot, self.width, self.height,
            max_depth=max_depth, spp=spp,
            intersect_fn=self.intersect_fn,
            occluder_factory=self.occluder_factory,
        )
        self.stats.tick(self.width * self.height * spp)
        return img, stats

    def to_u8(self, img) -> np.ndarray:
        from ..utils.image import to_u8

        return to_u8(np.asarray(img))

    def to_u8_device(self, img):
        """UNORM u8 conversion ON DEVICE (same rounding as utils.image.to_u8)
        — returns a device array without syncing, so an interactive loop can
        overlap the host transfer of frame n with the dispatch of frame n+1."""
        return self._u8_jit(img)

    @staticmethod
    def mode_name(mode: int) -> str:
        return MODE_NAMES[mode]
