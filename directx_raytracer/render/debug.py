"""Debug-mode frame renderer — the analog of the reference's DXR
dispatch path (``renderFrame``, DXRTRenderer.cpp:1370-1408): one primary ray
per pixel, closest hit, 7-mode procedural shade, miss = constant cyan.

Instead of a swapchain/UAV pipeline the whole frame is one jitted pure
function of (scene buffers, camera snapshot, mode) returning an (H, W, 3)
f32 image; resolution is static (compiled per size), the shading mode is a
traced int so switching modes never recompiles (the reference's equivalent
knob is a constant-buffer write, DXRTRenderer.cpp:272-300).

Rays are generated directly in tile-major order (coherent tiles feed the
binned BVH intersector), per-hit attributes come from ONE wide packed-record
gather, and the tile->raster reorder at the end is a pure reshape/transpose
— the pipeline contains no narrow 2M-row gathers or scatters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.scene import DeviceScene
from ..ops.debug_shading import MISS_COLOR, shade_debug
from ..ops.intersect import hit_record, intersect_bruteforce
from ..ops.rays import generate_rays, generate_rays_tiled, pick_tile


def untile(flat, width: int, height: int, tile):
    """Tile-major (H*W, C) -> raster (H, W, C) via reshape/transpose."""
    if tile is None:
        return flat.reshape(height, width, -1)
    th, tw = tile
    c = flat.shape[-1]
    return (
        flat.reshape(height // th, width // tw, th, tw, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(height, width, c)
    )


@partial(jax.jit, static_argnames=("width", "height", "intersect_fn",
                                   "fetch_record"))
def render_debug(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    mode,
    width: int,
    height: int,
    intersect_fn=None,
    fetch_record: bool = True,
):
    """Render one debug-shaded frame.

    Args:
      dscene: device scene pytree.
      cam_position, cam_rotation: camera snapshot ((3,), (3,3)).
      mode: i32 scalar 0..6 (traced — no recompile on change).
      intersect_fn: optional override (e.g. the BVH intersector) with the
        signature (origins, dirs, geometry) -> Hit; defaults to brute force.
      fetch_record: STATIC — fetch the fused hit record (exact t/u/v + ids,
        needed by modes 0-3).  Callers that know the mode as a Python int
        pass ``mode <= 3`` to skip the frame's costliest gather for the
        distance/height/checker modes.

    Returns:
      (H, W, 3) f32 image in [0, 1].
    """
    geo = dscene.geometry
    tile = pick_tile(height, width)
    if tile is None:
        origins, dirs = generate_rays(cam_position, cam_rotation, width, height)
    else:
        origins, dirs = generate_rays_tiled(
            cam_position, cam_rotation, width, height, tile[0], tile[1]
        )
    if intersect_fn is None:
        hit = intersect_bruteforce(origins, dirs, geo.woop)
    else:
        hit = intersect_fn(origins, dirs, geo)

    # Modes 4-6 consume only the hit distance; the fused-record gather +
    # exact re-intersection exists for ids (modes 0-2) and barycentrics
    # (mode 3).  The row gather is gated by the STATIC ``fetch_record``
    # flag: callers that know the mode as a Python int (viewer, bench) pass
    # ``mode <= 3`` and get two cached compiled variants — still no
    # recompile when browsing modes.
    if fetch_record:
        hit2, local_id, mesh_id, _, _ = hit_record(origins, dirs, geo.packed,
                                                   hit)
        t, u, v = hit2.t, hit2.u, hit2.v
    else:
        zero = jnp.zeros_like(hit.t, dtype=jnp.int32)
        t, u, v, local_id, mesh_id = hit.t, hit.u, hit.v, zero, zero

    color = shade_debug(mode, origins, dirs, t, u, v, local_id, mesh_id)
    miss = jnp.array(MISS_COLOR, jnp.float32)
    color = jnp.where(hit.mask[:, None], color, miss)
    return untile(color, width, height, tile)
