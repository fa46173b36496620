"""Multi-chip rendering: ray/tile + sample sharding over a jax.sharding.Mesh.

The reference is single-GPU — its only "parallelism" is the hardware's
per-pixel thread fan-out (``DispatchRays`` 1920x1080, DXRTRenderer.cpp:1348).
Rays are mutually independent, so the scaling story (SURVEY.md §2e) is
pure data parallelism with two meaningful axes:

* ``tiles`` — the pixel-row axis: each chip renders a horizontal stripe of
  the frame.  Scene buffers are replicated (a 100k-tri scene is ~20 MB —
  trivially replicable), framebuffer tiles stay chip-local, and shard_map's
  output spec reassembles the frame with no collective at all.
* ``samples`` — the subpixel/AA axis: chips render the *same* tile with
  different sample offsets and ``psum`` their framebuffers (XLA hands the
  collective to NCCL over NVLink) — the progressive-accumulation pattern
  (and the only cross-device reduction a ray tracer needs).

Both axes compose in one 2-D mesh: chips at (t, s) render stripe t with
sample subset s; one psum over 'samples' finishes the frame.  The mesh
follows the algorithm, not a physical topology: every card reaches every
other at the same rate.  No TP/PP-style decomposition applies — there is no
sequential dependency to pipeline and no giant weight matrix to shard.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.scene import DeviceScene
from ..render.whitted import render_tile, spp_offsets


def make_mesh(n_tiles: int | None = None, n_samples: int = 1, devices=None) -> Mesh:
    """Build a (tiles, samples) device mesh; defaults to all-local devices on
    the tile axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_tiles is None:
        n_tiles = devices.size // n_samples
    return Mesh(devices.reshape(n_tiles, n_samples), axis_names=("tiles", "samples"))


@partial(
    jax.jit,
    static_argnames=("width", "height", "max_depth", "spp", "mesh", "intersect_fn",
                     "occluder_factory", "queue_factor"),
)
def render_whitted_multichip(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    width: int,
    height: int,
    mesh: Mesh,
    max_depth: int = 5,
    spp: int = 1,
    intersect_fn=None,
    occluder_factory=None,
    queue_factor: int | None = None,
):
    """Whitted frame sharded over a (tiles, samples) mesh.

    Neither axis needs to divide evenly: the row-stripe axis pads to
    ceil(height / n_tiles) rows per chip (the surplus rows are rendered
    below the frustum and cropped — 1080 rows on a 16-chip tile axis just
    works), and the sample axis pads the offset table with zero-weight
    dummy samples (traced per-offset weights, so padding contributes
    nothing).

    Returns ((H, W, 3) image, stats) with the image laid out across chips by
    row stripe (replicated over 'samples' after the psum).
    """
    n_tiles = mesh.shape["tiles"]
    n_samples = mesh.shape["samples"]
    rows = -(-height // n_tiles)  # ceil: last stripe may render cropped rows
    offs = np.asarray(spp_offsets(spp), np.float32)
    weight = 1.0 / len(offs)
    per_shard = -(-len(offs) // n_samples)
    o_pad = per_shard * n_samples - len(offs)
    offw = np.concatenate([np.ones(len(offs), np.float32),
                           np.zeros(o_pad, np.float32)])
    if o_pad:
        offs = np.concatenate(
            [offs, np.full((o_pad, 2), 0.5, np.float32)], axis=0)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P("samples"), P("samples")),
        out_specs=(P("tiles"), P()),
        check_vma=False,
    )
    def shard_fn(scene, pos, rot, offsets, offset_weights):
        t = jax.lax.axis_index("tiles")
        img, stats = render_tile(
            scene, pos, rot, width, height,
            offsets=offsets, weight=weight,
            row_start=t * rows, rows=rows, max_depth=max_depth,
            intersect_fn=intersect_fn, occluder_factory=occluder_factory,
            queue_factor=queue_factor, offset_weights=offset_weights,
        )
        # Sample-axis accumulation; stats aggregate over everything.
        img = jax.lax.psum(img, "samples")
        stats = jax.tree.map(lambda x: jax.lax.psum(x, ("tiles", "samples")), stats)
        return img, stats

    # Each sample shard gets its contiguous slice of the offset table.
    img, stats = shard_fn(dscene, jnp.asarray(cam_position, jnp.float32),
                          jnp.asarray(cam_rotation, jnp.float32),
                          jnp.asarray(offs), jnp.asarray(offw))
    return img[:height], stats


@partial(
    jax.jit,
    static_argnames=("width", "height", "max_depth", "spp", "mesh",
                     "intersect_fn", "occluder_factory"),
)
def pathtrace_multichip(
    dscene: DeviceScene,
    cam_position,
    cam_rotation,
    key,
    width: int,
    height: int,
    mesh: Mesh,
    spp: int = 1,
    max_depth: int = 6,
    intersect_fn=None,
    occluder_factory=None,
):
    """``spp`` path-traced samples sharded over a (tiles, samples) mesh.

    Each chip renders its row stripe with an independent PRNG fold per
    (sample-shard, iteration); the progressive sum is a psum over the
    'samples' axis — the accumulation pattern of SURVEY.md §2e.

    Returns (H*W, 3) accumulated radiance (divide by ``spp``), laid out as
    per-stripe tile-major blocks — reassemble with ``untile_multichip``.
    """
    from ..render.pathtrace import pathtrace_tile

    n_tiles = mesh.shape["tiles"]
    n_samples = mesh.shape["samples"]
    # Neither axis needs to divide: rows pad to a ceil-stripe (cropped by
    # untile_multichip's caller), and spp rounds UP to a multiple of
    # n_samples — the returned sum is rescaled by spp/effective so callers
    # dividing by ``spp`` still get the unbiased mean over all samples
    # actually traced.
    rows = -(-height // n_tiles)
    local_spp = -(-spp // n_samples)
    effective_spp = local_spp * n_samples

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=P("tiles"),
        check_vma=False,
    )
    def shard_fn(scene, pos, rot, key):
        t = jax.lax.axis_index("tiles")
        s = jax.lax.axis_index("samples")
        key = jax.random.fold_in(jax.random.fold_in(key, t), s)
        acc = jnp.zeros((rows * width, 3), jnp.float32)
        for i in range(local_spp):
            k = jax.random.fold_in(key, i)
            acc = acc + pathtrace_tile(
                scene, pos, rot, k, width, height,
                row_start=t * rows, rows=rows, max_depth=max_depth,
                intersect_fn=intersect_fn, occluder_factory=occluder_factory,
            )
        return jax.lax.psum(acc, "samples") * (spp / effective_spp)

    return shard_fn(dscene, jnp.asarray(cam_position, jnp.float32),
                    jnp.asarray(cam_rotation, jnp.float32), key)


def untile_multichip(flat, width: int, height: int, n_tiles: int):
    """Per-stripe tile-major (H*W, 3) -> raster (H, W, 3).

    Stripes are ceil(height / n_tiles) rows each (matching the padded
    row-stripe sharding); surplus rows below the frustum are cropped.
    """
    from ..ops.rays import pick_tile
    from ..render.debug import untile

    rows = -(-height // n_tiles)
    tile = pick_tile(rows, width)  # must match pathtrace_tile's choice
    stripes = flat.reshape(n_tiles, rows * width, 3)
    return jnp.concatenate(
        [untile(s, width, rows, tile) for s in stripes], axis=0
    )[:height]
