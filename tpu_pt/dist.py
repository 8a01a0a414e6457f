"""Multi-chip rendering over a device mesh.

The replacement for the reference's multi-GPU scaffolding: the 8x4
round-robin tile assignment of ``StaticWorkDistribution``
(``sutil/WorkDistribution.h:34-90``) becomes row-tile sharding of the frame
over a ``tile`` mesh axis, and the ZERO_COPY/CUDA_P2P frame assembly modes of
``CUDAOutputBuffer`` (``sutil/CUDAOutputBuffer.h:45-51``) become XLA
collectives (NCCL between the cards of a host): samples are additionally
sharded over an ``spp`` axis and combined with ``psum`` (BASELINE.json
config 5). The cards of a host reach each other all to all at one rate,
so the mesh is a plain reshape of the device list. The accumulation buffer
stays sharded and device-resident across frames.

Because the RNG is counter-based, an (n_tile x n_spp)-sharded render
traces the same (pixel, sample) set as the single-device render. A
tile-only mesh gives the single-device accumulator bitwise on the GPU
(``chip_smoke.py`` phases d and g check it); an spp mesh's ``psum``
reorders each pixel's sample mean.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import film
from .config import RenderConfig
from .render import CameraArrays, RenderStats, render_wavefront
from .scene.arrays import SceneArrays


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join a multi-host render job (SURVEY §5.8).

    Extends the reference's single-host P2P/ZERO_COPY frame assembly
    (``sutil/CUDAOutputBuffer.h:45-51``) across hosts: every host's
    devices join one global ``jax.distributed`` job and the frame is
    sharded over a process-spanning mesh (see :func:`multihost_mesh`).
    Pass the coordinator address (``host:port``), process count and this
    process's id explicitly. Idempotent.
    """
    # Probe the distributed client directly: jax.process_count() would
    # itself initialize the XLA backend, which must not happen before
    # jax.distributed.initialize().
    from jax._src import distributed as _dist_state
    if (_dist_state.global_state.client is not None
            or getattr(init_multihost, "_done", False)):
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    init_multihost._done = True


def multihost_mesh(n_spp: int = 1) -> Mesh:
    """A (tile, spp) mesh spanning processes: tile across hosts, spp
    within one.

    Tiles are embarrassingly parallel (each device renders its own pixel
    rows; the only cross-tile traffic is the per-frame stats psum), so the
    tile axis goes on the slow network between hosts — one process == one
    or more tile rows. The spp axis carries the per-pixel ``psum`` of
    sample means every frame, so it stays inside a process, between the
    cards of one host. With one process this degrades to
    :func:`device_mesh`'s layout.
    """
    from jax.experimental import mesh_utils
    n_proc = jax.process_count()
    local = jax.local_device_count()
    assert local % n_spp == 0, (local, n_spp)
    # process_is_granule: one process == one host.
    dev_array = mesh_utils.create_hybrid_device_mesh(
        (local // n_spp, n_spp), (n_proc, 1), process_is_granule=True)
    return Mesh(dev_array, ("tile", "spp"))


def gather_frame(frame_u8: jnp.ndarray) -> jnp.ndarray:
    """Assemble the full frame on every host (addressable copy).

    The cross-host analog of CUDAOutputBuffer's getHostPointer: the
    row-sharded device frame becomes a host numpy array each process can
    write to disk / display. Single-process callers get a plain transfer.
    """
    if jax.process_count() == 1:
        return jax.device_get(frame_u8)
    from jax.experimental import multihost_utils
    return jax.device_get(
        multihost_utils.process_allgather(frame_u8, tiled=True))


def device_mesh(n_tile: int | None = None, n_spp: int | None = None,
                devices=None) -> Mesh:
    """Build a (tile, spp) mesh. Defaults: split samples 2-way when the
    device count is even, tiles take the rest."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_tile is None and n_spp is None:
        n_spp = 2 if n % 2 == 0 and n > 1 else 1
        n_tile = n // n_spp
    elif n_tile is None:
        n_tile = n // n_spp
    elif n_spp is None:
        n_spp = n // n_tile
    assert n_tile * n_spp == n, (n_tile, n_spp, n)
    import numpy as np
    dev_array = np.asarray(devices).reshape(n_tile, n_spp)
    return Mesh(dev_array, ("tile", "spp"))


def _render_block(scene, cam, cfg_local: RenderConfig, frame_idx, n_spp,
                  pixels_per_tile, wavefront_fn, accum_block):
    """Per-device body: render this device's pixel rows with its sample
    shard, psum sample means over the spp axis, fold into the accumulator."""
    spp_shard = jax.lax.axis_index("spp")
    tile_shard = jax.lax.axis_index("tile")
    offset = spp_shard.astype(jnp.uint32) * jnp.uint32(cfg_local.spp)
    pixel_start = tile_shard.astype(jnp.uint32) * jnp.uint32(pixels_per_tile)
    rad, stats = wavefront_fn(scene, cam, cfg_local, pixel_start,
                              pixels_per_tile, frame_idx,
                              sample_offset=offset)
    # Mean of per-shard means == global mean (equal shard sizes).
    rad = jax.lax.psum(rad, "spp") / n_spp
    stats = jax.tree.map(lambda x: jax.lax.psum(x, ("tile", "spp")), stats)

    rows = pixels_per_tile // cfg_local.width
    frame = rad.reshape(rows, cfg_local.width, 3)
    new_accum = film.accumulate(accum_block, frame, frame_idx)
    frame_u8 = film.make_color(new_accum)
    return new_accum, frame_u8, stats


def make_sharded_renderer(scene, cfg: RenderConfig, mesh: Mesh,
                          wavefront_fn=None):
    """Compile a progressive frame step sharded over ``mesh``.

    Returns ``step(cam, frame_idx, accum) -> (accum, frame_u8, stats)`` where
    ``accum`` is [H, W, 3] sharded over rows. Use :func:`init_accum_sharded`
    to create it.

    ``scene`` is a ``SceneArrays`` (path tracer) or a ``WhittedScene``
    (direct-lighting pipeline) — the integrator dispatches on the scene
    type; the reference's multi-GPU scaffold is likewise
    pipeline-agnostic (``sutil/WorkDistribution.h:34-90``). Pass
    ``wavefront_fn`` explicitly to override (same signature as
    ``render.render_wavefront``).
    """
    if wavefront_fn is None:
        if isinstance(scene, SceneArrays):
            wavefront_fn = render_wavefront
        else:
            from .whitted import render_whitted_wavefront
            wavefront_fn = render_whitted_wavefront
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    assert cfg.height % n_tile == 0, (cfg.height, n_tile)
    assert cfg.spp % n_spp == 0, (cfg.spp, n_spp)
    cfg_local = cfg.with_(spp=cfg.spp // n_spp)

    stats_spec = RenderStats(rays_traced=P(), shadow_rays=P(),
                             done_histogram=P(), wavefront_iterations=P())

    pixels_per_tile = cfg.width * cfg.height // n_tile

    def step(scene, cam: CameraArrays, frame_idx, accum):
        body = partial(_render_block, scene, cam, cfg_local, frame_idx,
                       n_spp, pixels_per_tile, wavefront_fn)
        # check_vma=False: the intersection scans init their carries from
        # constants, which JAX 0.9's varying-manual-axes analysis rejects
        # inside shard_map; the math is shard-local either way.
        sharded = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P("tile", None, None),),
            out_specs=(P("tile", None, None), P("tile", None, None),
                       stats_spec),
            check_vma=False,
        )
        return sharded(accum)

    # The scene is an argument of the compiled step, placed once on every
    # device of the mesh: closed over, its tables would be constants of
    # the program, and XLA would fold the scene-derived arithmetic on the
    # host, rounding differently from the device code of ``render_frame``.
    scene = jax.device_put(scene, NamedSharding(mesh, P()))
    return partial(jax.jit(step, donate_argnums=(3,)), scene)


def init_accum_sharded(cfg: RenderConfig, mesh: Mesh) -> jnp.ndarray:
    """Row-sharded accumulation buffer resident across the mesh."""
    sharding = NamedSharding(mesh, P("tile", None, None))
    return jax.device_put(jnp.zeros((cfg.height, cfg.width, 3), jnp.float32),
                          sharding)
