"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_pt
from tpu_pt import dist
from tpu_pt.render import CameraArrays, render_frame, init_accum


@pytest.fixture(scope="module")
def cam():
    return CameraArrays.from_camera(tpu_pt.cornell_default_camera())


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def cfg_small(**kw):
    base = dict(width=32, height=32, spp=8, max_depth=3,
                use_direct_lighting=True, use_importance_sampling=True)
    base.update(kw)
    return tpu_pt.RenderConfig(**base)


def test_mesh_factory():
    m = dist.device_mesh()
    assert m.shape["tile"] * m.shape["spp"] == 8
    m2 = dist.device_mesh(n_tile=8, n_spp=1)
    assert m2.shape["tile"] == 8
    m4 = dist.device_mesh(n_tile=2, n_spp=4)
    assert m4.shape["spp"] == 4


@pytest.mark.parametrize("n_tile,n_spp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_device(cornell_scene, cam, n_tile, n_spp):
    """Tile/spp sharding must be bitwise identical to single-chip rendering
    (counter-based RNG makes this exact, not just statistical)."""
    cfg = cfg_small()
    accum = init_accum(cfg)
    ref_accum, ref_img, ref_stats = render_frame(cornell_scene, cam, cfg, 0,
                                                 accum)

    mesh = dist.device_mesh(n_tile=n_tile, n_spp=n_spp)
    step = dist.make_sharded_renderer(cornell_scene, cfg, mesh)
    accum_s = dist.init_accum_sharded(cfg, mesh)
    out_accum, out_img, out_stats = step(cam, 0, accum_s)

    # The regen scheduler's work queue is device-local, so same-pixel sample
    # contributions interleave differently across shardings: identical terms,
    # fp-add reordering only (~1 ulp).
    np.testing.assert_allclose(np.asarray(ref_accum), np.asarray(out_accum),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(ref_stats.rays_traced),
                               float(out_stats.rays_traced))
    np.testing.assert_allclose(np.asarray(ref_stats.done_histogram),
                               np.asarray(out_stats.done_histogram))


def test_tile_sharding_bitwise_with_scan_scheduler(cornell_scene, cam):
    """With the scan scheduler (execution order == reference's nested
    loops), pure tile sharding is bitwise identical to single-chip."""
    cfg = cfg_small(scheduler="scan")
    accum = init_accum(cfg)
    ref_accum, ref_img, _ = render_frame(cornell_scene, cam, cfg, 0, accum)
    mesh = dist.device_mesh(n_tile=8, n_spp=1)
    step = dist.make_sharded_renderer(cornell_scene, cfg, mesh)
    accum_s = dist.init_accum_sharded(cfg, mesh)
    out_accum, out_img, _ = step(cam, 0, accum_s)
    np.testing.assert_array_equal(np.asarray(ref_accum),
                                  np.asarray(out_accum))
    np.testing.assert_array_equal(np.asarray(ref_img), np.asarray(out_img))


@pytest.mark.parametrize("n_tile", [1, 4, 8])
def test_tile_sharding_bitwise_pixelq(mixed_scene, cam, n_tile):
    """Tile-only meshes trace every path of the default scheduler with the
    same arithmetic as one device. The (1, 1) mesh compiles the same
    shapes and agrees bitwise; that needs the scene to be an argument of
    the sharded step (as a closed-over constant XLA folds its arithmetic
    on the host, an ulp off the device code). Narrower tiles compile other
    shapes, and on the CPU a few values move by an ulp: they stay within
    1e-5 of the image's peak, chip_smoke.py's bound for tile meshes."""
    cfg = cfg_small(width=64, height=64, spp=4, max_depth=8)
    ref_accum, _, _ = render_frame(mixed_scene, cam, cfg, 0, init_accum(cfg))
    mesh = dist.device_mesh(n_tile=n_tile, n_spp=1,
                            devices=jax.devices()[:n_tile])
    step = dist.make_sharded_renderer(mixed_scene, cfg, mesh)
    out_accum, _, _ = step(cam, 0, dist.init_accum_sharded(cfg, mesh))
    ref, out = np.asarray(ref_accum), np.asarray(out_accum)
    if n_tile == 1:
        np.testing.assert_array_equal(ref, out)
    else:
        assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(ref))


def test_sharded_progressive_frames(cornell_scene, cam):
    cfg = cfg_small(spp=2)
    mesh = dist.device_mesh(n_tile=4, n_spp=2)
    step = dist.make_sharded_renderer(cornell_scene, cfg, mesh)
    accum_s = dist.init_accum_sharded(cfg, mesh)
    for f in range(3):
        accum_s, img, stats = step(cam, f, accum_s)

    # Single-device progressive reference.
    accum = init_accum(cfg)
    for f in range(3):
        accum, ref_img, _ = render_frame(cornell_scene, cam, cfg, f, accum)
    # The sharded and single-device graphs fuse _bounce differently, so
    # ~1-ulp intermediate differences can flip rare samples at geometric /
    # RR boundaries: sparse ~1e-4 outliers, tiny mean error.
    d = np.abs(np.asarray(accum) - np.asarray(accum_s))
    assert d.max() < 1e-3, f"max {d.max()}"
    assert d.mean() < 1e-6, f"mean {d.mean()}"


@pytest.mark.parametrize("n_spp", [1, 2])
def test_multihost_two_process(assets_dir, n_spp):
    """The DCN seam, actually exercised: two OS processes join one
    ``jax.distributed`` job (2 virtual CPU devices each), render a frame
    over the hybrid (tile-over-DCN, spp-over-ICI) mesh from
    ``dist.multihost_mesh``, and each asserts the gathered frame matches
    its own single-device render. n_spp=2 keeps the per-pixel psum inside
    a process; n_spp=1 spans the tile axis across both processes."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=2"])
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(n_spp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker {p.args[2]} failed:\n{out}"
        assert "multihost frame matches single-device" in out


def test_accum_stays_sharded(cornell_scene, cam):
    cfg = cfg_small(spp=2)
    mesh = dist.device_mesh(n_tile=8, n_spp=1)
    step = dist.make_sharded_renderer(cornell_scene, cfg, mesh)
    accum_s = dist.init_accum_sharded(cfg, mesh)
    out, _, _ = step(cam, 0, accum_s)
    shard_shapes = {s.data.shape for s in out.addressable_shards}
    assert shard_shapes == {(cfg.height // 8, cfg.width, 3)}


@pytest.mark.parametrize("n_tile,n_spp", [(4, 2), (2, 4)])
def test_sharded_whitted_matches_single_device(cam, n_tile, n_spp,
                                               assets_dir):
    """The whitted integrator shards over the same (tile, spp) mesh as
    the path tracer (make_sharded_renderer dispatches on the scene type
    — the reference's multi-GPU scaffold is pipeline-agnostic,
    WorkDistribution.h:34-90). Exact same paths; fp-add reordering only."""
    import pathlib
    import subprocess
    import sys
    if not (assets_dir / "pbr_test.gltf").exists():
        repo = pathlib.Path(__file__).resolve().parent.parent
        subprocess.run([sys.executable,
                        str(repo / "tools" / "make_gltf_assets.py")],
                       check=True)
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    from tpu_pt.camera import Camera
    ws = load_gltf(str(assets_dir / "pbr_test.gltf"))
    wcam = CameraArrays.from_camera(Camera(
        eye=np.array([6.0, 4.5, 7.0], np.float32),
        lookat=np.array([0.0, 0.8, 0.0], np.float32), fov_y=40.0))
    cfg = cfg_small(spp=8, intersector="bruteforce")
    accum = init_accum(cfg)
    ref_accum, _, ref_stats = render_whitted_frame(ws, wcam, cfg, 0, accum)

    mesh = dist.device_mesh(n_tile=n_tile, n_spp=n_spp)
    step = dist.make_sharded_renderer(ws, cfg, mesh)
    accum_s = dist.init_accum_sharded(cfg, mesh)
    out_accum, _, out_stats = step(wcam, 0, accum_s)

    np.testing.assert_allclose(np.asarray(ref_accum), np.asarray(out_accum),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(ref_stats.rays_traced),
                               float(out_stats.rays_traced))
    np.testing.assert_allclose(float(ref_stats.shadow_rays),
                               float(out_stats.shadow_rays))
    np.testing.assert_allclose(np.asarray(ref_stats.done_histogram),
                               np.asarray(out_stats.done_histogram))
