"""CLI, checkpoint/resume, and viewer-component tests."""

import subprocess
import sys

import numpy as np
import pytest

import tpu_pt
from tpu_pt import film
from tpu_pt.camera import Camera
from tpu_pt.checkpoint import save_checkpoint, load_checkpoint
from tpu_pt.render import CameraArrays, render_frame, init_accum


def test_checkpoint_roundtrip(tmp_path, cornell_scene):
    cfg = tpu_pt.RenderConfig(width=32, height=32, spp=2, max_depth=3,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    camera = tpu_pt.cornell_default_camera()
    cam = CameraArrays.from_camera(camera)
    accum = init_accum(cfg)
    for f in range(2):
        accum, _, _ = render_frame(cornell_scene, cam, cfg, f, accum)

    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, accum, 2, cfg, camera)
    accum2, fidx, cfg2, camera2 = load_checkpoint(p)
    assert fidx == 2
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(accum), np.asarray(accum2))
    np.testing.assert_array_equal(camera2.eye, camera.eye)
    assert camera2.fov_y == camera.fov_y


def test_checkpoint_resume_bit_exact(tmp_path, cornell_scene):
    """2 frames + checkpoint + 2 frames == 4 straight frames, bitwise."""
    cfg = tpu_pt.RenderConfig(width=32, height=32, spp=2, max_depth=3,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    camera = tpu_pt.cornell_default_camera()
    cam = CameraArrays.from_camera(camera)

    a = init_accum(cfg)
    for f in range(4):
        a, _, _ = render_frame(cornell_scene, cam, cfg, f, a)

    b = init_accum(cfg)
    for f in range(2):
        b, _, _ = render_frame(cornell_scene, cam, cfg, f, b)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, b, 2, cfg, camera)
    b2, fidx, cfg2, camera2 = load_checkpoint(p)
    cam2 = CameraArrays.from_camera(camera2)
    for f in range(fidx, fidx + 2):
        b2, _, _ = render_frame(cornell_scene, cam2, cfg2, f, b2)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b2))


def _run_cli(args, cwd):
    import os
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pypath = repo_root + os.pathsep + os.environ.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tpu_pt.cli"] + args,
        capture_output=True, text=True, cwd=str(cwd), timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": pypath})


def test_cli_render_end_to_end(tmp_path, assets_dir):
    out = tmp_path / "out.png"
    r = _run_cli(["render", str(assets_dir / "cornell_box.obj"),
                  "-o", str(out), "--width", "48", "--height", "48",
                  "--spp", "2", "--frames", "1", "--depth", "2",
                  "--direct-lighting", "--importance-sampling", "--stats"],
                 tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert "Total Samples: 4608" in r.stdout
    img = film.read_png(str(out))
    assert img.shape == (48, 48, 3)
    assert img.max() > 0


def test_cli_ppm_output(tmp_path, assets_dir):
    out = tmp_path / "out.ppm"
    r = _run_cli(["render", str(assets_dir / "cornell_box.obj"),
                  "-o", str(out), "--width", "32", "--height", "32",
                  "--spp", "1", "--frames", "1", "--depth", "1"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    data = out.read_bytes()
    assert data.startswith(b"P6\n32 32\n255\n")


def test_cli_missing_scene_errors(tmp_path):
    r = _run_cli(["render"], tmp_path)
    assert r.returncode != 0


def test_cli_view_headless(tmp_path, assets_dir):
    """Without a TTY the viewer must render --frames frames and exit
    cleanly (keys disabled) instead of crashing on the termios ioctl or
    spinning forever waiting for a quit key."""
    out = tmp_path / "view.png"
    r = _run_cli(["view", str(assets_dir / "cornell_box.obj"),
                  "-o", str(out), "--width", "32", "--height", "32",
                  "--spp", "1", "--frames", "2", "--depth", "2"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert "frame 2" in r.stdout            # status line of the last frame
    assert film.read_png(str(out)).shape == (32, 32, 3)


def test_cli_view_headless_gltf_whitted(tmp_path, assets_dir):
    """``tpu-pt view scene.gltf`` drives the whitted integrator (the
    reference's interactive pipeline for its SDK scenes,
    ``cuda/whitted.cu:44-98``), headless exit included."""
    if not (assets_dir / "pbr_test.gltf").exists():
        import pathlib
        repo = pathlib.Path(__file__).resolve().parent.parent
        subprocess.run([sys.executable,
                        str(repo / "tools" / "make_gltf_assets.py")],
                       check=True)
    out = tmp_path / "view_w.png"
    r = _run_cli(["view", str(assets_dir / "pbr_test.gltf"),
                  "-o", str(out), "--width", "32", "--height", "32",
                  "--spp", "1", "--frames", "1", "--depth", "2",
                  "--intersector", "bruteforce"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    img = film.read_png(str(out))
    assert img.shape == (32, 32, 3)
    assert img.max() > 0


def test_viewer_display_component():
    """TerminalDisplay renders half-blocks with ANSI colors (no tty)."""
    from tpu_pt.viewer import TerminalDisplay
    import io, sys as _sys
    img = np.zeros((16, 16, 3), np.uint8)
    img[:8] = [255, 0, 0]
    d = TerminalDisplay()
    buf = io.StringIO()
    old = _sys.stdout
    _sys.stdout = buf
    try:
        d.draw(img, "status-line")
    finally:
        _sys.stdout = old
    out = buf.getvalue()
    assert "▀" in out
    assert "status-line" in out
    assert "38;2;" in out  # truecolor fg


def test_cli_exr_output(tmp_path, assets_dir):
    out = tmp_path / "out.exr"
    r = _run_cli(["render", str(assets_dir / "cornell_box.obj"),
                  "-o", str(out), "--width", "16", "--height", "16",
                  "--spp", "1", "--frames", "1", "--depth", "1"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    img = film.read_exr(str(out))
    assert img.shape == (16, 16, 3)
    assert img.dtype == np.float32
    assert img.max() > 0


def test_cli_whitted_stats_checkpoint_resume(tmp_path, assets_dir):
    """Whitted CLI is first-class: --stats prints telemetry, --checkpoint
    writes state, --resume continues bit-exactly (counter RNG)."""
    if not (assets_dir / "pbr_test.gltf").exists():
        import subprocess as sp
        repo = assets_dir.parent
        sp.run([sys.executable, str(repo / "tools" / "make_gltf_assets.py")],
               check=True)
    scene = str(assets_dir / "pbr_test.gltf")
    ck = tmp_path / "w.npz"
    out1 = tmp_path / "a.png"
    r = _run_cli(["render", scene, "-o", str(out1), "--width", "32",
                  "--height", "32", "--spp", "2", "--frames", "1",
                  "--depth", "3", "--stats",
                  "--checkpoint", str(ck)], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    assert "Mrays/s" in r.stdout and "done(miss/depth/absorbed)" in r.stdout
    assert ck.exists()

    # Resume one more frame; must equal a straight 2-frame run bit-exactly.
    out2 = tmp_path / "b.png"
    r = _run_cli(["render", scene, "-o", str(out2), "--frames", "1",
                  "--resume", str(ck)], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    out12 = tmp_path / "c.png"
    r = _run_cli(["render", scene, "-o", str(out12), "--width", "32",
                  "--height", "32", "--spp", "2", "--frames", "2",
                  "--depth", "3"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
    np.testing.assert_array_equal(film.read_png(str(out2)),
                                  film.read_png(str(out12)))


def test_cli_whitted_validate(tmp_path, assets_dir):
    r = _run_cli(["render", str(assets_dir / "pbr_test.gltf"),
                  "-o", str(tmp_path / "v.png"), "--width", "24",
                  "--height", "24", "--spp", "1", "--frames", "1",
                  "--depth", "2", "--validate"], tmp_path)
    assert r.returncode == 0, r.stderr[-800:]
