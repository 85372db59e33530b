"""Offscreen viewer tests (the show counterpart: ops.render z-buffer
splat + io.png codec + cli.show driver; ref src/show/)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu3dtk.io.png import read_png, write_png
from tpu3dtk.ops import render
from tests.conftest import make_room_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_png_roundtrip(tmp_path, rng):
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    back = read_png(p)
    assert (back == img).all()


def test_render_occlusion_and_projection():
    """A near point must occlude a far point on the same pixel, and
    projection must place a centered point at the image center."""
    # camera at origin looking down +z
    pose = np.eye(4)
    pts = np.array([[0.0, 0.0, 100.0], [0.0, 0.0, 50.0]])
    colors = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    img, depth = render.render_points(
        pts, pose, colors=colors, width=64, height=64, fov_deg=60.0
    )
    c = img[32, 32]
    assert tuple(c) == (0, 255, 0), c  # near (green) wins
    assert abs(depth[32, 32] - 50.0) < 1e-3
    # everything else empty
    assert np.isnan(depth).sum() == 64 * 64 - 1


def test_render_covers_scene(rng):
    pts = make_room_cloud(rng, n=5000, size=500.0)
    pose = render.orbit_pose(pts.mean(0), 900.0, azimuth_deg=30.0)
    img, depth = render.render_points(pts, pose, width=160, height=120)
    cover = np.isfinite(depth).mean()
    assert cover > 0.05, cover  # scene visible
    assert img.max() > 0


def test_render_deterministic(rng):
    pts = make_room_cloud(rng, n=2000, size=400.0)
    pose = render.orbit_pose(pts.mean(0), 800.0, azimuth_deg=75.0)
    a, _ = render.render_points(pts, pose, width=96, height=96)
    b, _ = render.render_points(pts, pose, width=96, height=96)
    assert (a == b).all()


@pytest.mark.slow
def test_show_cli_end_to_end(tmp_path, dat_dir):
    out = str(tmp_path / "views")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               JAX_ENABLE_COMPILATION_CACHE="false")
    r = subprocess.run(
        [
            sys.executable, "-m", "tpu3dtk.cli.show",
            "-m", "2500", "-r", "15", "--orbit", "1", "--animate", "0",
            "--width", "160", "--height", "120", "-o", out, dat_dir,
        ],
        env=env, capture_output=True, timeout=600, cwd=REPO,
    )
    assert r.returncode == 0, r.stdout.decode()[-2000:] + r.stderr.decode()[-2000:]
    img = read_png(os.path.join(out, "orbit000.png"))
    assert img.shape == (120, 160, 3)
    assert img.max() > 0  # something rendered


def test_lod_select_budget_and_culling(rng):
    """Frustum-culled LOD cut (ops.render.lod_select, ref
    show_Boctree.h:504-561): honors the point budget, excludes
    behind-camera geometry, and keeps in-view geometry."""
    from tpu3dtk.ops.octree import build_octree
    from tpu3dtk.ops.render import look_at, lod_select

    front = rng.uniform(-500, 500, (120_000, 3)) + np.array([0, 0, 3000.0])
    behind = rng.uniform(-500, 500, (120_000, 3)) + np.array([0, 0, -3000.0])
    pts = np.concatenate([front, behind])
    tree = build_octree(pts, 8.0)
    pose = look_at(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    sel, w = lod_select(tree, pose, budget=20_000)
    assert 0 < len(sel) <= 20_000
    # everything selected is in front of the camera
    assert (sel[:, 2] > 0).all()
    # the in-view half is represented (weights cover most of its points)
    assert w.sum() > 0.6 * len(front)


def test_tpushow_lod_renders_large_scene(tmp_path, rng):
    """A multi-million-point scene renders through --lod with a bounded
    budget (ref viewer's city-scale regime)."""
    import subprocess
    import sys

    n = 1_200_000
    pts = rng.uniform(0, 4000, (n, 3)).astype(np.float32)
    np.savetxt(tmp_path / "scan000.3d", pts[:: n // 200_000], fmt="%.1f")
    (tmp_path / "scan000.pose").write_text("0 0 0\n0 0 0\n")
    out = tmp_path / "imgs"
    r = subprocess.run(
        [sys.executable, "-m", "tpu3dtk.cli.show", str(tmp_path),
         "--orbit", "1", "--lod", "50000", "-o", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_ENABLE_COMPILATION_CACHE": "false"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "orbit000.png").exists()


def test_color_modes(rng):
    from tpu3dtk.ops.render import color_by_scan, color_by_value

    c = color_by_scan([10, 20, 5])
    assert c.shape == (35, 3)
    assert (c[0] != c[10]).any() and (c[10] != c[30]).any()
    v = color_by_value(rng.uniform(0, 1, 100))
    assert v.shape == (100, 3) and v.dtype == np.uint8


def test_tpushow_scan_colors(tmp_path, rng):
    import os
    import subprocess
    import sys

    for k in range(2):
        pts = rng.uniform(0, 500, (2000, 3)) + k * 200
        np.savetxt(tmp_path / f"scan{k:03d}.3d", pts, fmt="%.1f")
        (tmp_path / f"scan{k:03d}.pose").write_text("0 0 0\n0 0 0\n")
    out = tmp_path / "imgs"
    r = subprocess.run(
        [sys.executable, "-m", "tpu3dtk.cli.show", str(tmp_path),
         "--orbit", "1", "--color", "scan", "-o", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_ENABLE_COMPILATION_CACHE": "false"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "orbit000.png").exists()
