"""Hough plane detection tests (shapes module, bin/planes role)."""

import numpy as np
import pytest

from tpu3dtk.models import shapes


def test_single_plane(rng):
    pts = rng.uniform(0, 500, (2000, 3))
    pts[:, 1] = 100.0 + rng.normal(0, 0.5, 2000)
    planes = shapes.detect_planes(
        pts, shapes.HoughParams(min_inliers=200, dist_tol=5.0, rho_max=1000.0)
    )
    assert len(planes) >= 1
    p = planes[0]
    assert abs(abs(p.normal[1]) - 1.0) < 0.02
    assert abs(abs(p.rho) - 100.0) < 5.0
    assert p.n_inliers > 1500


def test_three_walls(rng):
    walls = []
    for axis, off in [(0, 0.0), (1, 0.0), (2, 300.0)]:
        w = rng.uniform(0, 300, (1500, 3))
        w[:, axis] = off + rng.normal(0, 0.3, 1500)
        walls.append(w)
    pts = np.concatenate(walls)
    planes = shapes.detect_planes(
        pts, shapes.HoughParams(min_inliers=400, dist_tol=5.0, rho_max=600.0)
    )
    assert len(planes) == 3
    normals = np.stack([np.abs(p.normal) for p in planes])
    # each wall axis represented
    assert sorted(np.argmax(normals, axis=1).tolist()) == [0, 1, 2]


def test_noise_only_no_planes(rng):
    pts = rng.uniform(0, 500, (1000, 3))
    planes = shapes.detect_planes(
        pts, shapes.HoughParams(min_inliers=400, dist_tol=3.0, rho_max=1000.0)
    )
    assert len(planes) == 0


def test_detect_planes_rht(rng):
    """Randomized Hough (ref Hough::RHT) finds the room's walls."""
    from tests.conftest import make_room_cloud
    from tpu3dtk.models.shapes import HoughParams, detect_planes_rht

    pts = make_room_cloud(rng, n=6000, size=700.0)
    planes = detect_planes_rht(
        pts,
        HoughParams(min_inliers=400, max_planes=8, dist_tol=8.0),
        seed=3,
    )
    assert len(planes) >= 4
    # every detected normal is an axis
    for p in planes:
        assert np.abs(p.normal).max() > 0.98, p.normal


def test_hough_config_file(tmp_path):
    """ConfigFileHough parsing (ref src/shapes/ConfigFileHough.cc):
    key-value scan, defaults for missing keys, ignored unknown keys."""
    from tpu3dtk.io.hough_config import (
        HOUGH_DEFAULTS, hough_params_from_config, load_hough_config,
    )

    cfg = tmp_path / "hough.cfg"
    cfg.write_text(
        "# comment-ish noise\n"
        "MaxPointPlaneDist 5.0\n"
        "MaxPlanes 7\n"
        "MinSizeAllPoints 33\n"
        "RhoNum 250\nRhoMax 900\n"
        "SomethingUnknown 42\n"
    )
    c = load_hough_config(str(cfg))
    assert c["MaxPointPlaneDist"] == 5.0
    assert c["MaxPlanes"] == 7
    assert c["MinSizeAllPoints"] == 33
    assert c["RhoNum"] == 250
    # untouched keys keep the reference defaults
    assert c["ThetaNum"] == HOUGH_DEFAULTS["ThetaNum"]
    hp = hough_params_from_config(c)
    assert hp.max_planes == 7
    assert hp.min_inliers == 33
    assert hp.dist_tol == 5.0
    assert hp.rho_max == 900.0


def test_planes_cli_with_config(tmp_path, rng):
    import os
    import subprocess
    import sys

    n = 3000
    a = np.stack([rng.uniform(0, 500, n), rng.uniform(0, 500, n),
                  np.zeros(n)], 1)
    b = np.stack([rng.uniform(0, 500, n), np.zeros(n),
                  rng.uniform(0, 500, n)], 1)
    pts = np.concatenate([a, b]) + rng.normal(0, 0.3, (2 * n, 3))
    np.savetxt(tmp_path / "scan000.3d", pts, fmt="%.2f")
    (tmp_path / "scan000.pose").write_text("0 0 0\n0 0 0\n")
    (tmp_path / "hough.cfg").write_text(
        "MaxPointPlaneDist 3.0\nMaxPlanes 4\nMinSizeAllPoints 400\n"
    )
    out = tmp_path / "planes"
    r = subprocess.run(
        [sys.executable, "-m", "tpu3dtk.cli.planes", str(tmp_path),
         "-C", str(tmp_path / "hough.cfg"), "-o", str(out)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_ENABLE_COMPILATION_CACHE": "false"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "planes.list").exists()
    n_planes = len((out / "planes.list").read_text().splitlines())
    assert 2 <= n_planes <= 4
