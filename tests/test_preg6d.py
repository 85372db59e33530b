"""preg6d plane-based registration tests (ref src/preg6d/planereg.cc:2,
opt/gaussnewton.cc, opt/adadelta6d.cc, match/planematcher.cc): a synthetic multi-plane scene registered by planes
alone (no NN ICP) against ground truth."""

import numpy as np
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import preg6d as pg
from tpu3dtk.models.shapes import HoughParams, Plane, detect_planes
from tests.conftest import make_room_cloud


def room_planes(size=800.0):
    """The 6 exact wall planes of the conftest room cloud."""
    planes = []
    for axis in range(3):
        n = np.zeros(3)
        n[axis] = 1.0
        c0 = np.full(3, size / 2)
        for side in (0.0, size):
            c = c0.copy()
            c[axis] = side
            planes.append(
                Plane(normal=n.copy(), rho=side, n_inliers=1000, center=c)
            )
    return planes


def _perturbed_scan(rng, offset, angles_deg, size=800.0):
    world = make_room_cloud(rng, n=6000, size=size)
    T_true = np.eye(4)
    local = world  # scan frame == world frame, true pose = identity
    T0 = np.asarray(
        math3d.euler_to_matrix4(np.asarray(offset), np.deg2rad(angles_deg))
    )
    s = TPUScan.from_points(local, "000", pose=T0)
    s.set_reduction(15.0, 1)
    return s, T_true


def test_plane_register_recovers_pose(rng):
    """A scan of the box room, perturbed by cm/degree-level pose error,
    must be pulled back to identity by plane association alone
    (Gauss-Newton — the production optimizer, opt/gaussnewton.cc)."""
    s, T_true = _perturbed_scan(rng, [8.0, -5.0, 6.0], [1.5, -1.0, 2.0])
    infos = pg.preg6d(
        [s],
        planes=room_planes(),
        params=pg.PregParams(eps_hesse=30.0, iterations=50),
    )
    err_t = np.linalg.norm(s.transMat[:3, 3] - T_true[:3, 3])
    err_r = np.linalg.norm(s.transMat[:3, :3] - T_true[:3, :3])
    assert err_t < 0.5, (err_t, infos)
    assert err_r < 0.01, (err_r, infos)
    assert infos[0]["associated"] > 3000


def test_plane_register_adadelta_refines(rng):
    """The AdaDelta variant (opt/adadelta6d.cc — a slow first-order
    refiner in the reference too) must substantially reduce a small
    translational error via pure autodiff gradients."""
    s, _ = _perturbed_scan(rng, [3.0, -2.0, 2.0], [0.0, 0.0, 0.0])
    err0 = np.linalg.norm(s.transMat[:3, 3])
    pg.preg6d(
        [s],
        planes=room_planes(),
        params=pg.PregParams(
            eps_hesse=30.0, optimizer="adadelta", iterations=1500
        ),
    )
    err1 = np.linalg.norm(s.transMat[:3, 3])
    assert err1 < 0.5 * err0, (err0, err1)


def test_preg6d_detects_planes_itself(rng):
    """Without a plane model, preg6d condenses the sequence and Hough-
    extracts planes (the planereg.cc workflow with bin/planes inline)."""
    s, T_true = _perturbed_scan(rng, [5.0, 4.0, -3.0], [0.8, 0.5, -0.6])
    # a second, unperturbed scan anchors the plane model
    anchor, _ = _perturbed_scan(np.random.default_rng(7), [0, 0, 0], [0, 0, 0])
    infos = pg.preg6d(
        [anchor, s],
        params=pg.PregParams(eps_hesse=30.0, iterations=50),
        hough=HoughParams(min_inliers=300, max_planes=8, dist_tol=12.0),
    )
    err_t = np.linalg.norm(s.transMat[:3, 3])
    err0 = np.linalg.norm([5.0, 4.0, -3.0])
    # Hough-extracted planes carry quantization bias, so exact recovery
    # is not achievable — require a large reduction of the pose error
    assert err_t < 0.7 * err0, (err_t, infos)


def test_match_planes_energies():
    g = room_planes()
    # local planes: slightly rotated/shifted copies of a subset
    loc = []
    for p in (g[0], g[3], g[5]):
        n = p.normal + np.array([0.01, -0.005, 0.008])
        n = n / np.linalg.norm(n)
        loc.append(
            Plane(
                normal=n, rho=p.rho + 2.0, n_inliers=500,
                center=p.center + 1.0,
            )
        )
    pairs = pg.match_planes(loc, g)
    assert len(pairs) == 3
    got = {(li, gi) for li, gi, _ in pairs}
    assert got == {(0, 0), (1, 3), (2, 5)}


def test_match_planes_gates():
    g = room_planes()
    # a local plane whose normal is 45 degrees off matches nothing
    bad = Plane(
        normal=np.array([1.0, 1.0, 0.0]) / np.sqrt(2), rho=0.0,
        n_inliers=10, center=np.zeros(3),
    )
    assert pg.match_planes([bad], g, eps_sim_deg=20.0) == []
