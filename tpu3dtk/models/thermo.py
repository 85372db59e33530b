"""Thermal/color image → point-cloud mapping — the JAX-native
``thermo`` module (ref src/thermo/thermo.cc: project laser points into
a calibrated (thermal) camera and attach per-point temperature/color;
caliboard.cc detects the heated calibration board in the cloud).

Batched design: projection is one batched pinhole+distortion transform
(vectorized Brown-Conrady, the OpenCV model thermo.cc uses through
ProjectPoints); image sampling is a gather; board detection reuses the
Hough plane machinery (models.shapes) with a size gate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Camera",
    "project_points",
    "colorize_scan",
    "detect_caliboard",
]


@dataclasses.dataclass
class Camera:
    """Pinhole + Brown-Conrady distortion (the cv::projectPoints model
    used by thermo.cc / calibration)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    # distortion [k1, k2, p1, p2, k3]
    dist: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    # extrinsics: camera-from-scan (R [3,3], t [3])
    R: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    t: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )


def project_points(points: np.ndarray, cam: Camera):
    """[N,3] scan-frame points -> (u [N], v [N], valid [N]).

    valid requires z > 0 in the camera frame and the pixel inside the
    image (thermo.cc projectAndMap gate)."""
    p = np.asarray(points, np.float64) @ np.asarray(cam.R).T + np.asarray(
        cam.t
    )
    z = p[:, 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    x = p[:, 0] / zs
    y = p[:, 1] / zs
    k1, k2, p1, p2, k3 = cam.dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    valid = (
        (z > 0)
        & (u >= 0) & (u <= cam.width - 1)
        & (v >= 0) & (v <= cam.height - 1)
    )
    return u, v, valid


def colorize_scan(points: np.ndarray, image: np.ndarray, cam: Camera):
    """Attach per-point image values (temperature / RGB): project and
    gather (the thermo.cc point-coloring loop, vectorized).  Returns
    (values [N, C] or [N], valid [N]); invalid points get 0."""
    u, v, valid = project_points(points, cam)
    img = np.asarray(image)
    ui = np.clip(np.round(u).astype(int), 0, cam.width - 1)
    vi = np.clip(np.round(v).astype(int), 0, cam.height - 1)
    vals = img[vi, ui]
    if vals.ndim == 1:
        return np.where(valid, vals, 0), valid
    return np.where(valid[:, None], vals, 0), valid


def detect_caliboard(
    points: np.ndarray,
    board_size: tuple[float, float],
    tol: float = 0.25,
    dist_tol: float = 5.0,
    min_inliers: int = 100,
):
    """Find the calibration-board plane in a cloud (caliboard.cc role):
    Hough plane detection gated to the known board extent.  Returns
    (center [3], normal [3], inlier mask) or None."""
    from .shapes import HoughParams, detect_planes

    pts = np.asarray(points, np.float64)
    # rho bins matched to the board tolerance: with coarse bins a tilted
    # accumulator cell can out-vote the true plane of a SMALL board
    # (its thin footprint fits inside one wide rho band at many angles)
    rho_max = float(np.abs(pts).max()) + 1.0
    n_rho = max(int(np.ceil(2 * rho_max / max(dist_tol, 1e-3))), 100)
    planes = detect_planes(
        pts,
        HoughParams(
            min_inliers=min_inliers, max_planes=8, dist_tol=dist_tol,
            rho_max=rho_max, n_rho=min(n_rho, 2048),
        ),
    )
    w, h = board_size
    diag = np.hypot(w, h)
    for pl in planes:
        d = pts @ pl.normal - pl.rho
        inl = np.abs(d) < dist_tol
        sel = pts[inl]
        if len(sel) < min_inliers:
            continue
        # measure the in-plane extent
        c = sel.mean(0)
        cen = sel - c
        cov = cen.T @ cen / len(sel)
        wvals, V = np.linalg.eigh(cov)
        e1 = 4.0 * np.sqrt(wvals[2])  # ~full extent along major axes
        e2 = 4.0 * np.sqrt(wvals[1])
        if (
            abs(e1 - max(w, h)) < tol * max(w, h)
            and abs(e2 - min(w, h)) < tol * max(w, h)
        ):
            return c, pl.normal, inl
    return None
