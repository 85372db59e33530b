"""Cylinder detection — the JAX-native ``detectCylinder`` module
(ref src/detectCylinder/: Hough axis detection over the normal sphere +
circle estimation in the projected plane; SURVEY §2.6).

Two stages, as in the reference:
1. **Axis**: a cylinder's surface normals are perpendicular to its
   axis, so the axis direction maximizes the count of normals with
   |n·d| ≈ 0 — one |N @ D^T| matmul against a direction sphere.
2. **Circle**: project inlier points onto the plane ⊥ axis and fit the
   circle (algebraic Kasa fit inside RANSAC), then collect inliers on
   the cylinder shell.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CylinderParams", "Cylinder", "detect_cylinders"]


@dataclasses.dataclass(frozen=True)
class Cylinder:
    axis: np.ndarray  # [3] unit
    center: np.ndarray  # [3] point on the axis
    radius: float
    n_inliers: int


@dataclasses.dataclass
class CylinderParams:
    n_directions: int = 500
    axis_tol: float = 0.15  # |n.d| below this counts as perpendicular
    shell_tol: float = 5.0  # distance band around the shell (cm)
    min_inliers: int = 100
    max_cylinders: int = 5
    ransac_iters: int = 200
    knn: int = 16


def _fib_sphere(n: int) -> np.ndarray:
    k = np.arange(n) + 0.5
    z = 1.0 - k / n  # half sphere (axes are unsigned)
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def _kasa_circle(xy: np.ndarray):
    """Algebraic circle fit: minimizes |x|^2 - 2 c.x + (|c|^2 - r^2)."""
    A = np.column_stack([2 * xy, np.ones(len(xy))])
    b = (xy**2).sum(1)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    c = sol[:2]
    r2 = sol[2] + c @ c
    return c, float(np.sqrt(max(r2, 0.0)))


def detect_cylinders(points, normals=None, params: CylinderParams | None = None):
    """Detect up to max_cylinders; returns list[Cylinder]."""
    import jax.numpy as jnp

    from ..ops import normals as normals_ops

    params = params or CylinderParams()
    pts = np.asarray(points, np.float64)
    if normals is None:
        vp = pts.mean(0) + np.array([0.0, 1e4, 0.0])
        normals = np.asarray(
            normals_ops.estimate_normals_knn(
                jnp.asarray(pts, jnp.float32),
                jnp.ones(len(pts), bool),
                jnp.asarray(vp, jnp.float32),
                k=params.knn,
            )
        )
    normals = np.asarray(normals, np.float64)

    rng = np.random.default_rng(0)
    out: list[Cylinder] = []
    remaining = np.arange(len(pts))
    for _ in range(params.max_cylinders):
        if len(remaining) < params.min_inliers:
            break
        P = pts[remaining]
        N = normals[remaining]
        dirs = _fib_sphere(params.n_directions)
        perp = np.abs(N @ dirs.T) < params.axis_tol  # [n, D]
        votes = perp.sum(0)
        d_idx = int(np.argmax(votes))
        if votes[d_idx] < params.min_inliers:
            break
        axis = dirs[d_idx]
        cand = perp[:, d_idx]
        # project candidates onto the plane perpendicular to axis
        u = np.linalg.svd(np.eye(3) - np.outer(axis, axis))[0][:, :2]
        xy = P[cand] @ u
        if len(xy) < params.min_inliers:
            break
        best_inl = None
        best = (None, 0.0)
        for _ in range(params.ransac_iters):
            sel = rng.choice(len(xy), 3, replace=False)
            c, r = _kasa_circle(xy[sel])
            if not np.isfinite(r) or r <= 0 or r > 1e4:
                continue
            res = np.abs(np.linalg.norm(xy - c, axis=1) - r)
            inl = res < params.shell_tol
            if best_inl is None or inl.sum() > best_inl.sum():
                best_inl = inl
                best = (c, r)
        if best_inl is None or best_inl.sum() < params.min_inliers:
            remaining = remaining[~cand]
            continue
        c, r = _kasa_circle(xy[best_inl])
        # final shell inliers over ALL remaining points
        xy_all = P @ u
        res_all = np.abs(np.linalg.norm(xy_all - c, axis=1) - r)
        shell = res_all < params.shell_tol
        if shell.sum() < params.min_inliers:
            remaining = remaining[~cand]
            continue
        center3 = u @ c + axis * (P[shell] @ axis).mean()
        out.append(
            Cylinder(
                axis=axis,
                center=center3,
                radius=r,
                n_inliers=int(shell.sum()),
            )
        )
        remaining = remaining[~shell]
    return out
