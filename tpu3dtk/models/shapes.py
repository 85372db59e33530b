"""Plane detection — the JAX-native shapes module (ref src/shapes/:
``Hough`` class with RHT/SHT variants over a ball accumulator,
hough.cc:82-400; driven by ``bin/planes``, README.planes.md; used by
preg6d plane-based registration).

Batched design (not the reference's cell-by-cell accumulator): the
*standard* Hough transform is one matmul — ``rho = P @ N^T`` for all
points against all candidate normals at once — followed by a batched
histogram.  The [N_points, N_dirs] rho matrix is one matmul; peak
extraction and inlier removal run vectorized.  Iterative
detect-remove-repeat matches the reference's Hough::deletePoints flow.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["HoughParams", "Plane", "hough_accumulator", "detect_planes"]


@dataclasses.dataclass(frozen=True)
class Plane:
    """theta/phi normal + rho, plus inlier stats (ref ConvexPlane)."""

    normal: np.ndarray  # [3] unit
    rho: float  # signed distance from origin (n . p = rho)
    n_inliers: int
    center: np.ndarray  # [3] inlier centroid


@dataclasses.dataclass
class HoughParams:
    n_theta: int = 90  # polar resolution (ref MaxCountTheta-ish)
    n_phi: int = 180  # azimuth resolution
    n_rho: int = 100  # distance bins
    rho_max: float = 2000.0  # cm
    min_inliers: int = 50  # ref MinSizeAllPoints
    max_planes: int = 20  # ref MaxPlanes
    dist_tol: float = 10.0  # inlier band around the plane (cm)


def _directions(n_theta: int, n_phi: int) -> np.ndarray:
    """Quasi-uniform unit normals over the half sphere (the reference's
    AccumulatorBall uses a latitude-balanced ball design; equal-area
    spiral here — same role, no polar oversampling)."""
    n = n_theta * n_phi
    k = np.arange(n) + 0.5
    # Fibonacci half-sphere
    z = k / n  # (0, 1]: half sphere
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def hough_accumulator(points, params: HoughParams):
    """Vote all points into the (direction, rho) accumulator.

    Returns (acc [D, n_rho] int32, dirs [D, 3], rho_edges).  One
    matmul computes every point's rho against every direction
    (ref Hough::SHT loops point x cell; hough.cc).
    """
    import jax
    import jax.numpy as jnp

    pts = jnp.asarray(points, jnp.float32)
    dirs = jnp.asarray(_directions(params.n_theta, params.n_phi), jnp.float32)
    D = dirs.shape[0]
    rho = jnp.dot(pts, dirs.T, preferred_element_type=jnp.float32)  # [N, D]
    # signed rho in [-rho_max, rho_max] -> bin
    bin_w = (2.0 * params.rho_max) / params.n_rho
    bins = jnp.clip(
        ((rho + params.rho_max) / bin_w).astype(jnp.int32), 0, params.n_rho - 1
    )
    # per-direction histogram via one-hot segment sum over flat ids
    flat = bins + jnp.arange(D, dtype=jnp.int32)[None, :] * params.n_rho
    acc = jnp.zeros((D * params.n_rho,), jnp.int32)
    acc = acc.at[flat.reshape(-1)].add(1)
    return np.asarray(acc).reshape(D, params.n_rho), np.asarray(dirs), bin_w


def detect_planes(points, params: HoughParams | None = None) -> list[Plane]:
    """Iterative Hough plane extraction: vote, take the global maximum,
    least-squares refine on the inlier band, remove inliers, repeat
    (ref Hough::RHT + deletePoints flow)."""
    params = params or HoughParams()
    pts = np.asarray(points, np.float64)
    planes: list[Plane] = []
    remaining = pts
    for _ in range(params.max_planes):
        if len(remaining) < params.min_inliers:
            break
        acc, dirs, bin_w = hough_accumulator(
            remaining.astype(np.float32), params
        )
        d_idx, r_idx = np.unravel_index(np.argmax(acc), acc.shape)
        if acc[d_idx, r_idx] < params.min_inliers:
            break
        n = dirs[d_idx]
        rho = -params.rho_max + (r_idx + 0.5) * bin_w
        # inlier band
        d = remaining @ n - rho
        inl = np.abs(d) < max(params.dist_tol, bin_w)
        if inl.sum() < params.min_inliers:
            break
        # refine by iterated PCA: start on the coarse accumulator band,
        # re-fit on progressively tighter inlier bands so a coarse rho
        # bin (or slightly-off direction cell) cannot lock in a tilted
        # fit when clutter shares the initial band
        n_ref = n
        rho_ref = rho
        band0 = max(params.dist_tol, bin_w)
        for band in np.geomspace(band0, params.dist_tol, 3):
            dref = remaining @ n_ref - rho_ref
            sel = remaining[np.abs(dref) < band]
            if len(sel) < max(params.min_inliers // 2, 3):
                break
            c = sel.mean(0)
            cov = (sel - c).T @ (sel - c) / len(sel)
            w, V = np.linalg.eigh(cov)
            cand = V[:, 0]
            if cand @ n_ref < 0:
                cand = -cand
            n_ref = cand
            rho_ref = float(n_ref @ c)
        # final inliers against the refined plane
        d2 = pts @ n_ref - rho_ref
        # count against 'remaining' for removal
        dr = remaining @ n_ref - rho_ref
        inl2 = np.abs(dr) < params.dist_tol
        if inl2.sum() < params.min_inliers:
            remaining = remaining[~inl]
            continue
        planes.append(
            Plane(
                normal=n_ref,
                rho=rho_ref,
                n_inliers=int(inl2.sum()),
                center=remaining[inl2].mean(0),
            )
        )
        remaining = remaining[~inl2]
    return planes


def detect_planes_rht(
    points,
    params: HoughParams | None = None,
    batch: int = 16384,
    acc_threshold: int = 12,
    max_rounds: int = 60,
    seed: int = 0,
) -> list[Plane]:
    """Randomized Hough Transform — the reference's default plane
    detector (``Hough::RHT``, src/shapes/hough.cc:156-210: sample point
    triples, accumulate their plane cells, extract when a cell passes
    the threshold, delete inliers, repeat).

    Batched re-design: triples are sampled in BATCHES of ``batch`` — one
    vectorized cross-product pass computes every triple's (normal, rho)
    and one scatter-add votes them all — instead of the reference's
    one-triple-at-a-time loop.  Extraction/refinement reuses the SHT
    path's iterated PCA."""
    import jax
    import jax.numpy as jnp

    params = params or HoughParams()
    pts = np.asarray(points, np.float64)
    rng = np.random.default_rng(seed)
    planes: list[Plane] = []
    remaining = pts
    # RHT votes on a COARSER accumulator than the SHT: triple normals
    # carry degrees of noise (sensor noise over short baselines), so a
    # fine grid disperses coincident votes below any threshold (the
    # reference's ball accumulator is similarly coarse); the iterated
    # PCA refinement recovers the precision afterwards
    dirs = _directions(max(params.n_theta // 3, 8),
                       max(params.n_phi // 3, 16))
    D = len(dirs)
    n_rho = max(int(2.0 * params.rho_max / (4.0 * params.dist_tol)), 8)
    bin_w = (2.0 * params.rho_max) / n_rho
    dirs_j = jnp.asarray(dirs, jnp.float32)

    @jax.jit
    def vote(tri):
        """tri [B, 3, 3] -> accumulator [D * n_rho] votes."""
        v1 = tri[:, 1] - tri[:, 0]
        v2 = tri[:, 2] - tri[:, 0]
        v3 = tri[:, 2] - tri[:, 1]
        n = jnp.cross(v1, v2)
        nn_ = jnp.linalg.norm(n, axis=1, keepdims=True)
        # distanceOK gate (hough.cc:553): reject near-degenerate
        # triples — tight or stretched ones vote noisy normals
        lens = jnp.stack([
            jnp.linalg.norm(v1, axis=1),
            jnp.linalg.norm(v2, axis=1),
            jnp.linalg.norm(v3, axis=1),
        ])
        dmin = jnp.float32(3.0 * params.dist_tol)
        dmax = jnp.float32(0.25 * params.rho_max)
        ok = (
            (nn_[:, 0] > 1e-6)
            & jnp.all(lens > dmin, axis=0)
            & jnp.all(lens < dmax, axis=0)
        )
        n = n / jnp.maximum(nn_, 1e-12)
        # canonical hemisphere (accumulator covers half sphere)
        n = jnp.where(n[:, 2:3] < 0, -n, n)
        rho = jnp.sum(n * tri[:, 0], axis=1)
        # nearest accumulator direction: [B, D] dot
        sim = jnp.dot(
            n.astype(jnp.float32), dirs_j.T,
            preferred_element_type=jnp.float32,
        )
        di = jnp.argmax(sim, axis=1).astype(jnp.int32)
        ri = jnp.clip(
            ((rho + params.rho_max) / bin_w).astype(jnp.int32),
            0, n_rho - 1,
        )
        flat = jnp.where(ok, di * n_rho + ri, D * n_rho)
        acc = jnp.zeros(D * n_rho + 1, jnp.int32).at[flat].add(1)
        return acc[:-1]

    for _ in range(max_rounds):
        if len(remaining) < max(params.min_inliers, 3):
            break
        idx = rng.integers(0, len(remaining), (batch, 3))
        tri = jnp.asarray(remaining[idx], jnp.float32)
        acc = np.asarray(vote(tri))
        best = int(acc.argmax())
        if acc[best] < acc_threshold:
            continue
        n0 = dirs[best // n_rho]
        rho0 = -params.rho_max + (best % n_rho + 0.5) * bin_w
        # iterated PCA refinement (same discipline as detect_planes)
        n_ref, rho_ref = n0, rho0
        ok_plane = True
        for band in np.geomspace(
            max(params.dist_tol, bin_w), params.dist_tol, 3
        ):
            d = remaining @ n_ref - rho_ref
            sel = remaining[np.abs(d) < band]
            if len(sel) < max(params.min_inliers // 2, 3):
                ok_plane = False
                break
            c = sel.mean(0)
            cov = (sel - c).T @ (sel - c) / len(sel)
            w, V = np.linalg.eigh(cov)
            cand = V[:, 0]
            if cand @ n_ref < 0:
                cand = -cand
            n_ref = cand
            rho_ref = float(n_ref @ c)
        if not ok_plane:
            continue
        d = remaining @ n_ref - rho_ref
        inl = np.abs(d) < params.dist_tol
        if inl.sum() < params.min_inliers:
            continue
        planes.append(
            Plane(
                normal=n_ref, rho=rho_ref,
                n_inliers=int(inl.sum()),
                center=remaining[inl].mean(0),
            )
        )
        remaining = remaining[~inl]
        if len(planes) >= params.max_planes:
            break
    return planes
