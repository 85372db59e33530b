"""Normal estimation — JAX-native ``calculateNormalsKNN`` family
(ref src/slam6d/normals.cc:220-560, include/slam6d/normals.h:16-49).

Per point: PCA over its k nearest neighbors; the normal is the
eigenvector of the smallest eigenvalue of the neighborhood covariance,
flipped to face the viewpoint (scanner position), exactly the
reference's orientation rule (normals.cc: flip if n·(p - rPos) > 0).

Batched design: batched KNN (ops.knn), per-point 3x3 covariance by gathered
segment reductions, then a *closed-form* symmetric 3x3 eigensolver
(trigonometric Cardano + cross-product eigenvector extraction) — fully
vectorized, no per-point QR iterations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import knn as knn_ops

__all__ = [
    "estimate_normals_knn",
    "estimate_normals_adaptive_knn",
    "estimate_normals_apx_knn",
    "estimate_normals_panorama",
    "knn_pca_features",
    "smallest_eigenvector_sym3",
    "sym3_eigenvalues",
]


def sym3_eigenvalues(A):
    """All three eigenvalues of symmetric (...,3,3), ascending
    (trigonometric Cardano — same closed form as the eigenvector
    path)."""
    A = A.astype(jnp.float32)
    tr = jnp.trace(A, axis1=-2, axis2=-1)
    q = tr / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = jnp.clip(detB / jnp.maximum(2.0 * p**3, 1e-30), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    l0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    l2 = q + 2.0 * p * jnp.cos(phi)
    l1 = tr - l0 - l2
    return jnp.stack([l0, l1, l2], axis=-1)


def smallest_eigenvector_sym3(A):
    """Eigenvector of the smallest eigenvalue of symmetric (...,3,3).

    Analytic: eigenvalues via the trigonometric solution of the
    characteristic cubic; eigenvector via the largest cross product of
    the rows of (A - λI) (robust rank-2 null-space extraction).
    """
    A = A.astype(jnp.float32)
    tr = jnp.trace(A, axis1=-2, axis2=-1)
    q = tr / 3.0
    B = A - q[..., None, None] * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    detB = jnp.linalg.det(B)
    r = detB / jnp.maximum(2.0 * p**3, 1e-30)
    r = jnp.clip(r, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues: q + 2p cos(phi + 2πk/3); smallest at k=1 (phi+2π/3)
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    M = A - lam_min[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.argmax(jnp.stack([n01, n02, n12], axis=-1), axis=-1)
    cands = jnp.stack([c01, c02, c12], axis=-2)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    # degenerate (isotropic) neighborhoods: fall back to +y
    norm = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    fallback = jnp.zeros_like(v).at[..., 1].set(1.0)
    v = jnp.where(norm > 1e-12, v / jnp.maximum(norm, 1e-30), fallback)
    return v


@functools.partial(jax.jit, static_argnames=("k",))
def estimate_normals_knn(points, mask, viewpoint, k: int = 20):
    """Normals for a padded cloud from k-NN PCA.

    points: [N,3] f32 (scanner/local or global frame); mask: [N];
    viewpoint: [3] scanner position in the same frame (ref rPos arg of
    calculateNormalsKNN).  Returns normals [N,3] f32, unit length,
    oriented toward the viewpoint.
    """
    points = points.astype(jnp.float32)
    idx, d2 = knn_ops.knn_brute(points, mask, points, mask, k)
    nbrs = points[idx]  # [N, k, 3]
    valid = mask[idx]  # padded model points excluded by +inf d2 already,
    # but when fewer than k valid points exist top_k returns masked ones
    w = valid.astype(jnp.float32)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(nbrs * w, axis=1) / cnt
    cen = (nbrs - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]
    n = smallest_eigenvector_sym3(cov)
    # orient: flip so the normal points toward the viewpoint
    to_vp = viewpoint[None, :] - points
    flip = jnp.sum(n * to_vp, axis=-1) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    return jnp.where(mask[:, None], n, 0.0)


def _pca_cov(points, mask, idx):
    """Per-point neighborhood covariance from gathered KNN indices."""
    nbrs = points[idx]
    w = mask[idx].astype(jnp.float32)[..., None]
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)
    mean = jnp.sum(nbrs * w, axis=1) / cnt
    cen = (nbrs - mean[:, None, :]) * w
    cov = jnp.einsum("nki,nkj->nij", cen, cen) / cnt[..., None]
    return cov


@functools.partial(jax.jit, static_argnames=("ks", "flat_thresh"))
def estimate_normals_adaptive_knn(
    points, mask, viewpoint, ks: tuple = (8, 16, 32, 64),
    flat_thresh: float = 0.02,
):
    """Adaptive-KNN normals (ref calculateNormalsAdaptiveKNN,
    src/slam6d/normals.cc:705 region: per point, grow the neighborhood
    from kmin toward kmax until the plane fit is reliable).

    Batched re-design: the candidate k values are a STATIC ladder; PCA runs
    batched for every rung (one [N, kmax] KNN feeds all rungs) and each
    point keeps the smallest k whose surface variation
    lam0/(lam0+lam1+lam2) < flat_thresh — falling back to the largest k.
    """
    points = points.astype(jnp.float32)
    kmax = max(ks)
    idx, d2 = knn_ops.knn_brute(points, mask, points, mask, kmax)
    chosen_n = None
    chosen_ok = None
    for k in sorted(ks):
        cov = _pca_cov(points, mask, idx[:, :k])
        lam = sym3_eigenvalues(cov)
        flat = lam[..., 0] / jnp.maximum(
            lam[..., 0] + lam[..., 1] + lam[..., 2], 1e-30
        )
        n_k = smallest_eigenvector_sym3(cov)
        ok = flat < flat_thresh
        if chosen_n is None:
            chosen_n = n_k
            chosen_ok = ok
        else:
            take = ok & ~chosen_ok
            chosen_n = jnp.where(take[:, None], n_k, chosen_n)
            chosen_ok = chosen_ok | ok
    # points where no rung was flat enough keep the largest-k normal
    cov = _pca_cov(points, mask, idx)
    n_max = smallest_eigenvector_sym3(cov)
    n = jnp.where(chosen_ok[:, None], chosen_n, n_max)
    to_vp = viewpoint[None, :] - points
    flip = jnp.sum(n * to_vp, axis=-1) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    return jnp.where(mask[:, None], n, 0.0)


def estimate_normals_apx_knn(
    points, mask, viewpoint, k: int = 20, subsample: int = 4, seed: int = 0
):
    """Approximate-KNN normals (ref calculateNormalsApxKNN — the ANN
    eps-approximate search): neighbors are searched in a 1/subsample
    random subset of the cloud, cutting the NN cost by subsample^1 while
    keeping the PCA well-conditioned for smooth surfaces."""
    import numpy as np

    points = jnp.asarray(points, jnp.float32)
    N = points.shape[0]
    rng = np.random.default_rng(seed)
    keep = jnp.asarray(rng.random(N) < (1.0 / max(subsample, 1)))
    sub_mask = mask & keep
    idx, d2 = knn_ops.knn_brute(points, mask, points, sub_mask, k)
    cov = _pca_cov(points, sub_mask, idx)
    n = smallest_eigenvector_sym3(cov)
    to_vp = viewpoint[None, :] - points
    flip = jnp.sum(n * to_vp, axis=-1) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    return jnp.where(mask[:, None], n, 0.0)


def estimate_normals_panorama(
    points, viewpoint=None, width: int = 720, height: int = 240
):
    """Range-image normals (ref calculateNormalsPANORAMA,
    src/slam6d/normals.cc: project to a panorama, take normals from
    neighboring range pixels): project the LOCAL-frame cloud to an
    equirectangular range image (ops.panorama), lift the 8-neighborhood
    of each point's pixel back to 3D and PCA it — the image grid
    replaces the KNN search entirely (O(N) instead of O(N·k·search)).

    Host projection + batched device PCA; returns [N, 3] normals
    oriented toward the viewpoint (default origin)."""
    import numpy as np

    from .panorama import PanoramaParams, point_pixels, project_panorama

    pts = np.asarray(points, np.float64)
    vp = np.zeros(3) if viewpoint is None else np.asarray(viewpoint)
    params = PanoramaParams(
        method="equirectangular", width=width, height=height
    )
    pano = project_panorama(pts, params)
    idx_img = pano.index  # [H, W] source point per pixel, -1 empty
    ok = idx_img >= 0
    pix_pts = pts[np.clip(idx_img, 0, None)] * ok[..., None]
    # neighborhood PCA over the 3x3 pixel window of ACTUAL points
    shifts = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    nb = np.stack(
        [np.roll(np.roll(pix_pts, dy, 0), dx, 1) for dy, dx in shifts], 2
    )  # [H, W, 9, 3]
    vm = np.stack(
        [np.roll(np.roll(ok, dy, 0), dx, 1) for dy, dx in shifts], 2
    )
    w = vm[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(2), 1.0)
    mean = (nb * w).sum(2) / cnt
    cen = (nb - mean[:, :, None, :]) * w
    cov = np.einsum("hwki,hwkj->hwij", cen, cen) / cnt[..., None]
    H, W = idx_img.shape
    nrm_img = np.asarray(
        smallest_eigenvector_sym3(jnp.asarray(cov.reshape(-1, 3, 3)))
    ).reshape(H, W, 3)
    # sample each point's pixel (occluded points share their pixel's
    # surface normal — the reference's panorama path does the same)
    ui, vi, _valid = point_pixels(pts, params)
    n = nrm_img[vi, ui].copy()
    to_vp = vp[None, :] - pts
    flip = (n * to_vp).sum(1) < 0
    n[flip] = -n[flip]
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-30)


def knn_pca_features(points, k: int = 20, viewpoint=None):
    """(normals [N,3], curvature [N]) — curvature is the surface
    variation lam0/(lam0+lam1+lam2) (the scan2features feature set,
    src/slam6d/scan2features.cc)."""
    import numpy as np

    pts = jnp.asarray(points, jnp.float32)
    mask = jnp.ones(pts.shape[0], bool)
    vp = (
        jnp.zeros(3, jnp.float32)
        if viewpoint is None
        else jnp.asarray(viewpoint, jnp.float32)
    )
    idx, d2 = knn_ops.knn_brute(pts, mask, pts, mask, k)
    cov = _pca_cov(pts, mask, idx)
    lam = sym3_eigenvalues(cov)
    curvature = lam[..., 0] / jnp.maximum(
        lam[..., 0] + lam[..., 1] + lam[..., 2], 1e-30
    )
    n = smallest_eigenvector_sym3(cov)
    to_vp = vp[None, :] - pts
    flip = jnp.sum(n * to_vp, axis=-1) < 0.0
    n = jnp.where(flip[:, None], -n, n)
    return np.asarray(n), np.asarray(curvature)
