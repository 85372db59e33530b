"""Closed-form 6-DoF pose minimizers operating on pair sufficient
statistics — the strategy objects of the reference
(``icp6Dminimizer`` interface, include/slam6d/icp6Dminimizer.h:31-88;
selected by ``slam6D -a 1..10``, src/slam6d/slam6D.cc:696-727).

Batched formulation: every minimizer consumes the *centered sufficient
statistics* (n, centroid_m, centroid_d, S) instead of a pair list, where

    S = sum_i (d_i - cd) (m_i - cm)^T      rows = data, cols = model

matching the reference's parallel-ICP reduction (icp6D.cc:144-191,
"Parallel Iterative Closest Point" Langis/Greenspan/Godin): here the
per-thread partials become per-device partials combined with psum.  All
functions are pure, jit- and vmap-friendly, shape (…,3,3) batched.

Registered minimizers (reference algo ids) — all ten ids run distinct,
reference-matching math:
  1 QUAT   Horn unit quaternion, max eigenvector of 4x4 Q (icp6Dquat.cc:38-145)
  2 SVD    Arun SVD of cross-covariance (icp6Dsvd.cc:39-160)
  3 ORTHO  Horn orthonormal matrices, polar factor H(H^T H)^-1/2 via the
           eigendecomposition of H^T H (icp6Dortho.cc:85-135)
  4 DUAL   Walker dual quaternions (icp6Ddual.cc)
  5 HELIX  Hofer/Pottmann helical motion (icp6Dhelix.cc)
  6 APX    small-angle linearization (icp6Dapx.cc)
  7 LUMEULER / 8 LUMQUAT  Lu/Milios single-pair linearizations in Euler /
           quaternion parametrization (icp6Dlumeuler.cc, icp6Dlumquat.cc)
  9 QUATSCALE  Horn quaternion + scale (icp6Dquatscale.cc)
 10 NAPX   point-to-plane small-angle normal equations (icp6Dnapx.cc)

Returned alignment T satisfies  m ≈ T·d  and is applied on the left of
the current pose (ref Scan::transformMatrix, scan.cc:878-898).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import math3d

__all__ = [
    "PairStats",
    "pair_stats",
    "merge_stats",
    "NapxStats",
    "napx_stats",
    "align_quat",
    "align_svd",
    "align_ortho",
    "align_dual",
    "align_helix",
    "align_apx",
    "align_lumeuler",
    "align_lumquat",
    "align_quat_scale",
    "align_napx",
    "MINIMIZERS",
]

from typing import NamedTuple


class PairStats(NamedTuple):
    """Sufficient statistics of a weighted correspondence set."""

    n: jnp.ndarray  # scalar (float) number of pairs
    centroid_m: jnp.ndarray  # [3] model centroid
    centroid_d: jnp.ndarray  # [3] data centroid
    S: jnp.ndarray  # [3,3] centered cross-covariance sum_i (d-cd)(m-cm)^T
    Sdd: jnp.ndarray  # [3,3] centered data self-covariance sum_i (d-cd)(d-cd)^T
    Smm: jnp.ndarray  # [3,3] centered model self-covariance sum_i (m-cm)(m-cm)^T
    sum_d2: jnp.ndarray  # scalar sum |m_i - d_i|^2 (for RMS error)

    # -- uncentered raw sums, derived (used by dual/helix/lum forms) --
    @property
    def sum_m(self):
        return self.n * self.centroid_m

    @property
    def sum_d(self):
        return self.n * self.centroid_d

    @property
    def Dm(self):
        """sum d m^T (uncentered)."""
        return self.S + self.n * jnp.outer(self.centroid_d, self.centroid_m)

    @property
    def Dd(self):
        """sum d d^T (uncentered)."""
        return self.Sdd + self.n * jnp.outer(self.centroid_d, self.centroid_d)

    @property
    def Mm(self):
        """sum m m^T (uncentered)."""
        return self.Smm + self.n * jnp.outer(self.centroid_m, self.centroid_m)


def pair_stats(m, d, w, accum_dtype=jnp.float32, axis_name=None) -> PairStats:
    """Reduce matched pairs to sufficient statistics.

    m, d: [N,3] model/data points; w: [N] 0/1 (or soft) weights.
    Centered accumulation (two-pass: centroids first, then the second
    moments of the centred pairs); the reference uses raw-product sums
    in f64 (icp6Dquat.cc:55-98) — mathematically identical.

    ``axis_name``: when inside shard_map with pairs sharded over a mesh
    axis, pass its name — first moments psum before centering, second
    moments psum after, the Langis partial-sum merge across devices
    (icp6D.cc:144-191, icp6Dminimizer.h:61-82 Align_Parallel).

    Every sum accumulates in f64 and is rounded to ``accum_dtype`` after
    the merge, so a sharded and a single-device reduction of the same
    pairs round to the same statistics (ICP's stopping tests then take
    the same branches on any device count).
    """
    f64 = jnp.float64

    def _sum(x, axis=0):
        s = jnp.sum(x.astype(f64), axis=axis)
        return (jax.lax.psum(s, axis_name) if axis_name else s).astype(
            accum_dtype
        )

    def _outer_sum(a, b):
        return _sum(a.astype(f64)[:, :, None] * b.astype(f64)[:, None, :])

    w = w.astype(accum_dtype)
    m = m.astype(accum_dtype)
    d = d.astype(accum_dtype)
    n = _sum(w)
    ns = jnp.maximum(n, 1.0)
    cm = _sum(w[:, None] * m) / ns
    cd = _sum(w[:, None] * d) / ns
    dm = m - cm
    dd = d - cd
    wdd = w[:, None] * dd
    S = _outer_sum(wdd, dm)
    Sdd = _outer_sum(wdd, dd)
    Smm = _outer_sum(w[:, None] * dm, dm)
    diff = m - d
    # the CONVERGENCE statistic stays f64 (not rounded): at 10^5-pair
    # city scans an f32 value carries ~1e-6 relative noise — larger than
    # the 1e-6 epsilon of the two-delta test, so the error would never
    # converge and every match would burn max_iterations (the
    # reference's f64 sums resolve it, icp6D.cc:266-279).
    sum_d2 = jnp.sum((w * jnp.sum(diff * diff, axis=1)).astype(f64))
    if axis_name:
        sum_d2 = jax.lax.psum(sum_d2, axis_name)
    return PairStats(
        n=n, centroid_m=cm, centroid_d=cd, S=S, Sdd=Sdd, Smm=Smm, sum_d2=sum_d2
    )


def merge_stats(stats: PairStats) -> PairStats:
    """Combine per-shard PairStats (leading axis) into one — the Langis
    partial-sum merge (icp6Dminimizer.h:61-82 Align_Parallel).  Used with
    psum/stacked shard outputs."""
    n = jnp.sum(stats.n)
    ns = jnp.maximum(n, 1.0)
    cm = jnp.sum(stats.n[:, None] * stats.centroid_m, axis=0) / ns
    cd = jnp.sum(stats.n[:, None] * stats.centroid_d, axis=0) / ns
    # shift each shard's centered S to the global centroids:
    # S_g = sum_k [ S_k + n_k (cd_k - cd)(cm_k - cm)^T ]
    dcd = stats.centroid_d - cd
    dcm = stats.centroid_m - cm
    S = jnp.sum(stats.S, axis=0) + jnp.einsum(
        "k,ki,kj->ij", stats.n, dcd, dcm
    )
    Sdd = jnp.sum(stats.Sdd, axis=0) + jnp.einsum(
        "k,ki,kj->ij", stats.n, dcd, dcd
    )
    Smm = jnp.sum(stats.Smm, axis=0) + jnp.einsum(
        "k,ki,kj->ij", stats.n, dcm, dcm
    )
    return PairStats(
        n=n, centroid_m=cm, centroid_d=cd, S=S, Sdd=Sdd, Smm=Smm,
        sum_d2=jnp.sum(stats.sum_d2),
    )


def _finish(R, stats: PairStats):
    """Assemble T = [R | cm - R cd] and RMS error."""
    t = stats.centroid_m - R @ stats.centroid_d
    T = jnp.eye(4, dtype=R.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T, err


def _max_eigvec4(Q, iters: int = 60):
    """Dominant eigenvector of a symmetric 4x4 via shifted power
    iteration — batch-friendly replacement for eigh's QR sweeps (the
    reference solves the quartic characteristic polynomial instead,
    icp6Dquat.cc:171-320 Ferrari's method; same eigenpair).  The shift
    2·||Q||_F makes the target eigenvalue the largest in magnitude."""
    shift = 2.0 * jnp.sqrt(jnp.sum(Q * Q)) + 1e-12
    A = Q + shift * jnp.eye(4, dtype=Q.dtype)
    # A^64 v0 by 6 unrolled squarings (renormalized): fully fusable,
    # no while-loop per-iteration overhead
    A = A / (jnp.sqrt(jnp.sum(A * A)) + 1e-30)
    for _ in range(6):
        A = A @ A
        A = A / (jnp.sqrt(jnp.sum(A * A)) + 1e-30)
    v = A @ jnp.full((4,), 0.5, dtype=Q.dtype)
    # one Rayleigh-quotient polish step for f32 accuracy
    v = v / (jnp.linalg.norm(v) + 1e-30)
    v = (Q + shift * jnp.eye(4, dtype=Q.dtype)) @ v
    return v / (jnp.linalg.norm(v) + 1e-30)


def align_quat(stats: PairStats):
    """Horn's unit-quaternion method (ref icp6Dquat.cc:38-145).

    Builds the symmetric 4x4 Q from S/n and takes its maximum
    eigenvector via shifted power iteration.
    """
    S = (stats.S / jnp.maximum(stats.n, 1.0)).astype(jnp.float32)
    trace = jnp.trace(S)
    A23 = S[1, 2] - S[2, 1]
    A31 = S[2, 0] - S[0, 2]
    A12 = S[0, 1] - S[1, 0]
    Q = jnp.zeros((4, 4), dtype=S.dtype)
    Q = Q.at[0, 0].set(trace)
    Q = Q.at[0, 1:].set(jnp.array([A23, A31, A12], dtype=S.dtype))
    Q = Q.at[1:, 0].set(jnp.array([A23, A31, A12], dtype=S.dtype))
    Q = Q.at[1:, 1:].set(S + S.T - jnp.eye(3, dtype=S.dtype) * trace)
    q = _max_eigvec4(Q)  # [w, x, y, z] in the reference's convention
    R = math3d.quat_to_matrix3(q).astype(S.dtype)
    return _finish(R, stats)


def align_svd(stats: PairStats):
    """Arun's SVD method (ref icp6Dsvd.cc:39-160): H = S (rows=data),
    R = V U^T with reflection fix via sign of det."""
    H = stats.S.astype(jnp.float32)
    # 3x3 SVD via eigh of H^T H + cross-product completion:
    # eigh of a symmetric 3x3 is cheaper than a general SVD inside the
    # ICP while_loop.  U's third column is completed as u0 x u1 (det+1);
    # the reflection fix is computed from the constructed factors, which
    # projects H onto SO(3) exactly as Arun's D = diag(1,1,det) does.
    lam, V = jnp.linalg.eigh(H.T @ H)  # ascending eigenvalues
    V = V[:, ::-1]
    u0 = H @ V[:, 0]
    u0 = u0 / jnp.maximum(jnp.linalg.norm(u0), 1e-12)
    u1 = H @ V[:, 1]
    u1 = u1 - u0 * jnp.dot(u0, u1)
    u1 = u1 / jnp.maximum(jnp.linalg.norm(u1), 1e-12)
    u2 = jnp.cross(u0, u1)
    U = jnp.stack([u0, u1, u2], axis=1)
    det = jnp.linalg.det(V @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=H.dtype))
    D = D.at[2, 2].set(jnp.sign(det))
    R = V @ D @ U.T
    return _finish(R, stats)


def align_ortho(stats: PairStats):
    """Horn's orthonormal-matrix method (ref icp6Dortho.cc:85-135): with
    H = Σ m̃ d̃ᵀ, the rotation is the polar factor R = H (HᵀH)^(-1/2),
    computed — as the reference does — through the eigendecomposition of
    the symmetric 3x3 HᵀH:  R = H · Σ_i λ_i^(-1/2) e_i e_iᵀ.

    Distinct route from :func:`align_svd` (no SVD, no reflection fix);
    degenerate λ are clamped so the inverse square root stays finite.
    """
    H = stats.S.T.astype(jnp.float32)  # S = Σ d̃ m̃ᵀ  ⇒  H = Σ m̃ d̃ᵀ
    lam, E = jnp.linalg.eigh(H.T @ H)
    inv_sqrt = jax.lax.rsqrt(jnp.maximum(lam, 1e-12))
    R = H @ (E * inv_sqrt[None, :]) @ E.T
    return _finish(R, stats)


def align_apx(stats: PairStats):
    """Small-angle linearization (ref icp6Dapx.cc): R ≈ I + [a]x.

    Minimizing sum |d~ + a x d~ - m~|^2 over the rotation vector a gives
    the normal equations  A a = b  with
        A = tr(Sdd) I - Sdd          (Sdd = centered data covariance)
        b = sum d~ x m~ = axial(S)   (S = centered cross-covariance)
    The exact exponential map of a is returned (the reference applies
    the raw linearized matrix; the exponential is strictly better and
    identical to first order).
    """
    n = jnp.maximum(stats.n, 1.0)
    S = (stats.S / n).astype(jnp.float32)
    Sdd = (stats.Sdd / n).astype(jnp.float32)
    b = jnp.array(
        [S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]],
        dtype=S.dtype,
    )
    A = jnp.trace(Sdd) * jnp.eye(3, dtype=S.dtype) - Sdd
    a = jnp.linalg.solve(A, b)
    # build rotation from small-angle vector (exact exponential map)
    th = jnp.linalg.norm(a) + 1e-30
    k = a / th
    K = jnp.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=S.dtype
    )
    R = (
        jnp.eye(3, dtype=S.dtype)
        + jnp.sin(th) * K
        + (1.0 - jnp.cos(th)) * (K @ K)
    )
    return _finish(R, stats)


def _axial(P):
    """[P12-P21, P20-P02, P01-P10] — the axial vector of sum a x b for
    P = sum a b^T."""
    return jnp.stack(
        [P[1, 2] - P[2, 1], P[2, 0] - P[0, 2], P[0, 1] - P[1, 0]]
    )


def _skew(v):
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.array(
        [[z, -v[2], v[1]], [v[2], z, -v[0]], [-v[1], v[0], z]]
    )


def align_dual(stats: PairStats):
    """Walker/Shao/Volz dual-quaternion method (ref icp6Ddual.cc:41-152).

    The pair loops reduce exactly to raw sums: with P = sum m d^T,
      C1 = -2 [ tr(P),  -axial(P)^T ; -axial(P),  P + P^T - tr(P) I ]
      C2 =  2 [ 0, (sm-sd)^T ; sd-sm, -skew(sm+sd) ]
    using a x· b x· = b a^T - (a·b) I and C_a b = a x b.  The rotation
    quaternion is the max eigenvector of A = (C2^T C2/(2n) - C1 - C1^T)/2.
    """
    dt = jnp.float32
    P = stats.Dm.T.astype(dt)  # sum m d^T
    sm = stats.sum_m.astype(dt)
    sd = stats.sum_d.astype(dt)
    n = jnp.maximum(stats.n, 1.0).astype(dt)
    ax = _axial(P)
    tr = jnp.trace(P)
    C1 = jnp.zeros((4, 4), dt)
    C1 = C1.at[0, 0].set(tr)
    C1 = C1.at[0, 1:].set(-ax)
    C1 = C1.at[1:, 0].set(-ax)
    C1 = C1.at[1:, 1:].set(P + P.T - tr * jnp.eye(3, dtype=dt))
    C1 = -2.0 * C1
    C2 = jnp.zeros((4, 4), dt)
    C2 = C2.at[0, 1:].set(sm - sd)
    C2 = C2.at[1:, 0].set(sd - sm)
    C2 = C2.at[1:, 1:].set(-_skew(sm + sd))
    C2 = 2.0 * C2
    A = 0.5 * (C2.T @ C2 / (2.0 * n) - C1 - C1.T)
    qdot = _max_eigvec4(A)
    qvec = qdot[1:]
    s = -(C2 @ qdot) / (2.0 * n)
    Q = jnp.zeros((4, 4), dt)
    Q = Q.at[0, 0].set(qdot[0])
    Q = Q.at[0, 1:].set(qvec)
    Q = Q.at[1:, 0].set(-qvec)
    Q = Q.at[1:, 1:].set(qdot[0] * jnp.eye(3, dtype=dt) + _skew(qvec))
    p = Q @ s
    t = p[1:]
    qq = jnp.sum(qvec * qvec)
    R = (
        (qdot[0] * qdot[0] - qq) * jnp.eye(3, dtype=dt)
        + 2.0 * jnp.outer(qvec, qvec)
        + 2.0 * qdot[0] * _skew(qvec)
    )
    T = jnp.eye(4, dtype=dt)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T, err


def align_helix(stats: PairStats):
    """Hofer/Pottmann helical-motion approximation (ref
    icp6Dhelix.cc:48-204): solve the 6x6 system B (c; c̄) = bd built from
    data-point raw sums, then exponentiate the helix parameters.

    From raw sums: B upper-left = tr(Dd) I - Dd, coupling blocks are
    -skew(sum d), lower-right = n I; bd = (-axial(Dm); sum(d - m))
    (sum d x (d-m) = -sum d x m = -axial(Dm)).
    """
    dt = jnp.float32
    Dd = stats.Dd.astype(dt)
    Dm = stats.Dm.astype(dt)
    sd = stats.sum_d.astype(dt)
    sm = stats.sum_m.astype(dt)
    n = jnp.maximum(stats.n, 1.0).astype(dt)
    B = jnp.zeros((6, 6), dt)
    B = B.at[:3, :3].set(jnp.trace(Dd) * jnp.eye(3, dtype=dt) - Dd)
    Sk = _skew(sd)
    B = B.at[:3, 3:].set(Sk)
    B = B.at[3:, :3].set(Sk.T)
    B = B.at[3:, 3:].set(n * jnp.eye(3, dtype=dt))
    bd = jnp.concatenate([-_axial(Dm), sd - sm])
    ccs = jnp.linalg.solve(B, bd)
    # computeRt (icp6Dhelix.cc:144-204)
    c = -ccs[:3]
    cs = -ccs[3:]
    clen = jnp.sqrt(jnp.sum(c * c)) + 1e-30
    angle = jnp.arctan(clen)
    g = c / clen
    half = -angle / 2.0
    b0 = jnp.cos(half)
    bvec = g * jnp.sin(half)
    q = jnp.concatenate([b0[None], bvec])
    # computeRt writes the transposed quaternion-matrix convention
    # (icp6Dhelix.cc:169-178: R(1,2)=2(b1b2+b0b3) etc.)
    R = math3d.quat_to_matrix3(q / jnp.linalg.norm(q)).astype(dt).T
    skew_val = jnp.sum(c * cs) / (clen * clen)
    gs = (cs - c * skew_val) / clen
    ptemp = jnp.cross(g, gs)
    t = R @ (-ptemp) + g * (skew_val * angle) + ptemp
    T = jnp.eye(4, dtype=dt)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T, err


def align_quat_scale(stats: PairStats):
    """Horn unit quaternion + symmetric scale estimate (ref
    icp6Dquatscale.cc): same rotation as align_quat, scale
    s = sqrt(sum|m̃|² / sum|d̃|²), translation cm - s R cd."""
    T, err = align_quat(stats)
    R = T[:3, :3]
    s = jnp.sqrt(
        jnp.maximum(jnp.trace(stats.Smm), 1e-30)
        / jnp.maximum(jnp.trace(stats.Sdd), 1e-30)
    ).astype(R.dtype)
    Ts = jnp.eye(4, dtype=R.dtype)
    Ts = Ts.at[:3, :3].set(s * R)
    Ts = Ts.at[:3, 3].set(
        stats.centroid_m.astype(R.dtype)
        - s * (R @ stats.centroid_d.astype(R.dtype))
    )
    return Ts, err


def _mid_delta_system(stats: PairStats):
    """MZ (6,) and MM (6,6) of the Lu/Milios linearization over
    midpoints u = (m+d)/2 and deltas d̃ = m - d — the same sums as
    covarianceEuler (lum6Deuler.cc:141-195), derived from raw moments:
      sum u        = (sm + sd)/2
      sum u u^T    = (Mm + Dd + Dm + Dm^T)/4
      sum delta    = sm - sd
      sum u x delta-ish terms from cross moments.
    """
    dt = jnp.float32
    n = jnp.maximum(stats.n, 1.0).astype(dt)
    sm, sd = stats.sum_m.astype(dt), stats.sum_d.astype(dt)
    Mm, Dd, Dm = stats.Mm.astype(dt), stats.Dd.astype(dt), stats.Dm.astype(dt)
    su = 0.5 * (sm + sd)
    Uu = 0.25 * (Mm + Dd + Dm + Dm.T)
    sdelta = sm - sd
    # sum u x delta = sum ((m+d)/2) x (m-d) = sum d x m = axial(Dm)
    # reference component ordering (lum6Deuler.cc:170-175):
    #   MZ4 = sum(-z dy + y dz) = (u x δ)_x
    #   MZ5 = sum(-y dx + x dy) = (u x δ)_z
    #   MZ6 = sum( z dx - x dz) = (u x δ)_y
    ux_delta = _axial(Dm)
    MZ = jnp.concatenate(
        [sdelta, jnp.stack([ux_delta[0], ux_delta[2], ux_delta[1]])]
    )
    x2 = Uu[0, 0]
    y2 = Uu[1, 1]
    z2 = Uu[2, 2]
    sx, sy, sz = su
    xy, xz, yz = Uu[0, 1], Uu[0, 2], Uu[1, 2]
    MM = jnp.array(
        [
            [n, 0, 0, 0, -sy, sz],
            [0, n, 0, -sz, sx, 0],
            [0, 0, n, sy, 0, -sx],
            [0, -sz, sy, y2 + z2, -xz, -xy],
            [-sy, sx, 0, -xz, x2 + y2, -yz],
            [sz, 0, -sx, -xy, -yz, x2 + z2],
        ],
        dtype=dt,
    )
    return MZ, MM


def align_lumeuler(stats: PairStats, T_cur=None):
    """Lu/Milios single-pair Euler minimizer (ref icp6Dlumeuler.cc):
    pose-difference estimate Ehat = MM^-1 MZ in the global frame, mapped
    through the pose Jacobian H at the current pose; the applied
    alignment is T1 T2^-1."""
    MZ, MM = _mid_delta_system(stats)
    Ehat = jnp.linalg.solve(MM, MZ)
    dt = MZ.dtype
    if T_cur is None:
        T_cur = jnp.eye(4, dtype=dt)
    T_cur = T_cur.astype(dt)
    theta, pos = math3d.matrix4_to_euler(T_cur)
    tx, ty, tz = pos
    cx, sx_ = jnp.cos(theta[0]), jnp.sin(theta[0])
    cy, sy_ = jnp.cos(theta[1]), jnp.sin(theta[1])
    H = jnp.eye(6, dtype=dt)
    H = H.at[0, 4].set(-tz * cx + ty * sx_)
    H = H.at[0, 5].set(ty * cx * cy + tz * cy * sx_)
    H = H.at[1, 3].set(tz)
    H = H.at[1, 4].set(-tx * sx_)
    H = H.at[1, 5].set(-tx * cx * cy + tz * sy_)
    H = H.at[2, 3].set(-ty)
    H = H.at[2, 4].set(tx * cx)
    H = H.at[2, 5].set(-tx * cy * sx_ - ty * sy_)
    H = H.at[3, 5].set(sy_)
    H = H.at[4, 4].set(sx_)
    H = H.at[4, 5].set(cx * cy)
    H = H.at[5, 4].set(cx)
    H = H.at[5, 5].set(-cy * sx_)
    Xhat = jnp.concatenate([pos, theta])
    X = Xhat - jnp.linalg.solve(H, Ehat)
    T1 = math3d.euler_to_matrix4(pos, theta).astype(dt)
    T2 = math3d.euler_to_matrix4(X[:3], X[3:]).astype(dt)
    T_inc = T1 @ math3d.m4inv(T2).astype(dt)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T_inc, err


def align_lumquat(stats: PairStats, T_cur=None):
    """Lu/Milios single-pair **quaternion** minimizer (ref
    icp6Dlumquat.cc:40-230): the 7-dof linearization over midpoints
    u = (m+d)/2 and deltas δ = m−d,

        MZ = [Σδ ; Σu·δ ; Σ(z δy − y δz) ; Σ(x δz − z δx) ; Σ(y δx − x δy)]
        MM = the 7x7 Gram matrix of (t, quat) observations,

    solved for Ehat = MM⁻¹MZ, then mapped through the pose Jacobian H
    (identity / −2T / 2U blocks built from the current quaternion and
    translation, icp6Dlumquat.cc:146-160) and returned as T1·T2⁻¹.

    Raw sums derive exactly from PairStats moments:
    Σu = (sm+sd)/2, Σuuᵀ = (Mm+Dd+Dm+Dmᵀ)/4, Σδ = sm−sd,
    Σu·δ = (tr Mm − tr Dd)/2, Σu×δ = axial(Dm).  (Deviation: the
    reference computes the midpoint x-component as (p1.x+p1.x)/2 —
    an evident typo for (p1.x+p2.x)/2; we use the true midpoint.)
    """
    dt = jnp.float32
    n = jnp.maximum(stats.n, 1.0).astype(dt)
    sm, sd = stats.sum_m.astype(dt), stats.sum_d.astype(dt)
    Mm, Dd, Dm = stats.Mm.astype(dt), stats.Dd.astype(dt), stats.Dm.astype(dt)
    su = 0.5 * (sm + sd)
    Uu = 0.25 * (Mm + Dd + Dm + Dm.T)
    sdelta = sm - sd
    u_dot_delta = 0.5 * (jnp.trace(Mm) - jnp.trace(Dd))
    uxd = _axial(Dm)  # Σ u×δ
    MZ = jnp.concatenate([sdelta, u_dot_delta[None], -uxd])
    sx, sy, sz = su
    xy, xz, yz = Uu[0, 1], Uu[0, 2], Uu[1, 2]
    x2, y2, z2 = Uu[0, 0], Uu[1, 1], Uu[2, 2]
    z_ = jnp.zeros((), dt)
    MM = jnp.array(
        [
            [n, z_, z_, sx, z_, -sz, sy],
            [z_, n, z_, sy, sz, z_, -sx],
            [z_, z_, n, sz, -sy, sx, z_],
            [sx, sy, sz, x2 + y2 + z2, z_, z_, z_],
            [z_, sz, -sy, z_, y2 + z2, -xy, -xz],
            [-sz, z_, sx, z_, -xy, x2 + z2, -yz],
            [sy, -sx, z_, z_, -xz, -yz, x2 + y2],
        ],
        dtype=dt,
    )
    Ehat = jnp.linalg.solve(MM, MZ)
    if T_cur is None:
        T_cur = jnp.eye(4, dtype=dt)
    T_cur = T_cur.astype(dt)
    quat = math3d.matrix4_to_quat(T_cur).astype(dt)
    p, q, r, s = quat
    x, y, zc = T_cur[0, 3], T_cur[1, 3], T_cur[2, 3]
    U = jnp.array(
        [
            [p, q, r, s],
            [q, -p, s, -r],
            [r, -s, -p, q],
            [s, r, -q, -p],
        ],
        dtype=dt,
    )
    Tm = jnp.array(
        [
            [p * x + s * y - r * zc, q * x + r * y + s * zc,
             r * x - q * y + p * zc, s * x - p * y - q * zc],
            [-s * x + p * y + q * zc, -r * x + q * y - p * zc,
             q * x + r * y + s * zc, p * x + s * y - r * zc],
            [r * x - q * y + p * zc, -s * x + p * y + q * zc,
             -p * x - s * y + r * zc, q * x + r * y - s * zc],
        ],
        dtype=dt,
    )
    H = jnp.zeros((7, 7), dt)
    H = H.at[:3, :3].set(jnp.eye(3, dtype=dt))
    H = H.at[:3, 3:].set(-2.0 * Tm)
    H = H.at[3:, 3:].set(2.0 * U)
    Xhat = jnp.concatenate([jnp.stack([x, y, zc]), quat])
    X = Xhat - jnp.linalg.solve(H, Ehat)
    # R(q) with the raw (unnormalized) quaternion, exactly as the
    # reference builds T2 (icp6Dlumquat.cc:190-215).  T2's rotation is
    # scaled by |q|², so it needs a TRUE matrix inverse (the reference
    # uses newmat T2.i()) — the rigid-pose shortcut m4inv would leak a
    # scale factor into T_inc and diverge under iteration.
    T1 = math3d.quat_to_matrix4(quat, jnp.stack([x, y, zc])).astype(dt)
    T2 = math3d.quat_to_matrix4(X[3:], X[:3]).astype(dt)
    T_inc = T1 @ jnp.linalg.inv(T2)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T_inc, err


class NapxStats(NamedTuple):
    """Sufficient statistics of the point-to-plane linearization
    (icp6Dnapx.cc): per pair, residual d = (m−t)·n̂, lever c = (t−cd)×n̂;
    A = Σ [c;n][c;n]ᵀ (6x6), b = Σ d·[c;n] (6,)."""

    n: jnp.ndarray
    A: jnp.ndarray  # [6,6]
    b: jnp.ndarray  # [6]
    centroid_d: jnp.ndarray  # [3]
    sum_d2: jnp.ndarray  # Σ d² (point-to-plane RMS)


def napx_stats(m, t, normals, w, accum_dtype=jnp.float32, axis_name=None) -> NapxStats:
    """Reduce matched pairs + target normals to NapxStats.

    m: [N,3] matched model points, t: [N,3] target points (data),
    normals: [N,3] unit normals at the target points, w: [N] weights.
    ``axis_name``: psum-merge partials over a mesh axis (see pair_stats).
    """
    def _merge(v):
        return jax.lax.psum(v, axis_name) if axis_name else v

    w = w.astype(accum_dtype)
    m = m.astype(accum_dtype)
    t = t.astype(accum_dtype)
    nrm = normals.astype(accum_dtype)
    n = _merge(jnp.sum(w))
    ns = jnp.maximum(n, 1.0)
    cd = _merge(jnp.sum(w[:, None] * t, axis=0)) / ns
    d = jnp.sum((m - t) * nrm, axis=1)
    c = jnp.cross(t - cd, nrm)
    J = jnp.concatenate([c, nrm], axis=1)  # [N,6]
    wJ = w[:, None] * J
    A = _merge(jnp.einsum("ni,nj->ij", wJ, J))
    b = _merge(jnp.sum(wJ * d[:, None], axis=0))
    sum_d2 = _merge(jnp.sum(w * d * d))
    return NapxStats(n=n, A=A, b=b, centroid_d=cd, sum_d2=sum_d2)


def align_napx(stats: NapxStats):
    """Point-to-plane small-angle minimizer (ref icp6Dnapx.cc:36-150):
    solve A x = b for x = (sin-angles; translation), interpret x[0:3] as
    the sines of the Euler angles and rebuild R in the reference's
    EulerToMatrix4 layout, with translation x[3:6] recentred about the
    data centroid:  t = x[3:] + cd − R·cd.

    Deviation (documented): the reference accumulates B = Σ[c;n]
    without the residual factor d — an evident bug in the linearized
    normal equations (Low, "Linear Least-Squares Optimization for
    Point-to-Plane ICP"); we use the correct b = Σ d·[c;n].
    """
    dt = jnp.float32
    A = stats.A.astype(dt) + 1e-9 * jnp.eye(6, dtype=dt)
    x = jnp.linalg.solve(A, stats.b.astype(dt))
    sines = jnp.clip(x[:3], -1.0, 1.0)
    theta = jnp.arcsin(sines)
    R = math3d.euler_to_matrix3(theta).astype(dt)
    cd = stats.centroid_d.astype(dt)
    t = x[3:] + cd - R @ cd
    T = jnp.eye(4, dtype=dt)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    err = jnp.sqrt(stats.sum_d2 / jnp.maximum(stats.n, 1.0))
    return T, err


MINIMIZERS = {
    "quat": align_quat,  # -a 1  (icp6Dquat.cc)
    "svd": align_svd,  # -a 2  (icp6Dsvd.cc)
    "ortho": align_ortho,  # -a 3  (icp6Dortho.cc polar factor via eigh)
    "dual": align_dual,  # -a 4  (icp6Ddual.cc)
    "helix": align_helix,  # -a 5  (icp6Dhelix.cc)
    "apx": align_apx,  # -a 6  (icp6Dapx.cc)
    "lumeuler": align_lumeuler,  # -a 7 (icp6Dlumeuler.cc)
    "lumquat": align_lumquat,  # -a 8 (icp6Dlumquat.cc 7-dof linearization)
    "quatscale": align_quat_scale,  # -a 9 (icp6Dquatscale.cc)
    "napx": align_napx,  # -a 10 (icp6Dnapx.cc; NapxStats, needs normals)
}
