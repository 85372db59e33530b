"""Continuous-time / semi-rigid registration ("srr") — the JAX-native
``correction`` pipeline (ref src/srr/: continuousreg.cc:109-230,
linescan.cc, lum6Deuler.cc(srr variant); SURVEY §2.6 srr row and §3.5).

The mobile-mapping model: every *line scan* (single scanner revolution)
carries its own pose.  Three stages, as in the reference:

1. **preRegistration** (continuousreg.cc:109-168): join two windows of
   line scans into rigid point clouds, ICP them, then distribute the
   resulting correction linearly (slerp rotation + lerp translation)
   over the line scans between the window representatives
   (linearDistributeError, continuousreg.h:28-99); subsequent line
   scans get the full correction.
2. **SemiRigidRegistration** (continuousreg.cc:180-230): overlapping
   windows (LScan: interval + size + representative), matched pairwise
   through the LUM covariance kernel; per-link 6x6 blocks scatter to
   the *representative line scans'* indices in a 6L x 6L sparse system
   (srr/lum6Deuler.cc FillGB3D), plus odometry chain factors between
   consecutive line scans; solve, update every line-scan pose.
3. Iterate.

Device mapping: line scans are a padded [L, P, 3] tensor; window point
sets are batched transforms + concatenations; all link covariances come
from the same batched kernel as GraphSLAM (models.graphslam); the
sparse 6L solve runs on host via scipy (CXSparse's role,
graphSlam6D.cc:345-366).  Odometry factors use a diagonal weight with
the LUM linearization of the pose-delta residual (the reference derives
them from synthetic single-line covariances with ``odomweight``;
equivalent regularization, simplified parametrization).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import math3d
from ..io.frames import AlgoType

__all__ = [
    "LineScanSet",
    "linear_distribute_error",
    "pre_registration",
    "semi_rigid_registration",
    "SrrParams",
]


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -np.asarray(q1)
        d = -d
    d = min(1.0, max(-1.0, d))
    th = np.arccos(d)
    if th < 1e-9:
        out = (1 - t) * np.asarray(q0) + t * np.asarray(q1)
    else:
        out = (
            np.sin((1 - t) * th) * np.asarray(q0) + np.sin(t * th) * np.asarray(q1)
        ) / np.sin(th)
    return out / np.linalg.norm(out)


@dataclasses.dataclass
class LineScanSet:
    """All line scans of a trajectory: padded points + per-line poses."""

    points: np.ndarray  # [L, P, 3] f32 local frame
    masks: np.ndarray  # [L, P] bool
    poses: np.ndarray  # [L, 4, 4] current transMat per line
    poses_org: np.ndarray  # [L, 4, 4] odometry poses (transMatOrg)
    frames: list = dataclasses.field(default_factory=list)  # pose log

    @classmethod
    def from_lists(cls, point_lists, poses):
        L = len(point_lists)
        P = max((len(p) for p in point_lists), default=1)
        P = max(P, 1)
        pts = np.zeros((L, P, 3), np.float32)
        msk = np.zeros((L, P), bool)
        for i, p in enumerate(point_lists):
            pts[i, : len(p)] = p
            msk[i, : len(p)] = True
        poses = np.asarray(poses, np.float64)
        return cls(points=pts, masks=msk, poses=poses.copy(), poses_org=poses.copy())

    @property
    def n(self) -> int:
        return len(self.points)

    def global_window(self, begin: int, end: int):
        """Concatenated global-frame points of lines [begin, end]
        (ref joinLines, continuousreg.cc)."""
        begin = max(0, begin)
        end = min(self.n - 1, end)
        chunks, masks = [], []
        for i in range(begin, end + 1):
            g = np.asarray(
                math3d.transform3(self.poses[i], self.points[i][self.masks[i]])
            )
            chunks.append(g)
        pts = np.concatenate(chunks, axis=0).astype(np.float32)
        return pts

    def record(self, algo: AlgoType) -> None:
        self.frames.append((self.poses.copy(), int(algo)))


def linear_distribute_error(
    ls: LineScanSet, begin: int, end: int, T_new_end: np.ndarray
) -> None:
    """Distribute the correction ``T_new_end · inv(poses[end])`` over
    lines (begin, end] by slerp/lerp fraction; lines after ``end`` get
    the full correction (ref continuousreg.h:28-99)."""
    length = max(end - begin, 1)
    T_old = ls.poses[end]
    diff = np.asarray(T_new_end, np.float64) @ np.asarray(math3d.m4inv(T_old))
    q_diff = np.asarray(math3d.matrix4_to_quat(diff))
    t_diff = diff[:3, 3]
    q_id = np.array([1.0, 0, 0, 0])
    for i in range(begin, end + 1):
        t = (i - begin) / length
        qi = _slerp(q_id, q_diff, t)
        Ti = np.asarray(math3d.quat_to_matrix4(qi, t_diff * t))
        ls.poses[i] = Ti @ ls.poses[i]
    for i in range(end + 1, ls.n):
        ls.poses[i] = diff @ ls.poses[i]


def pre_registration(
    ls: LineScanSet,
    first: tuple[int, int],
    last: tuple[int, int],
    *,
    max_dist_match2: float = 2500.0,
    max_iterations: int = 60,
    epsilon: float = 1e-6,
) -> None:
    """Rigid ICP of the joined `last` window against the joined `first`
    window, correction distributed along the trajectory
    (ref preRegistration, continuousreg.cc:109-168)."""
    import jax.numpy as jnp

    from . import icp as icp_mod

    fe, fl = first
    le, ll = last
    findex = fe + (fl - fe) // 2
    lindex = le + (ll - le) // 2
    model = ls.global_window(fe, fl)
    target = ls.global_window(le, ll)

    def pad(p):
        cap = ((len(p) + 511) // 512) * 512
        out = np.zeros((cap, 3), np.float32)
        out[: len(p)] = p
        m = np.zeros(cap, bool)
        m[: len(p)] = True
        return out, m

    mp, mm = pad(model)
    tp, tm = pad(target)
    res = icp_mod.icp_pair(
        jnp.asarray(mp), jnp.asarray(mm), jnp.asarray(tp), jnp.asarray(tm),
        jnp.eye(4, dtype=jnp.float32),
        max_dist_match2=max_dist_match2,
        epsilon=epsilon,
        max_iterations=max_iterations,
    )
    align = np.asarray(res.T, np.float64)
    u, _, vt = np.linalg.svd(align[:3, :3])
    align[:3, :3] = u @ vt
    # new pose of the last window's representative line
    T_new = align @ ls.poses[lindex]
    linear_distribute_error(ls, findex, lindex, T_new)
    ls.record(AlgoType.ICP)


@dataclasses.dataclass
class SrrParams:
    scaninterval: int = 10  # lines between window representatives
    scansize: int = 10  # half-window in lines
    iterations: int = 3  # outer semi-rigid iterations
    lum_max_dist2: float = 2500.0
    odom_weight: float = 10.0  # consecutive-line odometry factor weight
    cldist: float = 750.0  # proximity links between representatives
    loopsize: int = 3  # in windows
    epsilon: float = 0.05


def semi_rigid_registration(ls: LineScanSet, params: SrrParams) -> float:
    """Deform the trajectory: overlapping windows matched via the LUM
    covariance kernel, scattered into a 6L sparse system with odometry
    chain factors, solved and applied to every line scan.
    (ref SemiRigidRegistration, continuousreg.cc:180-230 +
    srr/lum6Deuler.cc doGraphSlam6D.)
    """
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from .graphslam import link_covariances

    L = ls.n
    reps = list(range(0, L, params.scaninterval))
    if reps[-1] != L - 1:
        reps.append(L - 1)
    windows = [
        (max(0, r - params.scansize), min(L - 1, r + params.scansize), r)
        for r in reps
    ]
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        # window point sets (global frame, padded uniformly)
        pts_list = [ls.global_window(b, e) for b, e, _ in windows]
        cap = ((max(len(p) for p in pts_list) + 511) // 512) * 512
        W = len(windows)
        pts = np.zeros((W, cap, 3), np.float32)
        msk = np.zeros((W, cap), bool)
        for i, p in enumerate(pts_list):
            pts[i, : len(p)] = p
            msk[i, : len(p)] = True
        # links between windows: consecutive + proximity of representatives
        rep_pos = np.stack([ls.poses[r][:3, 3] for _, _, r in windows])
        links = [(i, i + 1) for i in range(W - 1)]
        d2m = ((rep_pos[:, None] - rep_pos[None]) ** 2).sum(-1)
        for i in range(W):
            for j in range(i + 1, W):
                if (j - i) > params.loopsize and d2m[i, j] < params.cldist**2:
                    links.append((i, j))
        links_arr = np.asarray(links, np.int32)
        C, CD, m = link_covariances(
            jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(links_arr),
            jnp.float32(params.lum_max_dist2),
        )
        C = np.asarray(C, np.float64)
        CD = np.asarray(CD, np.float64)

        n = L - 1
        rowsG, colsG, valsG = [], [], []
        B = np.zeros(6 * n)

        def add_block(a, b, M):
            r, c = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
            rowsG.append((a * 6 + r).ravel())
            colsG.append((b * 6 + c).ravel())
            valsG.append(M.ravel())

        def fill(a, b, Cab, CDab):
            # _fillGB semantics (scan 0 fixed): a, b are line indices - 1
            if a >= 0:
                B[a * 6 : a * 6 + 6] += CDab
                add_block(a, a, Cab)
            if b >= 0:
                B[b * 6 : b * 6 + 6] -= CDab
                add_block(b, b, Cab)
            if a >= 0 and b >= 0:
                add_block(a, b, -Cab)
                add_block(b, a, -Cab)

        for li, (wi, wj) in enumerate(links):
            a = windows[wi][2] - 1
            b = windows[wj][2] - 1
            fill(a, b, C[li], CD[li])

        # odometry chain factors between consecutive lines: residual =
        # (current delta) - (odometry delta) in the LUM linearization
        wI = params.odom_weight * np.eye(6)
        for i in range(1, L):
            a, b = i - 2, i - 1
            cur = np.asarray(math3d.m4inv(ls.poses[i - 1])) @ ls.poses[i]
            odo = np.asarray(math3d.m4inv(ls.poses_org[i - 1])) @ ls.poses_org[i]
            ddiff = cur @ np.asarray(math3d.m4inv(odo))
            th, po = math3d.matrix4_to_euler(ddiff)
            D = np.concatenate([np.asarray(po), np.asarray(th)])
            fill(a, b, wI, wI @ D)

        G = sp.coo_matrix(
            (np.concatenate(valsG), (np.concatenate(rowsG), np.concatenate(colsG))),
            shape=(6 * n, 6 * n),
        ).tocsc()
        # tiny Tikhonov keeps rank when a line has no constraints
        G = G + sp.identity(6 * n, format="csc") * 1e-6
        X = spla.spsolve(G, B).reshape(-1, 6)

        # batched LUM pose correction through the Ha Jacobian
        from .graphslam import lum_pose_corrections

        theta, pos = math3d.matrix4_to_euler(ls.poses[1:])
        res = np.asarray(
            lum_pose_corrections(
                jnp.asarray(np.asarray(pos)),
                jnp.asarray(np.asarray(theta)),
                jnp.asarray(X),
            )
        )
        new_pos = np.asarray(pos) - res[:, :3]
        new_theta = np.asarray(theta) - res[:, 3:]
        ls.poses[1:] = np.asarray(math3d.euler_to_matrix4(new_pos, new_theta))
        sum_diff = float(np.linalg.norm(res[:, :3], axis=1).sum())
        ls.record(AlgoType.LUM)
        ret = sum_diff / L
        it += 1
    return ret
