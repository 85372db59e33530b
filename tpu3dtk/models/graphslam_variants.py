"""Alternative GraphSLAM relaxation parametrizations: quaternion LUM
(``lum6DQuat``, ref src/slam6d/lum6Dquat.cc:84-477), global helix
(``ghelix6DQ2``, ref src/slam6d/ghelix6DQ2.cc:89-457) and global
small-angle (``gapx6D``, ref src/slam6d/gapx6D.cc:76-545) — the
reference's ``-G 2/3/4`` modes next to the Euler LUM in
``models/graphslam`` (``-G 1``).

Batched design: all four parametrizations are linear(ized)
least-squares over the same point-pair set, so every per-link quantity
any of them needs is derivable from six raw sums per link:

    m   = pair count
    sa  = Σ a          sb  = Σ b          (a = NN point in scan i,
    Paa = Σ a aᵀ       Pbb = Σ b bᵀ        b = point of scan j,
    Pab = Σ a bᵀ                            both global frame)

One batched kernel (``link_raw_sums``) performs the NN search and these
reductions for *all* graph links at once (the reference loops links
under OpenMP and re-walks kd-trees per parametrization); each variant
then assembles its small system on host in f64:

- quat LUM: mid/delta moments via  Σmid = (sa+sb)/2,
  Σ mid midᵀ = (Paa+Pab+Pabᵀ+Pbb)/4, Σ mid dᵀ = (Paa−Pab+Pabᵀ−Pbb)/2,
  Σ d dᵀ = Paa−Pab−Pabᵀ+Pbb; the residual variance needs no second
  pass over pairs because  ss = (tr Σddᵀ − Dᵀ MZ) / (2m−3)  when
  D = MM⁻¹ MZ (expansion of lum6Dquat.cc:196-210).
- ghelix: per-link block tr(Pbb)I−Pbb / skew(sb) / mI and the two
  right-hand sides axial(Paa−Pab), axial(Pabᵀ−Pbb)
  (ghelix6DQ2.cc:109-151).
- gapx: centered second moments  P̃xy = Pxy − sx syᵀ/m  (both sides
  centered with cm = sa/m exactly as gapx6D.cc:190-196), Gauss–Newton
  rotation blocks, then the scan-level Laplacian translation solve
  (gapx6D.cc:76-140,453-471).  The reference's accumulation loop
  contains copy-paste slips (e.g. ``p1x*p2x + p1y + p2y`` at
  gapx6D.cc:208-210); we implement the exact Gauss–Newton normal
  equations the code intends.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math3d
from ..core.scan import TPUScan
from ..io.frames import AlgoType
from ..ops import nn as nn_ops
from .graphslam import LumParams

__all__ = [
    "link_raw_sums",
    "do_graph_slam_quat",
    "do_graph_slam_helix",
    "do_graph_slam_apx",
    "GRAPHSLAM_VARIANTS",
]


def _one_link_raw(model_g, mmask, tgt_g, tmask, max_dist2):
    """Raw pair sums for one link (i, j): NN of j's points among i's
    (the Scan::getPtPairs convention used by all FillGB-style loops)."""
    idx, d2, found = nn_ops.nn_brute(tgt_g, tmask, model_g, mmask, max_dist2)
    a = model_g[idx]
    b = tgt_g
    w = found.astype(jnp.float32)
    aw = a * w[:, None]
    bw = b * w[:, None]
    return dict(
        m=jnp.sum(w),
        sa=jnp.sum(aw, axis=0),
        sb=jnp.sum(bw, axis=0),
        Paa=aw.T @ a,
        Pbb=bw.T @ b,
        Pab=aw.T @ b,
    )


@functools.partial(jax.jit, static_argnames=("chunk",))
def link_raw_sums(points_g, masks, links, max_dist2, chunk: int = 4,
                  link_mask=None):
    """Batched raw sums for all links.  points_g: [S,N,3] f32 global
    frame; masks: [S,N]; links: [L,2] int32.  Returns a dict of [L,...]
    arrays.  ``link_mask``: padded slots skip the NN under lax.cond."""

    def one(link):
        i, j = link[0], link[1]
        return _one_link_raw(
            points_g[i], masks[i], points_g[j], masks[j], max_dist2
        )

    if link_mask is None:
        return jax.lax.map(one, links, batch_size=chunk)

    # fori_loop over VALID slots only (valid links come first in the
    # bucket): padding costs nothing; a cond under lax.map's vmapped
    # chunks would compute both branches
    L = links.shape[0]
    n_valid = jnp.sum(link_mask.astype(jnp.int32))
    shapes = jax.eval_shape(one, links[0])
    init = jax.tree_util.tree_map(
        lambda sh: jnp.zeros((L,) + sh.shape, jnp.float32), shapes
    )

    def body(k, acc):
        res = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), one(links[k])
        )
        return jax.tree_util.tree_map(
            lambda a, r: a.at[k].set(r), acc, res
        )

    return jax.lax.fori_loop(0, n_valid, body, init)


def _collect_raw(scans: list[TPUScan], links, params: LumParams):
    """Pad reduced points, transform to global, run the batched kernel;
    returns numpy f64 raw sums.

    With pinned ``device_points`` (GraphPipeline prefixes) the call is
    shape-stable: resident [S, cap] tensors + bucketed link slots, so
    repeated closures reuse one executable (the ELCH shape discipline,
    applied to the quat/unitquat variants too)."""
    E = len(links)
    if params.device_points is not None:
        locals_j, masks_j = params.device_points
        S = int(locals_j.shape[0])
        mats = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
        for si, s in enumerate(scans):
            mats[si] = s.transMat.astype(np.float32)
        cap_links = params.link_cap_min
        while cap_links < E:
            cap_links *= 2
        links_pad = np.zeros((cap_links, 2), np.int32)
        links_pad[:E] = np.asarray(links, np.int32)
        points_g = jax.vmap(math3d.transform3)(
            jnp.asarray(mats), locals_j
        )
        lmask = np.zeros(cap_links, bool)
        lmask[:E] = True
        raw = link_raw_sums(
            points_g, masks_j, jnp.asarray(links_pad),
            jnp.float32(params.max_dist_match2),
            chunk=params.link_chunk, link_mask=jnp.asarray(lmask),
        )
        return {k: np.asarray(v, np.float64)[:E] for k, v in raw.items()}
    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + params.pad_multiple - 1) // params.pad_multiple) * params.pad_multiple
    locals_pad = np.zeros((len(scans), cap, 3), np.float32)
    masks = np.zeros((len(scans), cap), bool)
    for si, s in enumerate(scans):
        r = s.reduced_local()
        locals_pad[si, : len(r)] = r
        masks[si, : len(r)] = True
    mats = np.stack([s.transMat for s in scans]).astype(np.float32)
    points_g = jax.vmap(math3d.transform3)(
        jnp.asarray(mats), jnp.asarray(locals_pad)
    )
    raw = link_raw_sums(
        points_g,
        jnp.asarray(masks),
        jnp.asarray(links, jnp.int32),
        jnp.float32(params.max_dist_match2),
        chunk=params.link_chunk,
    )
    return {k: np.asarray(v, np.float64) for k, v in raw.items()}


def _axial(P):
    return np.array([P[1, 2] - P[2, 1], P[2, 0] - P[0, 2], P[0, 1] - P[1, 0]])


def _skew(v):
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]]
    )


# ---------------------------------------------------------------- quat LUM


def _quat_link_CCD(raw, li):
    """C (7,7), CD (7,) for link li (covarianceQuat,
    lum6Dquat.cc:84-233) from raw sums."""
    m = raw["m"][li]
    if m <= 2:
        return np.zeros((7, 7)), np.zeros(7)
    sa, sb = raw["sa"][li], raw["sb"][li]
    Paa, Pbb, Pab = raw["Paa"][li], raw["Pbb"][li], raw["Pab"][li]
    smid = 0.5 * (sa + sb)
    Pmm = 0.25 * (Paa + Pab + Pab.T + Pbb)  # Σ mid midᵀ
    Pmd = 0.5 * (Paa - Pab + Pab.T - Pbb)  # Σ mid dᵀ
    Pdd = Paa - Pab - Pab.T + Pbb  # Σ d dᵀ
    sd = sa - sb

    MZ = np.empty(7)
    MZ[0:3] = sd
    MZ[3] = np.trace(Pmd)  # Σ x dx + y dy + z dz
    MZ[4:7] = -_axial(Pmd)  # Σ (z dy − y dz, x dz − z dx, y dx − x dy)

    sx, sy, sz = smid
    xx, yy, zz = Pmm[0, 0], Pmm[1, 1], Pmm[2, 2]
    xy, xz, yz = Pmm[0, 1], Pmm[0, 2], Pmm[1, 2]
    MM = np.array(
        [
            [m, 0, 0, sx, 0, -sz, sy],
            [0, m, 0, sy, sz, 0, -sx],
            [0, 0, m, sz, -sy, sx, 0],
            [sx, sy, sz, xx + yy + zz, 0, 0, 0],
            [0, sz, -sy, 0, yy + zz, -xy, -xz],
            [-sz, 0, sx, 0, -xy, xx + zz, -yz],
            [sy, -sx, 0, 0, -xz, -yz, xx + yy],
        ]
    )
    try:
        D = np.linalg.solve(MM, MZ)
    except np.linalg.LinAlgError:
        return np.zeros((7, 7)), np.zeros(7)
    ss = (np.trace(Pdd) - D @ MZ) / max(2 * m - 3, 1.0)
    if ss < 1e-13:
        return np.zeros((7, 7)), np.zeros(7)
    return MM / ss, MZ / ss


def _assemble_blocks(links, C, CD, n_scans, dof):
    """Dense G (dof·n × dof·n), B with scan 0 fixed (FillGB3D pattern,
    lum6Dquat.cc:246-279)."""
    n = n_scans - 1
    G = np.zeros((dof * n, dof * n))
    B = np.zeros(dof * n)
    for li, (f, t) in enumerate(np.asarray(links)):
        a, b = int(f) - 1, int(t) - 1
        if a >= 0:
            B[a * dof : (a + 1) * dof] += CD[li]
            G[a * dof : (a + 1) * dof, a * dof : (a + 1) * dof] += C[li]
        if b >= 0:
            B[b * dof : (b + 1) * dof] -= CD[li]
            G[b * dof : (b + 1) * dof, b * dof : (b + 1) * dof] += C[li]
        if a >= 0 and b >= 0:
            G[a * dof : (a + 1) * dof, b * dof : (b + 1) * dof] -= C[li]
            G[b * dof : (b + 1) * dof, a * dof : (a + 1) * dof] -= C[li]
    return G, B


def _solve(G, B):
    try:
        return np.linalg.solve(G, B)
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(G, B, rcond=None)[0]


def do_graph_slam_quat(
    scans: list[TPUScan], links: np.ndarray, params: LumParams
) -> float:
    """lum6DQuat::doGraphSlam6D (lum6Dquat.cc:290-477): 7-dof
    (position + unnormalized quaternion) relaxation, pose update via the
    7x7 Ha Jacobian, quaternion renormalized after the additive step."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        raw = _collect_raw(scans, links, params)
        C = np.stack([_quat_link_CCD(raw, li)[0] for li in range(len(links))])
        CD = np.stack([_quat_link_CCD(raw, li)[1] for li in range(len(links))])
        G, B = _assemble_blocks(links, C, CD, len(scans), 7)
        X = _solve(G, B).reshape(-1, 7)

        sum_position_diff = 0.0
        for i, s in enumerate(scans[1:], start=1):
            xa, ya, za = s.rPos
            p, q, r, w = np.asarray(math3d.matrix4_to_quat(s.transMat))
            Ha = np.eye(7)
            # d(global point)/d(quat) block (lum6Dquat.cc:380-416)
            px, py, pz = p * xa, p * ya, p * za
            qx, qy, qz = q * xa, q * ya, q * za
            rx, ry, rz = r * xa, r * ya, r * za
            sx, sy, sz = w * xa, w * ya, w * za
            Ha[3:7, 3] = [2 * p, 2 * q, 2 * r, 2 * w]
            Ha[3:7, 4] = [2 * q, -2 * p, -2 * w, 2 * r]
            Ha[3:7, 5] = [2 * r, 2 * w, -2 * p, -2 * q]
            Ha[3:7, 6] = [2 * w, -2 * r, 2 * q, -2 * p]
            Ha[0:3, 3] = [
                -2 * (px + sy - rz),
                -2 * (-sx + py + qz),
                -2 * (rx - qy + pz),
            ]
            Ha[0:3, 4] = [
                -2 * (qx + ry + sz),
                -2 * (-rx + qy - pz),
                -2 * (-sx + py + qz),
            ]
            Ha[0:3, 5] = [
                -2 * (rx - qy + pz),
                -2 * (qx + ry + sz),
                -2 * (-px - sy + rz),
            ]
            Ha[0:3, 6] = [
                -2 * (sx - py - qz),
                -2 * (px + sy - rz),
                -2 * (qx + ry + sz),
            ]
            result = _solve(Ha, X[i - 1])
            new_pos = np.asarray(s.rPos) - result[0:3]
            new_quat = np.array([p, q, r, w]) - result[3:7]
            new_quat /= np.linalg.norm(new_quat)
            T = np.asarray(math3d.quat_to_matrix4(new_quat, new_pos))
            s.set_pose(T, AlgoType.LUM)
            sum_position_diff += float(np.linalg.norm(result[0:3]))
        scans[0].add_frame(AlgoType.LUM)
        ret = sum_position_diff / len(scans)
        it += 1
    return ret


# ---------------------------------------------------------------- ghelix


def _helix_computeRt(ccs: np.ndarray) -> np.ndarray:
    """icp6D_HELIX::computeRt (icp6Dhelix.cc:144-204): helix parameters
    (c; c̄) → 4x4 alignment."""
    c = -ccs[0:3]
    cs = -ccs[3:6]
    clen = float(np.linalg.norm(c))
    if clen < 1e-12:
        # zero-rotation limit of the general formula below: t = cs
        T = np.eye(4)
        T[:3, 3] = cs
        return T
    angle = np.arctan(clen)
    g = c / clen
    half = -angle / 2.0
    qv = np.concatenate([[np.cos(half)], g * np.sin(half)])
    qv /= np.linalg.norm(qv)
    # the reference builds the transposed quaternion matrix
    R = np.asarray(math3d.quat_to_matrix3(qv)).T
    skew_val = float(c @ cs) / (clen * clen)
    gs = (cs - c * skew_val) / clen
    ptemp = np.cross(g, gs)
    t = R @ (-ptemp) + g * (skew_val * angle) + ptemp
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def do_graph_slam_helix(
    scans: list[TPUScan], links: np.ndarray, params: LumParams
) -> float:
    """ghelix6DQ2::doGraphSlam6D (ghelix6DQ2.cc:301-457): one global
    6(n−1) helix system  B (c;c̄) = bd  per iteration, per-scan helix
    exponential applied as alignment."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    n = len(scans) - 1
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        raw = _collect_raw(scans, links, params)
        B = np.zeros((6 * n, 6 * n))
        bd = np.zeros(6 * n)
        for li, (f, t) in enumerate(np.asarray(links)):
            m = raw["m"][li]
            if m <= 1:
                continue
            sa, sb = raw["sa"][li], raw["sb"][li]
            Paa, Pbb, Pab = raw["Paa"][li], raw["Pbb"][li], raw["Pab"][li]
            # per-link 6x6 block from the *target* (p2) points
            # (ghelix6DQ2.cc:124-133: Btemp1 sums are over p2)
            Blk = np.zeros((6, 6))
            Blk[:3, :3] = np.trace(Pbb) * np.eye(3) - Pbb
            Sk = _skew(sb)
            Blk[:3, 3:] = Sk
            Blk[3:, :3] = Sk.T
            Blk[3:, 3:] = m * np.eye(3)
            sd = sa - sb
            bd1 = np.concatenate([_axial(Paa - Pab), sd])  # Σ p1×d ; Σd
            bd2 = np.concatenate([-_axial(Pab.T - Pbb), -sd])  # −Σ p2×d ; −Σd
            a, b = int(f) - 1, int(t) - 1
            if a >= 0:
                B[a * 6 : a * 6 + 6, a * 6 : a * 6 + 6] += Blk
                bd[a * 6 : a * 6 + 6] += bd1
            if b >= 0:
                B[b * 6 : b * 6 + 6, b * 6 : b * 6 + 6] += Blk
                bd[b * 6 : b * 6 + 6] += bd2
            if a >= 0 and b >= 0:
                B[a * 6 : a * 6 + 6, b * 6 : b * 6 + 6] -= Blk
                B[b * 6 : b * 6 + 6, a * 6 : a * 6 + 6] -= Blk
        ccs = _solve(B, bd)
        sum_position_diff = 0.0
        for i, s in enumerate(scans[1:], start=1):
            T = _helix_computeRt(ccs[(i - 1) * 6 : i * 6])
            s.transform(T, AlgoType.LUM)
            sum_position_diff += float(np.linalg.norm(T[:3, 3]))
        scans[0].add_frame(AlgoType.LUM)
        ret = sum_position_diff / len(scans)
        it += 1
    return ret


# ---------------------------------------------------------------- gapx


def do_graph_slam_apx(
    scans: list[TPUScan], links: np.ndarray, params: LumParams
) -> float:
    """gapx6D::doGraphSlam6D (gapx6D.cc:323-545): decoupled global
    small-angle relaxation — first a 3(n−1) rotation system over
    per-link centered moments, then a scan-level Laplacian translation
    solve with rotated centroids; per-scan (exp([θ]×), t) alignment."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    n = len(scans) - 1
    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        raw = _collect_raw(scans, links, params)
        Brot = np.zeros((3 * n, 3 * n))
        Arot = np.zeros(3 * n)
        cms, cds = {}, {}
        for li, (f, t) in enumerate(np.asarray(links)):
            m = raw["m"][li]
            if m <= 1:
                continue
            sa, sb = raw["sa"][li], raw["sb"][li]
            Paa, Pbb, Pab = raw["Paa"][li], raw["Pbb"][li], raw["Pab"][li]
            cm = sa / m
            cd = sb / m
            cms[li], cds[li] = cm, cd
            # both sides centered with cm (gapx6D.cc:190-196)
            P11 = Paa - np.outer(sa, sa) / m
            P22 = Pbb - np.outer(sb, cm) - np.outer(cm, sb) + m * np.outer(cm, cm)
            P12 = Pab - np.outer(sa, cm) - np.outer(cm, sb) + m * np.outer(cm, cm)
            # Gauss–Newton blocks for r = d − [p̃1]×θa + [p̃2]×θb
            A_aa = np.trace(P11) * np.eye(3) - P11
            A_bb = np.trace(P22) * np.eye(3) - P22
            A_ab = P12.T - np.trace(P12) * np.eye(3)
            # RHS: Σ d×p̃1 for a, −Σ d×p̃2 for b; d = p1 − p2 (centering
            # cancels in d).  Σ d×p̃1 = axial(Σ d p̃1ᵀ)
            Pd1 = (P11 - P12.T)  # Σ d p̃1ᵀ with both centered by cm
            Pd2 = (P12 - P22)  # Σ d p̃2ᵀ
            rhs_a = _axial(Pd1)
            rhs_b = -_axial(Pd2)
            a, b = int(f) - 1, int(t) - 1
            if a >= 0:
                Brot[a * 3 : a * 3 + 3, a * 3 : a * 3 + 3] += A_aa
                Arot[a * 3 : a * 3 + 3] += rhs_a
            if b >= 0:
                Brot[b * 3 : b * 3 + 3, b * 3 : b * 3 + 3] += A_bb
                Arot[b * 3 : b * 3 + 3] += rhs_b
            if a >= 0 and b >= 0:
                Brot[a * 3 : a * 3 + 3, b * 3 : b * 3 + 3] += A_ab
                Brot[b * 3 : b * 3 + 3, a * 3 : a * 3 + 3] += A_ab.T
        X = _solve(Brot, Arot).reshape(-1, 3)

        def rot(i):
            if i == 0:
                return np.eye(3)
            th = X[i - 1]
            ang = np.linalg.norm(th)
            if ang < 1e-15:
                return np.eye(3)
            K = _skew(th / ang)
            return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)

        # translation: scan-level Laplacian (gapx6D.cc:76-140)
        Bt = np.zeros((n, n))
        At = np.zeros(3 * n)
        for li, (f, t) in enumerate(np.asarray(links)):
            if li not in cms:
                continue
            a, b = int(f) - 1, int(t) - 1
            Ak1 = rot(int(f)) @ cms[li] - rot(int(t)) @ cds[li]
            if a >= 0:
                At[a * 3 : a * 3 + 3] -= Ak1
                Bt[a, a] += 1
                Bt[a, b] -= 1
                Bt[b, a] -= 1
            At[b * 3 : b * 3 + 3] += Ak1
            Bt[b, b] += 1
        T = (_solve(np.kron(Bt, np.eye(3)), At)).reshape(-1, 3)

        sum_position_diff = 0.0
        for i, s in enumerate(scans[1:], start=1):
            align = np.eye(4)
            align[:3, :3] = rot(i)
            align[:3, 3] = T[i - 1]
            s.transform(align, AlgoType.LUM)
            sum_position_diff += float(np.linalg.norm(T[i - 1]))
        scans[0].add_frame(AlgoType.LUM)
        ret = sum_position_diff / len(scans)
        it += 1
    return ret


GRAPHSLAM_VARIANTS = {
    2: do_graph_slam_quat,
    3: do_graph_slam_helix,
    4: do_graph_slam_apx,
}
