"""Build the accuracy oracle (BASELINE.md step 2).

The reference binary cannot be built here (no Boost/SuiteSparse, zero
egress), so the oracle is an INDEPENDENT f64 CPU implementation of the
reference pipeline — scipy cKDTree NN (the kd-tree role,
include/slam6d/kdTreeImpl.h:345), f64 Horn-quaternion ICP
(src/slam6d/icp6D.cc:104-285) and f64 LUM relaxation
(src/slam6d/lum6Deuler.cc:94-477) — run to tight convergence.  Its
final poses are committed as golden `.frames`:

- tests/golden/dat/       — the bundled dat/ 3-scan sequence
  (metascan ICP + LUM, the bench.py workload)
- tests/golden/loop60/    — a synthetic 60-scan loop with EXACT
  ground-truth poses (written directly; the pipeline must recover them)

tests/test_ate.py asserts the JAX pipeline's ATE against these files;
bench.py reports the dat ATE every run.

Usage: PYTHONPATH=/root/repo python scripts/make_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


# ---------------------------------------------------------------------------
# f64 reference-equivalent ICP (same math as measure_reference.py)
# ---------------------------------------------------------------------------


def horn_quat_f64(m, t):
    n = len(m)
    cm, cd = m.mean(0), t.mean(0)
    S = (t - cd).T @ (m - cm) / n
    tr = np.trace(S)
    A = np.array([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]])
    Q = np.empty((4, 4))
    Q[0, 0] = tr
    Q[0, 1:] = A
    Q[1:, 0] = A
    Q[1:, 1:] = S + S.T - np.eye(3) * tr
    w, v = np.linalg.eigh(Q)
    qw, qx, qy, qz = v[:, -1]
    R = np.array(
        [
            [qw * qw + qx * qx - qy * qy - qz * qz, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), qw * qw - qx * qx + qy * qy - qz * qz, 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), qw * qw - qx * qx - qy * qy + qz * qz],
        ]
    )
    align = np.eye(4)
    align[:3, :3] = R
    align[:3, 3] = cm - R @ cd
    return align


def icp_f64(model, target_local, T0, max_dist2, max_iter=200, eps=1e-9):
    tree = cKDTree(model)
    T = T0.copy()
    ret = prev = prev2 = 0.0
    for _ in range(max_iter):
        prev2, prev = prev, ret
        tgt = target_local @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(tgt, workers=-1)
        sel = d * d < max_dist2
        if sel.sum() <= 3:
            break
        align = horn_quat_f64(model[idx[sel]], tgt[sel])
        T = align @ T
        ret = float(np.sqrt((d[sel] ** 2).mean()))
        if abs(ret - prev) < eps and abs(ret - prev2) < eps:
            break
    return T


# ---------------------------------------------------------------------------
# f64 reference-equivalent LUM (lum6Deuler.cc math, independent impl)
# ---------------------------------------------------------------------------


def lum_link_f64(pi, pj, max_dist2):
    """C (6,6), CD (6,) for one link: NN of j's points among i's."""
    tree = cKDTree(pi)
    d, idx = tree.query(pj, workers=-1)
    sel = d * d < max_dist2
    a, b = pi[idx[sel]], pj[sel]
    m = sel.sum()
    if m <= 2:
        return np.zeros((6, 6)), np.zeros(6)
    mid = 0.5 * (a + b)
    dd = a - b
    x, y, z = mid.T
    dx, dy, dz = dd.T
    MZ = np.array(
        [
            dx.sum(), dy.sum(), dz.sum(),
            (-z * dy + y * dz).sum(),
            (-y * dx + x * dy).sum(),
            (z * dx - x * dz).sum(),
        ]
    )
    sx, sy, sz = x.sum(), y.sum(), z.sum()
    xpy = (x * x + y * y).sum()
    xpz = (x * x + z * z).sum()
    ypz = (y * y + z * z).sum()
    xy, xz, yz = (x * y).sum(), (x * z).sum(), (y * z).sum()
    MM = np.array(
        [
            [m, 0, 0, 0, -sy, sz],
            [0, m, 0, -sz, sx, 0],
            [0, 0, m, sy, 0, -sx],
            [0, -sz, sy, ypz, -xz, -xy],
            [-sy, sx, 0, -xz, xpy, -yz],
            [sz, 0, -sx, -xy, -yz, xpz],
        ],
        dtype=np.float64,
    )
    D = np.linalg.solve(MM, MZ)
    rx = dx - (D[0] - y * D[4] + z * D[5])
    ry = dy - (D[1] - z * D[3] + x * D[4])
    rz = dz - (D[2] + y * D[3] - x * D[5])
    ss = (rx * rx + ry * ry + rz * rz).sum() / max(2 * m - 3, 1)
    if ss < 1e-13:
        return np.zeros((6, 6)), np.zeros(6)
    return MM / ss, MZ / ss


def lum_f64(locals_, mats, links, max_dist2, iters=50, eps=1e-4):
    """Full f64 LUM over the graph; mutates/returns pose list."""
    from tpu3dtk.core import math3d

    mats = [m.copy() for m in mats]
    n = len(mats)
    for _ in range(iters):
        pts_g = [l @ M[:3, :3].T + M[:3, 3] for l, M in zip(locals_, mats)]
        G = np.zeros((6 * (n - 1), 6 * (n - 1)))
        B = np.zeros(6 * (n - 1))
        for (f, t) in links:
            C, CD = lum_link_f64(pts_g[f], pts_g[t], max_dist2)
            a, b = f - 1, t - 1
            if a >= 0:
                B[a * 6 : a * 6 + 6] += CD
                G[a * 6 : a * 6 + 6, a * 6 : a * 6 + 6] += C
            if b >= 0:
                B[b * 6 : b * 6 + 6] -= CD
                G[b * 6 : b * 6 + 6, b * 6 : b * 6 + 6] += C
            if a >= 0 and b >= 0:
                G[a * 6 : a * 6 + 6, b * 6 : b * 6 + 6] -= C
                G[b * 6 : b * 6 + 6, a * 6 : a * 6 + 6] -= C
        X = np.linalg.solve(G, B).reshape(-1, 6)
        shift = 0.0
        for k in range(1, n):
            theta, pos = math3d.matrix4_to_euler(mats[k], xp=np)
            xa, ya, za = pos
            tx, ty = theta[0], theta[1]
            ctx, stx = np.cos(tx), np.sin(tx)
            cty, sty = np.cos(ty), np.sin(ty)
            Ha = np.eye(6)
            Ha[0, 4] = -za * ctx + ya * stx
            Ha[0, 5] = ya * cty * ctx + za * stx * cty
            Ha[1, 3] = za
            Ha[1, 4] = -xa * stx
            Ha[1, 5] = -xa * ctx * cty + za * sty
            Ha[2, 3] = -ya
            Ha[2, 4] = xa * ctx
            Ha[2, 5] = -xa * cty * stx - ya * sty
            Ha[3, 5] = sty
            Ha[4, 4] = stx
            Ha[4, 5] = ctx * cty
            Ha[5, 4] = ctx
            Ha[5, 5] = -stx * cty
            corr = np.linalg.solve(Ha, X[k - 1])
            new_pos = pos - corr[:3]
            new_theta = theta - corr[3:]
            mats[k] = np.asarray(
                math3d.euler_to_matrix4(new_pos, new_theta, xp=np)
            )
            shift += float(np.linalg.norm(corr[:3]))
        if shift / n < eps:
            break
    return mats


# ---------------------------------------------------------------------------
# golden writers
# ---------------------------------------------------------------------------


def write_final_frames(out_dir, identifiers, mats):
    from tpu3dtk.core import math3d

    os.makedirs(out_dir, exist_ok=True)
    for ident, M in zip(identifiers, mats):
        cm = np.asarray(math3d.to_colmajor16(M, xp=np), np.float64)
        with open(os.path.join(out_dir, f"scan{ident}.frames"), "w") as f:
            f.write(" ".join(f"{v:.9g}" for v in cm) + " 2\n")


def golden_dat():
    from tpu3dtk.core import math3d
    from tpu3dtk.core.scan import TPUScan
    from tpu3dtk.io.scandir import PointFilter, read_scan_dir

    dat = "/root/reference/dat"
    scans = []
    for raw in read_scan_dir(
        dat, format="uos", point_filter=PointFilter(range_max=500.0)
    ):
        s = TPUScan.from_raw(raw)
        s.set_reduction(10.2, 1)
        scans.append(s)
    reduced = [np.asarray(s.reduced_local(), np.float64) for s in scans]
    mats = [s.transMat.copy() for s in scans]
    # sequential metascan ICP, then LUM over the full graph (the
    # bench.py dat workload with tight f64 convergence)
    for i in range(1, len(scans)):
        delta = mats[i - 1] @ np.asarray(math3d.m4inv(scans[i - 1].transMatOrg))
        T0 = delta @ mats[i]
        model = np.concatenate(
            [r @ M[:3, :3].T + M[:3, 3] for r, M in zip(reduced[:i], mats[:i])]
        )
        # PROTOCOL-MATCHED oracle (frozen, round 3): the reference's
        # default regime is -i 50; the JAX pipeline, this oracle, the
        # ATE test and bench.py all run ICP 50 iters / eps 1e-7 so the
        # ATE measures f32-vs-f64 + algorithmic drift, not iteration-
        # count mismatch.
        mats[i] = icp_f64(model, reduced[i], T0, 625.0, max_iter=50, eps=1e-7)
    links = [(i, i + 1) for i in range(len(scans) - 1)] + [(0, len(scans) - 1)]
    mats = lum_f64(reduced, mats, links, 625.0, iters=50, eps=1e-5)
    write_final_frames(
        os.path.join(GOLDEN, "dat"), [s.identifier for s in scans], mats
    )
    print("golden dat written:", [np.round(m[:3, 3], 2) for m in mats])


def synth_loop(n_scans=60, seed=7, n_pts=6000, density=1.0):
    """Deterministic synthetic loop: a room-scape sampled from poses on
    a closed circuit, odometry poses perturbed with drift-like noise.
    Returns (locals, true_mats, odo_mats).  ``n_pts``: points per scan
    sample; ``density``: environment point multiplier (raise together
    to simulate denser sensors for the 16k-point bench variant)."""
    from tpu3dtk.core import math3d

    rng = np.random.default_rng(seed)
    # environment: walls of a big hall + pillars (well-constrained)
    walls = []
    size = 4000.0
    n_face = int(9000 * density)
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, (n_face, 3))
            p[:, axis] = side
            walls.append(p)
    for _ in range(14):  # pillars
        c = rng.uniform(500, size - 500, 2)
        n_pillar = int(800 * density)
        ang = rng.uniform(0, 2 * np.pi, n_pillar)
        r = 60.0
        pts = np.stack(
            [c[0] + r * np.cos(ang), rng.uniform(0, size, n_pillar),
             c[1] + r * np.sin(ang)],
            axis=1,
        )
        walls.append(pts)
    env = np.concatenate(walls)

    true_mats, odo_mats, locals_ = [], [], []
    drift = np.zeros(3)
    for k in range(n_scans):
        ang = 2 * np.pi * k / n_scans
        center = np.array(
            [size / 2 + 1200 * np.cos(ang), size / 2, size / 2 + 1200 * np.sin(ang)]
        )
        theta = np.array([0.0, -ang, 0.0])
        T = np.asarray(math3d.euler_to_matrix4(center, theta, xp=np))
        true_mats.append(T)
        # simulated scan: environment points within range, in local frame
        d2 = ((env - center) ** 2).sum(1)
        vis = env[d2 < 1500.0**2]
        vis = vis[rng.permutation(len(vis))[:n_pts]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)  # 1 cm sensor noise
        locals_.append(local.astype(np.float32))
        # odometry: true pose + accumulating drift
        drift += rng.normal(0, 6.0, 3)
        To = T.copy()
        To[:3, 3] += drift
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def synth_ring(n_scans=468, n_pts=16384, radius=4500.0, half_width=300.0,
               half_height=600.0, laps=1.3, drift=2.0, seed=11):
    """The hannover2 regime: a ring CORRIDOR (two cylindrical walls +
    floor + ceiling + pillars) traversed for ``laps`` laps, so the
    second lap continuously re-visits the first — the -L 4 continuous
    loop-closure schedule of the reference (README.md hannover2 config).
    Unlike :func:`synth_loop`, the geometry scales with n_scans: scan
    spacing stays sensor-realistic (~laps·2πR/n cm) instead of shrinking
    to nothing.  Returns (locals [n][n_pts,3] f32, true_mats, odo_mats).
    """
    from tpu3dtk.core import math3d

    rng = np.random.default_rng(seed)
    cy = 0.0
    # corridor surface sampling: area-weighted among inner wall, outer
    # wall, floor, ceiling; ~1.2M points for a 45 m ring
    n_env = 1_200_000
    phi = rng.uniform(0, 2 * np.pi, n_env)
    kind = rng.integers(0, 4, n_env)
    r = np.where(
        kind == 0, radius - half_width,
        np.where(kind == 1, radius + half_width,
                 rng.uniform(radius - half_width, radius + half_width, n_env)),
    )
    y = np.where(
        kind == 2, cy - half_height,
        np.where(kind == 3, cy + half_height,
                 rng.uniform(cy - half_height, cy + half_height, n_env)),
    )
    env = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    # pillars along the ring every ~15 degrees
    extra = [env]
    for a in np.arange(0, 2 * np.pi, np.pi / 12):
        n_p = 3000
        ang = rng.uniform(0, 2 * np.pi, n_p)
        pr = 40.0
        c = np.array([radius * np.cos(a), 0.0, radius * np.sin(a)])
        extra.append(np.stack(
            [c[0] + pr * np.cos(ang),
             rng.uniform(cy - half_height, cy + half_height, n_p),
             c[2] + pr * np.sin(ang)], axis=1,
        ))
    # clutter boxes on the corridor floor: the asymmetric structure
    # that anchors the tangential DOF (a bare ring corridor is
    # rotationally symmetric — ICP's cost valley is flat along the
    # tangent and sparse-sampling noise makes the chain slide)
    n_boxes = 240
    for _ in range(n_boxes):
        a = rng.uniform(0, 2 * np.pi)
        br = rng.uniform(radius - half_width + 60, radius + half_width - 60)
        c = np.array([br * np.cos(a), cy - half_height, br * np.sin(a)])
        w, d, h = rng.uniform(40, 160, 3)
        yaw = rng.uniform(0, 2 * np.pi)
        n_b = 2200
        face = rng.integers(0, 5, n_b)  # 4 sides + top
        u, v = rng.uniform(0, 1, n_b), rng.uniform(0, 1, n_b)
        bx = np.where(face == 0, 0.0, np.where(face == 1, w, u * w))
        bz = np.where(face == 2, 0.0, np.where(face == 3, d, v * d))
        bx = np.where(face >= 2, u * w, bx)
        bz = np.where(face < 2, v * d, bz)
        by = np.where(face == 4, h, v * h)
        bx, bz = bx - w / 2, bz - d / 2
        ca, sa = np.cos(yaw), np.sin(yaw)
        pts = np.stack(
            [c[0] + ca * bx - sa * bz, c[1] + by, c[2] + sa * bx + ca * bz],
            axis=1,
        )
        extra.append(pts)
    env = np.concatenate(extra).astype(np.float32)

    range_max = 8.0 * half_width
    true_mats, odo_mats, locals_ = [], [], []
    dacc = np.zeros(3)
    for k in range(n_scans):
        ang = laps * 2 * np.pi * k / n_scans
        center = np.array(
            [radius * np.cos(ang), cy, radius * np.sin(ang)]
        )
        theta = np.array([0.0, -ang, 0.0])
        T = np.asarray(math3d.euler_to_matrix4(center, theta, xp=np))
        true_mats.append(T)
        d2 = ((env - center) ** 2).sum(1)
        inr = d2 < range_max**2
        vis = env[inr]
        # solid-angle sampling (P ∝ 1/d²): a real scanner resolves
        # nearby surfaces densely — uniform-area sampling leaves ~25 cm
        # inter-scan surface gaps everywhere and ICP walks the
        # resulting flat cost valley (measured 2 m per-match error)
        w = 1.0 / np.maximum(d2[inr], 100.0**2)
        take = min(n_pts, len(vis))
        sel = rng.choice(len(vis), take, replace=False, p=w / w.sum())
        vis = vis[sel]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)  # 1 cm sensor noise
        locals_.append(local.astype(np.float32))
        dacc += rng.normal(0, drift, 3)
        To = T.copy()
        To[:3, 3] += dacc
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def synth_city(n_scans=13, n_pts=1_000_000, seed=23):
    """The bremen_city regime: ~13 dense terrestrial scans (≥1M raw
    points each) of a city block — ground plane + building facades —
    taken along a street path (README.md:97-103: riegl_txt, -r 10
    octree reduction, -d 150 matching).  Returns (locals, true_mats,
    odo_mats); locals are RAW (unreduced) f32 clouds."""
    from tpu3dtk.core import math3d

    rng = np.random.default_rng(seed)
    area = 14000.0  # 140 m square
    parts = []
    n_ground = 2_500_000
    g = rng.uniform(0, area, (n_ground, 2))
    parts.append(np.stack([g[:, 0], np.zeros(n_ground), g[:, 1]], axis=1))
    # building blocks on a grid with street gaps
    for bx in range(4):
        for bz in range(4):
            x0, z0 = 800 + bx * 3500, 800 + bz * 3500
            w, d, h = 2200.0, 2200.0, rng.uniform(800, 2500)
            n_f = 160_000
            side = rng.integers(0, 4, n_f)
            u = rng.uniform(0, 1, n_f)
            yy = rng.uniform(0, h, n_f)
            xx = np.where(side == 0, x0, np.where(side == 1, x0 + w, x0 + u * w))
            zz = np.where(side == 2, z0, np.where(side == 3, z0 + d, z0 + u * d))
            xx = np.where(side >= 2, x0 + u * w, xx)
            zz = np.where(side < 2, z0 + u * d, zz)
            parts.append(np.stack([xx, yy, zz], axis=1))
    env = np.concatenate(parts).astype(np.float32)

    range_max = 5000.0
    true_mats, odo_mats, locals_ = [], [], []
    dacc = np.zeros(3)
    # street path: L-shaped route through the block grid
    waypoints = np.linspace(0, 1, n_scans)
    for k, t in enumerate(waypoints):
        if t < 0.5:
            center = np.array([2900.0, 170.0, 1500 + t * 2 * 10000])
            yaw = 0.0
        else:
            center = np.array(
                [2900 + (t - 0.5) * 2 * 9000, 170.0, 11500.0]
            )
            yaw = -np.pi / 2
        T = np.asarray(
            math3d.euler_to_matrix4(center, np.array([0.0, yaw, 0.0]), xp=np)
        )
        true_mats.append(T)
        d2 = ((env - center) ** 2).sum(1)
        inr = d2 < range_max**2
        vis = env[inr]
        # solid-angle sampling (P ∝ 1/d², Gumbel top-k): see synth_ring
        w = 1.0 / np.maximum(d2[inr], 300.0**2)
        keys = np.log(w) + rng.gumbel(size=len(vis))
        take = min(n_pts, len(vis))
        vis = vis[np.argpartition(-keys, take - 1)[:take]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.5, local.shape)
        locals_.append(local.astype(np.float32))
        dacc += rng.normal(0, 15.0, 3)  # coarse GPS/odometry prior
        To = T.copy()
        To[:3, 3] += dacc
        odo_mats.append(To)
    return locals_, true_mats, odo_mats


def golden_loop60():
    locals_, true_mats, odo_mats = synth_loop()
    idents = [f"{k:03d}" for k in range(len(true_mats))]
    write_final_frames(os.path.join(GOLDEN, "loop60"), idents, true_mats)
    print("golden loop60 written (exact ground truth)")


if __name__ == "__main__":
    golden_dat()
    golden_loop60()
