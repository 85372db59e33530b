"""Plane-based post-registration — the JAX-native ``preg6d`` module
(ref src/preg6d/planereg.cc:2 driver; model/planescan.cc point-to-plane
correspondences; opt/{gaussnewton,newtons6d,adadelta6d,svd}.cc pose
optimizers; match/planematcher.cc local↔global plane matching).

The reference refines globally-registered scans against a fixed set of
extracted planes: each point is associated to the plane it lies on
(hesse-distance + normal-similarity gates, planescan.cc), then a 6-DoF
optimizer minimizes the summed point-to-plane energy per scan.

Batched design:

- association is ONE [N, P] matmul (every point's signed distance to
  every plane) + masked argmin — a matmul replaces planescan.cc's
  per-point loop over planes;
- the Gauss-Newton optimizer runs association + the closed-form 6x6
  normal-equation solve inside one ``lax.while_loop`` (zero host round
  trips, the reference's opt/gaussnewton.cc Newton iteration);
- the AdaDelta optimizer (opt/adadelta6d.cc) is re-expressed with
  ``jax.grad`` over the Euler pose — the functional-transform version
  of its hand-derived gradients — inside ``lax.fori_loop``;
- plane matching (match/planematcher.cc energies delta_alpha /
  delta_hesse / delta_ppd) is a batched [L, G] score matrix.
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
from .shapes import HoughParams, Plane, detect_planes

__all__ = [
    "PregParams",
    "associate_points",
    "plane_register",
    "preg6d",
    "match_planes",
]


@dataclasses.dataclass
class PregParams:
    eps_hesse: float = 25.0     # max |n·p − d| for association (cm)
    eps_sim_deg: float = 30.0   # max angle(point normal, plane normal)
    iterations: int = 50        # optimizer iterations
    epsilon: float = 1e-6       # convergence: pose-delta norm
    optimizer: str = "gaussnewton"  # "gaussnewton" | "adadelta"
    use_normals: bool = False   # gate associations by point normals
    adadelta_rho: float = 0.95  # ref adadelta6d.cc decay
    adadelta_eps: float = 1e-6


def _plane_arrays(planes: list[Plane]):
    n = np.stack([p.normal for p in planes]).astype(np.float32)
    d = np.asarray([p.rho for p in planes], np.float32)
    return n, d


def associate_points(pts_g, mask, plane_n, plane_d, eps_hesse,
                     normals_g=None, cos_sim=None):
    """For each global-frame point, the plane minimizing |n·p − d|
    (traceable).  Returns (plane_idx [N], dist [N], valid [N]).

    One [N, P] matmul against all plane normals (planescan.cc
    correspondence search re-mapped onto matmuls)."""
    dist = (
        jnp.dot(pts_g, plane_n.T, preferred_element_type=jnp.float32)
        - plane_d[None, :]
    )
    score = jnp.abs(dist)
    if normals_g is not None and cos_sim is not None:
        ndot = jnp.abs(
            jnp.dot(normals_g, plane_n.T, preferred_element_type=jnp.float32)
        )
        score = jnp.where(ndot >= cos_sim, score, jnp.float32(3.4e38))
    idx = jnp.argmin(score, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(score, idx[:, None], axis=1)[:, 0]
    signed = jnp.take_along_axis(dist, idx[:, None], axis=1)[:, 0]
    valid = mask & (best < eps_hesse)
    return idx, signed, valid


def _apply_pose(pose6, pts):
    """Euler pose [6] (pos, theta) -> transformed points (traceable)."""
    T = math3d.euler_to_matrix4(pose6[:3], pose6[3:], xp=jnp)
    return math3d.transform3(T, pts, xp=jnp).astype(jnp.float32), T


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "optimizer", "use_normals"),
)
def plane_register(
    pts_local, mask, plane_n, plane_d, T0,
    eps_hesse, epsilon,
    normals_local=None, cos_sim=0.0,
    *,
    iterations: int = 50,
    optimizer: str = "gaussnewton",
    use_normals: bool = False,
    adadelta_rho: float = 0.95,
    adadelta_eps: float = 1e-6,
):
    """Register ONE scan against fixed planes.  Returns (T [4,4],
    energy, n_iters, n_assoc).

    gaussnewton: per iteration associate → solve the 6x6 point-to-plane
    normal equations J = [n, p×n] (opt/gaussnewton.cc); pose update by
    small-angle left-composition.
    adadelta: jax.grad of the summed squared hesse energy over the
    Euler pose with AdaDelta accumulators (opt/adadelta6d.cc).
    """
    pts_local = pts_local.astype(jnp.float32)
    T0 = T0.astype(jnp.float32)
    theta0, pos0 = math3d.matrix4_to_euler(T0, xp=jnp)
    pose0 = jnp.concatenate([pos0, theta0]).astype(jnp.float32)
    eps_h = jnp.float32(eps_hesse)
    eps = jnp.float32(epsilon)
    cs = jnp.float32(np.cos(np.deg2rad(cos_sim))) if use_normals else None

    def energy_fn(pose6):
        pts_g, T = _apply_pose(pose6, pts_local)
        if use_normals:
            nl = math3d.transform3normal(
                T, normals_local, xp=jnp
            ).astype(jnp.float32)
        else:
            nl = None
        idx, signed, valid = associate_points(
            pts_g, mask, plane_n, plane_d, eps_h, nl, cs
        )
        w = valid.astype(jnp.float32)
        # MEAN energy: keeps AdaDelta's unit-free steps stable when the
        # association count changes between iterations (a summed energy
        # can rise as points re-associate and the optimizer oscillates)
        e = jnp.sum(w * signed * signed) / jnp.maximum(jnp.sum(w), 1.0)
        return e, (idx, signed, valid, pts_g)

    if optimizer == "adadelta":
        rho = jnp.float32(adadelta_rho)
        ae = jnp.float32(adadelta_eps)
        # unit balancing: rotations act through the scene lever arm, so
        # parametrize theta in units of (rad * scene_radius) — gradients
        # and AdaDelta's unit-free steps then share the cm scale for all
        # six parameters (the reference's adadelta6d scales similarly)
        lever = jnp.maximum(
            jnp.sqrt(
                jnp.sum(
                    jnp.where(mask[:, None], pts_local, 0.0) ** 2
                ) / jnp.maximum(jnp.sum(mask), 1)
            ),
            jnp.float32(1.0),
        )
        scale = jnp.concatenate(
            [jnp.ones(3, jnp.float32), jnp.full((3,), lever, jnp.float32)]
        )

        def energy_scaled(q):
            return energy_fn(q / scale)

        def body(i, carry):
            q, Eg2, Ed2, _ = carry
            (e, _aux), g = jax.value_and_grad(
                energy_scaled, has_aux=True
            )(q)
            Eg2 = rho * Eg2 + (1 - rho) * g * g
            dx = -jnp.sqrt(Ed2 + ae) / jnp.sqrt(Eg2 + ae) * g
            Ed2 = rho * Ed2 + (1 - rho) * dx * dx
            return q + dx, Eg2, Ed2, e

        z6 = jnp.zeros(6, jnp.float32)
        q, _, _, e = jax.lax.fori_loop(
            0, iterations, body, (pose0 * scale, z6, z6, jnp.float32(0.0))
        )
        pose = q / scale
        _, (idx, signed, valid, _) = energy_fn(pose)
        T = math3d.euler_to_matrix4(pose[:3], pose[3:], xp=jnp)
        return (
            T.astype(jnp.float32), e, jnp.int32(iterations),
            jnp.sum(valid.astype(jnp.int32)),
        )

    # Gauss-Newton on the global-frame linearization: residual
    # r = n·p − d, J_row = [n, p × n]; T <- exp(dx) ∘ T
    def cond(carry):
        T, it, done, e = carry
        return (~done) & (it < iterations)

    def body(carry):
        T, it, _, _ = carry
        pts_g = math3d.transform3(T, pts_local, xp=jnp).astype(jnp.float32)
        if use_normals:
            nl = math3d.transform3normal(
                T, normals_local, xp=jnp
            ).astype(jnp.float32)
        else:
            nl = None
        idx, signed, valid = associate_points(
            pts_g, mask, plane_n, plane_d, eps_h, nl, cs
        )
        w = valid.astype(jnp.float32)
        n_sel = plane_n[idx]  # [N, 3]
        cr = jnp.cross(pts_g, n_sel)  # [N, 3]
        J = jnp.concatenate([n_sel, cr], axis=1)  # [N, 6]
        wJ = w[:, None] * J
        A = jnp.dot(wJ.T, J, preferred_element_type=jnp.float32)
        b = jnp.sum(wJ * signed[:, None], axis=0)
        ok = jnp.sum(w) > 6
        A = jnp.where(ok, A, jnp.eye(6, dtype=jnp.float32))
        A = A + 1e-6 * jnp.eye(6, dtype=jnp.float32)
        dx = -jnp.linalg.solve(A, b)
        dx = jnp.where(ok, dx, jnp.zeros(6, jnp.float32))
        # small-angle update: translation dx[:3], rotation dx[3:]
        wx, wy, wz = dx[3], dx[4], dx[5]
        R = jnp.array(
            [
                [1.0, -wz, wy, dx[0]],
                [wz, 1.0, -wx, dx[1]],
                [-wy, wx, 1.0, dx[2]],
                [0.0, 0.0, 0.0, 1.0],
            ],
            jnp.float32,
        )
        # re-orthonormalize the small rotation (2 Newton steps)
        Rr = R[:3, :3]
        eye = jnp.eye(3, dtype=jnp.float32)
        for _ in range(2):
            Rr = Rr @ (1.5 * eye - 0.5 * (Rr.T @ Rr))
        R = R.at[:3, :3].set(Rr)
        T_new = R @ T
        e = jnp.sum(w * signed * signed)
        done = jnp.linalg.norm(dx) < eps
        return T_new, it + 1, done, e

    T, it, done, e = jax.lax.while_loop(
        cond, body, (T0, jnp.int32(0), jnp.bool_(False), jnp.float32(0.0))
    )
    pts_g = math3d.transform3(T, pts_local, xp=jnp).astype(jnp.float32)
    _, _, valid = associate_points(pts_g, mask, plane_n, plane_d, eps_h)
    return T, e, it, jnp.sum(valid.astype(jnp.int32))


def preg6d(
    scans: list[TPUScan],
    planes: list[Plane] | None = None,
    params: PregParams | None = None,
    hough: HoughParams | None = None,
) -> list[dict]:
    """Plane-based post-registration of a globally registered sequence
    (the planereg.cc driver): extract planes from the condensed global
    cloud unless given, then refine every scan's pose against the fixed
    plane model.  Mutates scan poses (ICP frames).  Returns info dicts.
    """
    params = params or PregParams()
    if planes is None:
        allpts = np.concatenate(
            [
                np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
                for s in scans
            ]
        )
        planes = detect_planes(allpts, hough)
    if not planes:
        raise ValueError("no planes to register against")
    pn, pd = _plane_arrays(planes)
    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + 511) // 512) * 512
    infos = []
    for s in scans:
        r = np.asarray(s.reduced_local(), np.float32)
        pts = np.zeros((cap, 3), np.float32)
        pts[: len(r)] = r
        mask = np.zeros(cap, bool)
        mask[: len(r)] = True
        if params.use_normals:
            normals = s.reduced_normals_padded(cap).astype(np.float32)
        else:
            normals = None
        T, e, it, n_assoc = plane_register(
            jnp.asarray(pts), jnp.asarray(mask),
            jnp.asarray(pn), jnp.asarray(pd),
            jnp.asarray(s.transMat.astype(np.float32)),
            params.eps_hesse, params.epsilon,
            normals_local=(
                jnp.asarray(normals) if normals is not None else None
            ),
            cos_sim=params.eps_sim_deg,
            iterations=params.iterations,
            optimizer=params.optimizer,
            use_normals=params.use_normals,
            adadelta_rho=params.adadelta_rho,
            adadelta_eps=params.adadelta_eps,
        )
        T = np.asarray(T, np.float64)
        u, _, vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = u @ vt
        s.set_pose(T, AlgoType.ICP)
        infos.append({
            "identifier": s.identifier,
            "energy": float(e),
            "iterations": int(it),
            "associated": int(n_assoc),
        })
    return infos


def match_planes(
    local: list[Plane], global_: list[Plane],
    eps_hesse: float = 50.0, eps_ppd: float = 100.0,
    eps_sim_deg: float = 20.0,
) -> list[tuple[int, int, float]]:
    """Match locally detected planes to the global plane model by the
    reference's three energies (planematcher.cc EnergyPlanePair):
    delta_alpha (normal angle), delta_hesse (|rho| difference),
    delta_ppd (plane-to-plane centroid distance).  Greedy best-first on
    total energy with the same sanity gates.  Returns
    [(local_idx, global_idx, energy)]."""
    if not local or not global_:
        return []
    ln = np.stack([p.normal for p in local])
    gn = np.stack([p.normal for p in global_])
    lr = np.asarray([p.rho for p in local])
    gr = np.asarray([p.rho for p in global_])
    lc = np.stack([p.center for p in local])
    gc = np.stack([p.center for p in global_])
    cosang = np.clip(np.abs(ln @ gn.T), -1.0, 1.0)
    d_alpha = np.degrees(np.arccos(cosang))  # [L, G]
    d_hesse = np.abs(lr[:, None] - gr[None, :])
    # point-to-plane distance of the local centroid to the global plane
    d_ppd = np.abs(lc @ gn.T - gr[None, :])
    ok = (
        (d_alpha < eps_sim_deg)
        & (d_hesse < eps_hesse)
        & (d_ppd < eps_ppd)
    )
    energy = d_alpha + d_hesse + d_ppd
    pairs = []
    used_l: set[int] = set()
    used_g: set[int] = set()
    order = np.argsort(energy, axis=None)
    for flat in order:
        li, gi = np.unravel_index(flat, energy.shape)
        if not ok[li, gi] or li in used_l or gi in used_g:
            continue
        pairs.append((int(li), int(gi), float(energy[li, gi])))
        used_l.add(int(li))
        used_g.add(int(gi))
    return pairs
