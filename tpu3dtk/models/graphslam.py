"""GraphSLAM — globally consistent Lu/Milios-style 6-DoF relaxation
("LUM"), the JAX-native ``lum6DEuler`` (ref src/slam6d/lum6Deuler.cc:94-477,
base class graphSlam6D, src/slam6d/graphSlam6D.cc).

Math (identical to the reference):

Per graph link (i, j), with point pairs (a_k from scan i, b_k from scan
j, both in the current global frame):
    mid = (a+b)/2,  d = a-b
    MZ  = [Σd ; Σ(-z·dy + y·dz) ; Σ(-y·dx + x·dy) ; Σ(z·dx - x·dz)]
    MM  = the 6x6 Gram matrix of the linearized pose observation
    D   = MM⁻¹ MZ,  ss = Σ‖residual(D)‖² / (2m-3)
    C   = MM/ss,  CD = MZ/ss            (lum6Deuler.cc:141-232)

Assembly (FillGB3D, lum6Deuler.cc:265-303): for link (a, b) with scan 0
fixed,  B[a] += CD, B[b] -= CD, G[aa] += C, G[bb] += C, G[ab] -= C,
G[ba] -= C.  Solve G X = B, then per scan the pose correction is
Ha⁻¹ X_i subtracted from the Euler pose (lum6Deuler.cc:375-455).

Batched design: the reference loops links in OpenMP and scatters under
a critical section; here *all* links' (C, CD) are produced by one
batched kernel — NN search and MZ/MM reductions vmapped over links,
chunked with lax.map — and assembled with segment-sums.  The dense
6n x 6n SPD solve is tiny (n ≤ thousands) and runs in f64 (host/XLA);
the reference uses CXSparse cholesky (graphSlam6D.cc:345-366).
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

__all__ = [
    "build_proximity_graph",
    "link_covariances",
    "link_covariances_grid",
    "assemble_GB",
    "lum_pose_corrections",
    "LumParams",
    "do_graph_slam",
]


def read_net_graph(path: str) -> np.ndarray:
    """Explicit pose-graph file: first line = #scans, second = #links,
    then one 'from to' pair per line (ref Graph::Graph(netfile),
    src/slam6d/graph.cc:53-75; used by the bremen_city config's
    ``-n bremen.net``).  Returns links [L, 2] int32."""
    with open(path) as f:
        tokens = f.read().split()
    n_scans = int(tokens[0])
    n_links = int(tokens[1])
    vals = list(map(int, tokens[2 : 2 + 2 * n_links]))
    links = np.asarray(vals, np.int32).reshape(-1, 2)
    if links.max(initial=0) >= n_scans:
        raise ValueError(f"{path}: link index beyond {n_scans} scans")
    return links


def build_clpairs_graph(
    scans, max_dist2: float, min_pairs: int, pad_multiple: int = 512
) -> np.ndarray:
    """Links = all scan pairs sharing >= min_pairs NN point pairs at
    the current poses (ref graphSlam6D::computeGraph6Dautomatic,
    src/slam6d/graphSlam6D.cc:136-200, the ``-C/--clpairs`` graph).

    One batched kernel counts the pairs of every candidate link (the
    reference loops j x k scans in OpenMP); candidates are pre-filtered
    by bounding-sphere overlap so the O(S²) NN work only runs where
    geometry can overlap.  Returns links [L, 2] int32."""
    S = len(scans)
    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + pad_multiple - 1) // pad_multiple) * pad_multiple
    locals_pad, masks = _pad_scan_points(scans, cap)
    mats = np.stack([s.transMat for s in scans]).astype(np.float32)
    # bounding-sphere prefilter in the global frame
    centers = np.zeros((S, 3))
    radii = np.zeros(S)
    for si, s in enumerate(scans):
        g = np.asarray(math3d.transform3(s.transMat, s.reduced_local()))
        centers[si] = g.mean(axis=0)
        radii[si] = np.linalg.norm(g - centers[si], axis=1).max()
    jj, kk = np.triu_indices(S, k=1)
    dist = np.linalg.norm(centers[jj] - centers[kk], axis=1)
    near = dist <= radii[jj] + radii[kk] + float(np.sqrt(max_dist2))
    cand = np.stack([jj[near], kk[near]], axis=1).astype(np.int32)
    if len(cand) == 0:
        return np.zeros((0, 2), np.int32)
    C, CD, m = link_covariances_global(
        jnp.asarray(locals_pad), jnp.asarray(masks), jnp.asarray(mats),
        jnp.asarray(cand), jnp.float32(max_dist2),
    )
    m = np.asarray(m)
    return cand[m >= min_pairs]


def build_proximity_graph(
    positions: np.ndarray, cldist2: float, loopsize: int
) -> np.ndarray:
    """Links = consecutive chain + all (j,k), |k-j| > loopsize, with pose
    distance² < cldist2 (ref Graph::Graph(int,double,int),
    src/slam6d/graph.cc:108-130).  positions: [S,3].  Returns [L,2] int."""
    S = len(positions)
    chain = np.stack(
        [np.arange(S - 1), np.arange(1, S)], axis=1
    ) if S > 1 else np.zeros((0, 2), np.int64)
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    jj, kk = np.triu_indices(S, k=1)
    sel = ((kk - jj) > loopsize) & (d2[jj, kk] < cldist2)
    extra = np.stack([jj[sel], kk[sel]], axis=1)
    return np.concatenate([chain, extra]).astype(np.int32)


def _one_link_stats(
    model_g, mmask, tgt_g, tmask, max_dist2, grid=None
):
    """C (6,6), CD (6,) for one link from global-frame padded points.

    model_g = scan i (p1/a), tgt_g = scan j (p2/b): pairs are NN of j's
    points among i's points (Scan::getPtPairs convention, the link order
    used in FillGB3D).  ``grid``: optional (CellHash, bucket_cap) for
    the sublinear hashed cell-list search."""
    if grid is not None:
        ghash, bucket_cap = grid
        idx, d2, found = nn_ops.nn_cell_hash(
            tgt_g, tmask, ghash, max_dist2, bucket_cap
        )
    else:
        idx, d2, found = nn_ops.nn_brute_auto(
            tgt_g, tmask, model_g, mmask, max_dist2
        )
    return lum_pair_stats(model_g[idx], tgt_g, found)


def lum_pair_stats(a, b, found):
    """The LUM link covariance math from matched global-frame pairs:
    C (6,6), CD (6,), m — the MZ/MM sums, D solve and residual variance
    of covarianceEuler (lum6Deuler.cc:141-232).  a: matched model
    points [N,3]; b: target points [N,3]; found: accept mask [N]."""
    w = found.astype(jnp.float32)
    m = jnp.sum(w)

    mid = 0.5 * (a + b)
    d = a - b
    x, y, z = mid[:, 0], mid[:, 1], mid[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

    def s(v):
        # f64 accumulation rounded to f32: the same link gives the same
        # sums in every program that computes it (sharded or not)
        return jnp.sum((w * v).astype(jnp.float64)).astype(jnp.float32)

    MZ = jnp.stack(
        [
            s(dx),
            s(dy),
            s(dz),
            s(-z * dy + y * dz),
            s(-y * dx + x * dy),
            s(z * dx - x * dz),
        ]
    )
    sx, sy, sz = s(x), s(y), s(z)
    xpy = s(x * x + y * y)
    xpz = s(x * x + z * z)
    ypz = s(y * y + z * z)
    xy, xz, yz = s(x * y), s(x * z), s(y * z)
    MM = jnp.array(
        [
            [m, 0, 0, 0, -sy, sz],
            [0, m, 0, -sz, sx, 0],
            [0, 0, m, sy, 0, -sx],
            [0, -sz, sy, ypz, -xz, -xy],
            [-sy, sx, 0, -xz, xpy, -yz],
            [sz, 0, -sx, -xy, -yz, xpz],
        ]
    )
    ok = m > 2
    MMr = jnp.where(ok, MM, jnp.eye(6, dtype=MM.dtype))
    D = jnp.linalg.solve(MMr, MZ)
    # residual variance (lum6Deuler.cc:196-215)
    rx = dx - (D[0] - y * D[4] + z * D[5])
    ry = dy - (D[1] - z * D[3] + x * D[4])
    rz = dz - (D[2] + y * D[3] - x * D[5])
    ss = s(rx * rx + ry * ry + rz * rz) / jnp.maximum(2 * m - 3, 1.0)
    good = ok & (ss >= 1e-13)
    inv_ss = jnp.where(good, 1.0 / jnp.maximum(ss, 1e-13), 0.0)
    C = MM * inv_ss
    CD = MZ * inv_ss
    C = jnp.where(good, C, 0.0)
    CD = jnp.where(good, CD, 0.0)
    return C, CD, m


@functools.partial(jax.jit, static_argnames=("chunk",))
def link_covariances(
    points_g, masks, links, max_dist2, chunk: int = 4
):
    """Batched (C, CD) for all links.

    points_g: [S, N, 3] f32 global-frame reduced points per scan;
    masks: [S, N]; links: [L, 2] int32.  Returns C [L,6,6], CD [L,6],
    m [L].  Chunked with lax.map to bound the [chunk, N, N] distance
    working set.
    """
    def one(link):
        i, j = link[0], link[1]
        return _one_link_stats(
            points_g[i], masks[i], points_g[j], masks[j], max_dist2
        )

    return jax.lax.map(one, links, batch_size=chunk)


@functools.partial(jax.jit, static_argnames=("chunk",))
def link_covariances_global(
    locals_pts, masks, mats, links, max_dist2, chunk: int = 4,
    link_mask=None,
):
    """:func:`link_covariances` fed from RESIDENT local-frame tensors:
    the global transform runs on device from the pose stack, so callers
    that relax repeatedly over growing prefixes (GraphPipeline/ELCH)
    upload only [S,4,4] poses per call and reuse one executable.
    Padded link slots (e.g. (0,0)) produce garbage rows the caller
    discards."""
    points_g = (
        jnp.einsum("sij,snj->sni", mats[:, :3, :3], locals_pts)
        + mats[:, None, :3, 3]
    ).astype(jnp.float32)

    def one(link):
        i, j = link[0], link[1]
        return _one_link_stats(
            points_g[i], masks[i], points_g[j], masks[j], max_dist2
        )

    if link_mask is None:
        return jax.lax.map(one, links, batch_size=chunk)

    # fori_loop over VALID slots only (valid links come first in the
    # bucket): padded slots cost nothing; a cond under lax.map's
    # vmapped chunks would compute both branches
    L = links.shape[0]
    n_valid = jnp.sum(link_mask.astype(jnp.int32))

    def body(k, acc):
        C_a, CD_a, m_a = acc
        C, CD, m = one(links[k])
        return (
            C_a.at[k].set(C.astype(jnp.float32)),
            CD_a.at[k].set(CD.astype(jnp.float32)),
            m_a.at[k].set(m.astype(jnp.float32)),
        )

    return jax.lax.fori_loop(
        0, n_valid, body,
        (
            jnp.zeros((L, 6, 6), jnp.float32),
            jnp.zeros((L, 6), jnp.float32),
            jnp.zeros(L, jnp.float32),
        ),
    )


@functools.partial(
    jax.jit, static_argnames=("chunk", "n_buckets", "bucket_cap")
)
def link_covariances_grid(
    points_g,
    masks,
    links,
    max_dist2,
    n_buckets: int,
    bucket_cap: int,
    chunk: int = 4,
):
    """Batched (C, CD) for all links through per-scan hashed cell lists
    (the sublinear replacement for the per-link brute NN — the
    reference walks a kd-tree per link inside an OpenMP loop,
    lum6Deuler.cc:270-301; here every scan is hashed once per outer
    LUM iteration and all links query in O(Q·27·cap)).

    Returns (C [L,6,6], CD [L,6], m [L], overflow bool).  ``overflow``
    is True when some bucket exceeded bucket_cap — the caller must then
    redo this iteration with :func:`link_covariances` (exactness
    guard; see ops.nn.cell_hash_spec)."""
    cell = jnp.sqrt(max_dist2.astype(jnp.float32))
    inf3 = jnp.full((3,), jnp.float32(jnp.inf))

    def build_one(pts, msk):
        origin = jnp.min(jnp.where(msk[:, None], pts, inf3), axis=0)
        origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
        return nn_ops.build_cell_hash(pts, msk, origin, cell, n_buckets)

    grids = jax.vmap(build_one)(points_g, masks)
    occ = grids.bucket_start[:, 1:] - grids.bucket_start[:, :-1]
    overflow = jnp.max(occ) > bucket_cap

    def one(link):
        i, j = link[0], link[1]
        g = nn_ops.CellHash(
            points=grids.points[i],
            src_idx=grids.src_idx[i],
            bucket_start=grids.bucket_start[i],
            origin=grids.origin[i],
            cell=grids.cell[i],
        )
        return _one_link_stats(
            points_g[i], masks[i], points_g[j], masks[j], max_dist2,
            grid=(g, bucket_cap),
        )

    C, CD, m = jax.lax.map(one, links, batch_size=chunk)
    return C, CD, m, overflow


def assemble_GB(links: np.ndarray, C: np.ndarray, CD: np.ndarray, n_scans: int):
    """Dense G (6n x 6n), B (6n) with scan 0 fixed (FillGB3D,
    lum6Deuler.cc:265-303).  f64 host assembly (tiny)."""
    n = n_scans - 1
    C = np.asarray(C, np.float64)
    CD = np.asarray(CD, np.float64)
    lk = np.asarray(links, np.int64)
    a = lk[:, 0] - 1
    b = lk[:, 1] - 1
    # block form [n,n,6,6] scattered with np.add.at, then reshaped
    Gb = np.zeros((n, n, 6, 6))
    Bb = np.zeros((n, 6))
    sa, sb = a >= 0, b >= 0
    np.add.at(Bb, a[sa], CD[sa])
    np.add.at(Bb, b[sb], -CD[sb])
    np.add.at(Gb, (a[sa], a[sa]), C[sa])
    np.add.at(Gb, (b[sb], b[sb]), C[sb])
    both = sa & sb
    np.add.at(Gb, (a[both], b[both]), -C[both])
    np.add.at(Gb, (b[both], a[both]), -C[both])
    G = Gb.transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    return G, Bb.reshape(6 * n)


def lum_pose_corrections(poses_pos, poses_theta, X):
    """Ha⁻¹ X per scan (lum6Deuler.cc:375-436).  poses_*: [n,3] for
    scans 1..n (scan 0 fixed); X: [n,6].  Returns result [n,6] to be
    subtracted from (pos, theta).

    Host numpy f64, batched: the systems are 6x6 per scan — far below
    device-dispatch break-even — and the pose update itself wants full
    f64 (SURVEY §7 hard-part 2: f64 pose-math islands stay on host)."""
    pos = np.asarray(poses_pos, np.float64)
    theta = np.asarray(poses_theta, np.float64)
    X = np.asarray(X, np.float64)
    n = len(X)
    xa, ya, za = pos[:, 0], pos[:, 1], pos[:, 2]
    tx, ty = theta[:, 0], theta[:, 1]
    ctx, stx = np.cos(tx), np.sin(tx)
    cty, sty = np.cos(ty), np.sin(ty)
    Ha = np.tile(np.eye(6), (n, 1, 1))
    Ha[:, 0, 4] = -za * ctx + ya * stx
    Ha[:, 0, 5] = ya * cty * ctx + za * stx * cty
    Ha[:, 1, 3] = za
    Ha[:, 1, 4] = -xa * stx
    Ha[:, 1, 5] = -xa * ctx * cty + za * sty
    Ha[:, 2, 3] = -ya
    Ha[:, 2, 4] = xa * ctx
    Ha[:, 2, 5] = -xa * cty * stx - ya * sty
    Ha[:, 3, 5] = sty
    Ha[:, 4, 4] = stx
    Ha[:, 4, 5] = ctx * cty
    Ha[:, 5, 4] = ctx
    Ha[:, 5, 5] = -stx * cty
    return np.linalg.solve(Ha, X[..., None])[..., 0]


@dataclasses.dataclass
class LumParams:
    max_dist_match2: float = 625.0  # -D distSLAM squared
    iterations: int = 50  # -I iterSLAM
    epsilon: float = 0.5  # --epsSLAM (mean position shift, cm)
    pad_multiple: int = 512
    link_chunk: int = 4
    # NN engine: "auto" = hashed cell list for large scans, brute
    # otherwise (mirrors SequenceRegistration.nns)
    nns: str = "auto"
    # auto threshold on per-scan points; None = the measured crossover
    # ops.nn.GRID_MIN_POINTS (mirrors SequenceRegistration.grid_min_model)
    grid_min_points: int | None = None
    grid_max_cap: int = nn_ops.GRID_MAX_CAP
    # host-path solver split: dense f64 Cholesky below this many scans,
    # block-Jacobi CG (pgsolve.solve_block_cg, O(L) memory) above
    dense_solver_max_scans: int = 65
    # on-device path (models.lum_device): whole relaxation in ONE jitted
    # while_loop with a dense f32 Jacobi-scaled solve; used up to this
    # many scans (6*511 = 3066-dim system — trivial for the device), above
    # which the host loop + block-CG takes over
    device_max_scans: int = 512
    # multi-device, opt-in: "auto" shards the link loop over all local
    # devices (parallel.lum_shard) when more than one is present; None
    # (default) runs on one device
    mesh: object = None
    # --- shape bucketing (SURVEY §7 hard-part 3) -----------------------
    # Callers that invoke LUM repeatedly over growing prefixes
    # (GraphPipeline) pin these so every call reuses ONE compiled
    # executable: scan_cap pads S, point_cap pads N, link_cap_min seeds
    # the power-of-two link bucket, grid pins the (n_buckets,
    # bucket_cap) hash spec, device_points carries the pre-uploaded
    # [S, N, 3] / [S, N] device tensors.
    scan_cap: int | None = None
    point_cap: int | None = None
    link_cap_min: int = 8
    grid: tuple | None = None
    device_points: tuple | None = None
    # persistent NN-correspondence cache (lum_device.CorrCache) for the
    # per-closure 1-iteration relax of continuous-closure runs: link
    # pairings are reused while the endpoints' relative pose stays
    # within tolerance; covariance stats stay exact at current poses
    corr_cache: object | None = None


def _solve_GX_B(
    scans_n: int, links: np.ndarray, C: np.ndarray, CD: np.ndarray,
    dense_max: int,
) -> np.ndarray:
    """Solve the LUM system; dense f64 for small n, block-CG above."""
    n = scans_n - 1
    if scans_n <= dense_max:
        G, B = assemble_GB(links, C, CD, scans_n)
        try:
            return np.linalg.solve(G, B).reshape(-1, 6)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(G, B, rcond=None)[0].reshape(-1, 6)
    from . import pgsolve

    lk = np.asarray(links, np.int64)
    B = np.zeros((n, 6))
    a, b = lk[:, 0] - 1, lk[:, 1] - 1
    CD64 = np.asarray(CD, np.float64)
    np.add.at(B, a[a >= 0], CD64[a >= 0])
    np.add.at(B, b[b >= 0], -CD64[b >= 0])
    return pgsolve.solve_block_cg(links, C, B, n)


def local_grid_spec(
    scans: list[TPUScan], max_dist: float, grid_max_cap: int,
    headroom: float = 1.5,
) -> tuple[int, int]:
    """One (n_buckets, bucket_cap) hash spec serving a whole sequence:
    sized from each scan's LOCAL reduced points — cell occupancy is
    density-driven and rigid transforms preserve density, so the spec
    holds at any pose (the device overflow flag guards exactness).
    Returns (0, 0) if the densest bucket exceeds grid_max_cap."""
    H = 0
    cap = 0
    for s in scans:
        r = np.asarray(s.reduced_local(), np.float32)
        Hs, bc = nn_ops.cell_hash_spec(r, np.ones(len(r), bool), max_dist)
        H = max(H, Hs)
        cap = max(cap, bc)
    cap = ((int(cap * headroom) + 7) // 8) * 8
    return (H, cap) if cap <= grid_max_cap else (0, 0)


def _pad_scan_points(scans, cap):
    locals_pad = np.zeros((len(scans), cap, 3), np.float32)
    masks = np.zeros((len(scans), cap), bool)
    for si, s in enumerate(scans):
        r = s.reduced_local()
        locals_pad[si, : len(r)] = r
        masks[si, : len(r)] = True
    return locals_pad, masks


def _grid_min(params: LumParams) -> int:
    if params.grid_min_points is None:
        return nn_ops.GRID_MIN_POINTS
    return params.grid_min_points


def _link_bucket(n: int, lo: int) -> int:
    cap = lo
    while cap < n:
        cap *= 2
    return cap


def do_graph_slam(
    scans: list[TPUScan], links: np.ndarray, params: LumParams
) -> float:
    """Run LUM iterations until mean pose shift < epsilon
    (doGraphSlam6D, lum6Deuler.cc:314-477).  Mutates scan poses; writes
    LUM-tagged frames (one per iteration, scan.cc:918-1009).  Returns
    final mean position shift.

    Dispatch: up to ``device_max_scans`` the whole relaxation runs on
    device in one jitted while_loop (models.lum_device.lum_run — the
    reference's zero-dispatch in-process loop re-expressed for XLA);
    larger graphs take the host loop with the block-CG solver."""
    if len(scans) < 2 or len(links) == 0:
        return 0.0
    if len(scans) > params.device_max_scans:
        return _do_graph_slam_host(scans, links, params)

    from .lum_device import lum_run

    S = params.scan_cap or len(scans)
    n_real = len(scans)
    if params.device_points is not None:
        locals_j, masks_j = params.device_points
        cap = locals_j.shape[1]
    else:
        cap = params.point_cap or max(len(s.reduced_local()) for s in scans)
        cap = (
            (cap + params.pad_multiple - 1) // params.pad_multiple
        ) * params.pad_multiple
        locals_pad, masks = _pad_scan_points(scans, cap)
        if S > n_real:
            pad = np.zeros((S - n_real, cap, 3), np.float32)
            locals_pad = np.concatenate([locals_pad, pad])
            masks = np.concatenate([masks, np.zeros((S - n_real, cap), bool)])
        locals_j = jnp.asarray(locals_pad)
        masks_j = jnp.asarray(masks)

    L = _link_bucket(len(links), params.link_cap_min)
    links_pad = np.zeros((L, 2), np.int32)
    links_pad[: len(links)] = np.asarray(links, np.int32)
    link_mask = np.zeros(L, bool)
    link_mask[: len(links)] = True

    if params.grid is not None:
        grid_buckets, grid_cap = params.grid
    else:
        use_grid = params.nns == "grid" or (
            params.nns == "auto"
        and cap >= _grid_min(params)
        )
        grid_buckets, grid_cap = (
            local_grid_spec(
                scans, float(np.sqrt(params.max_dist_match2)),
                params.grid_max_cap,
            )
            if use_grid
            else (0, 0)
        )

    pos0 = np.zeros((S, 3), np.float32)
    theta0 = np.zeros((S, 3), np.float32)
    for si, s in enumerate(scans):
        theta, p = math3d.matrix4_to_euler(s.transMat)
        pos0[si] = p
        theta0[si] = theta

    mesh = None
    if params.mesh == "auto":
        from ..parallel.mesh import default_points_mesh

        mesh = default_points_mesh()
    elif params.mesh:
        mesh = params.mesh

    from ..utils.metrics import metrics
    from .lum_device import build_local_grids

    with metrics.time("lum_cov_time"):
        # resident per-scan LOCAL hashes: built once, in a separate jit
        # (see models.icp._build_grid_inline); occupancy is exact at
        # build time, so grid-vs-brute is decided upfront.
        local_grids = None
        if grid_buckets:
            cell = jnp.float32(np.sqrt(params.max_dist_match2))
            grids, occ = build_local_grids(
                locals_j, masks_j, cell, n_buckets=int(grid_buckets)
            )
            if int(occ) <= grid_cap:
                local_grids = grids

        cache = params.corr_cache
        if (
            cache is not None
            and int(params.iterations) == 1
            and local_grids is None
            and cache.N == int(locals_j.shape[1])
        ):
            # cached path for the PER-CLOSURE 1-iteration relax only, on
            # one device whatever the mesh, so sharded and single-device
            # pipelines run the same relaxation.
            # Measured (h468): extending it to the multi-iteration final
            # relax degraded ATE 18.3 -> 28.4 cm — within-relax pairing
            # reuse interferes with LUM convergence, while across-closure
            # reuse does not (the closure relax is a single damped step).
            from .lum_device import lum_step_cached

            pos_c = pos0.astype(np.float64)
            theta_c = theta0.astype(np.float64)
            links64 = np.asarray(links, np.int64)
            it = 0
            ret = np.inf
            while it < int(params.iterations) and ret > params.epsilon:
                mats_np = np.asarray(
                    math3d.euler_to_matrix4(pos_c, theta_c, xp=np)
                )
                lp2, lm2, stale_idx, n_stale = cache.prepare(
                    links64, mats_np
                )
                pos_d, theta_d, ret_d, cache.idx, cache.found = (
                    lum_step_cached(
                        locals_j, masks_j,
                        jnp.asarray(lp2), jnp.asarray(lm2),
                        jnp.asarray(pos_c, dtype=jnp.float32),
                        jnp.asarray(theta_c, dtype=jnp.float32),
                        jnp.int32(n_real),
                        jnp.float32(params.max_dist_match2),
                        cache.idx, cache.found,
                        jnp.asarray(stale_idx), jnp.int32(n_stale),
                    )
                )
                pos_c, theta_c, ret = jax.device_get(
                    (pos_d, theta_d, ret_d)
                )
                pos_c = pos_c.astype(np.float64)
                theta_c = theta_c.astype(np.float64)
                ret = float(ret)
                for si, s in enumerate(scans):
                    if si == 0:
                        s.add_frame(AlgoType.LUM)
                        continue
                    T = np.asarray(
                        math3d.euler_to_matrix4(
                            pos_c[si], theta_c[si]
                        )
                    )
                    s.set_pose(T, AlgoType.LUM, record=True)
                it += 1
            return ret

        kwargs = dict(
            iterations=int(params.iterations),
            chunk=int(params.link_chunk),
            bucket_cap=int(grid_cap) if local_grids is not None else 0,
        )
        args = (
            locals_j, masks_j,
            jnp.asarray(links_pad), jnp.asarray(link_mask),
            jnp.asarray(pos0), jnp.asarray(theta0),
            jnp.int32(n_real),
            jnp.float32(params.max_dist_match2),
            jnp.float32(params.epsilon),
            local_grids,
        )
        if mesh is not None and mesh.devices.size > 1:
            from ..parallel.lum_shard import lum_run_sharded

            pos, theta, hist, it, ret = lum_run_sharded(
                mesh, *args, **kwargs
            )
        else:
            pos, theta, hist, it, ret = lum_run(*args, **kwargs)
        # one fetch for the three results
        hist, it, ret = jax.device_get((hist, it, ret))
        hist = np.asarray(hist)
        n_it = int(it)
        ret = float(ret)

    # replay frames: one LUM-tagged frame per executed iteration
    # (lum6Deuler.cc appends via Scan::transform per iteration)
    for k in range(n_it):
        for si, s in enumerate(scans):
            if si == 0:
                s.add_frame(AlgoType.LUM)
                continue
            T = np.asarray(
                math3d.euler_to_matrix4(
                    hist[k, si, :3].astype(np.float64),
                    hist[k, si, 3:].astype(np.float64),
                )
            )
            s.set_pose(T, AlgoType.LUM, record=True)
    return ret


def _do_graph_slam_host(
    scans: list[TPUScan], links: np.ndarray, params: LumParams
) -> float:
    """Host-orchestrated LUM (per-iteration device kernels + f64 host
    solve) — the fallback for graphs beyond the on-device dense-solve
    range, where the block-CG solver (pgsolve) takes over."""
    cap = max(len(s.reduced_local()) for s in scans)
    cap = ((cap + params.pad_multiple - 1) // params.pad_multiple) * params.pad_multiple
    locals_pad, masks = _pad_scan_points(scans, cap)
    locals_j = jnp.asarray(locals_pad)
    masks_j = jnp.asarray(masks)
    links_j = jnp.asarray(links, jnp.int32)

    use_grid = params.nns == "grid" or (
        params.nns == "auto"
        and cap >= _grid_min(params)
    )
    if use_grid:
        grid_buckets, grid_cap = local_grid_spec(
            scans, float(np.sqrt(params.max_dist_match2)), params.grid_max_cap
        )
    else:
        grid_buckets = grid_cap = 0

    mesh = None
    if params.mesh == "auto":
        from ..parallel.mesh import default_points_mesh

        mesh = default_points_mesh()
    elif params.mesh:
        mesh = params.mesh

    from ..utils.metrics import metrics

    ret = np.inf
    it = 0
    while it < params.iterations and ret > params.epsilon:
        mats = np.stack([s.transMat for s in scans]).astype(np.float32)
        points_g = jax.vmap(math3d.transform3)(jnp.asarray(mats), locals_j)
        with metrics.time("lum_cov_time"):
            if mesh is not None:
                # links data-parallel over the device mesh (SURVEY §2.8.2)
                from ..parallel import lum_shard

                C, CD, m, overflow = lum_shard.link_covariances_sharded(
                    mesh, points_g, masks_j, links,
                    params.max_dist_match2, chunk=params.link_chunk,
                    n_buckets=grid_buckets, bucket_cap=grid_cap,
                )
                if overflow:  # exactness guard: redo with brute
                    C, CD, m, _ = lum_shard.link_covariances_sharded(
                        mesh, points_g, masks_j, links,
                        params.max_dist_match2, chunk=params.link_chunk,
                    )
            elif grid_buckets:
                C, CD, m, overflow = link_covariances_grid(
                    points_g, masks_j, links_j,
                    jnp.float32(params.max_dist_match2),
                    n_buckets=grid_buckets, bucket_cap=grid_cap,
                    chunk=params.link_chunk,
                )
                if bool(overflow):  # exactness guard: redo with brute
                    C, CD, m = link_covariances(
                        points_g, masks_j, links_j,
                        jnp.float32(params.max_dist_match2),
                        chunk=params.link_chunk,
                    )
            else:
                C, CD, m = link_covariances(
                    points_g, masks_j, links_j,
                    jnp.float32(params.max_dist_match2),
                    chunk=params.link_chunk,
                )
            C, CD, m = np.asarray(C), np.asarray(CD), np.asarray(m)
        with metrics.time("lum_solve_time"):
            X = _solve_GX_B(
                len(scans), links, np.asarray(C), np.asarray(CD),
                params.dense_solver_max_scans,
            )
        pos = np.stack([s.rPos for s in scans[1:]])
        theta = np.stack([s.rPosTheta for s in scans[1:]])
        result = np.asarray(
            lum_pose_corrections(
                jnp.asarray(pos), jnp.asarray(theta), jnp.asarray(X)
            )
        )
        sum_position_diff = 0.0
        for k, s in enumerate(scans[1:]):
            new_pos = pos[k] - result[k, :3]
            new_theta = theta[k] - result[k, 3:]
            T = np.asarray(math3d.euler_to_matrix4(new_pos, new_theta))
            s.set_pose(T, AlgoType.LUM)
            sum_position_diff += float(np.linalg.norm(result[k, :3]))
        scans[0].add_frame(AlgoType.LUM)
        ret = sum_position_diff / len(scans)
        it += 1
    return ret
