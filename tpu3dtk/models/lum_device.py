"""On-device LUM iteration loop — the performance core of GraphSLAM.

The reference's ``doGraphSlam6D`` (src/slam6d/lum6Deuler.cc:314-477)
iterates: per-link covariance assembly (FillGB3D, lum6Deuler.cc:265-303)
→ sparse Cholesky solve (graphSlam6D.cc:345-366) → per-scan pose update
via Ha⁻¹X (lum6Deuler.cc:375-455) — all in-process with zero dispatch
overhead.  A host-driven loop of the same math pays a dispatch, an
upload and a download per iteration (eager vmapped transforms, host
solve), which at LUM's small per-iteration work dominates.

This module keeps the ENTIRE relaxation on device inside one jitted
``lax.while_loop``:

  1. pose matrices from Euler state (batched euler_to_matrix4),
  2. per-link NN through each scan's **local-frame** hashed cell list:
     the hash of scan i's local points NEVER changes, so it is built
     once per relaxation (outside this jit) and enters as a program
     parameter; each iteration transforms scan j's points by
     T_i⁻¹·T_j and queries — distances are rigid-invariant, so the
     semantics equal the reference's global-frame getPtPairs.
  3. batched link covariances (chunked lax.map, graphslam.lum_pair_stats),
  4. G/B assembly by scatter-add into [n+1, n+1, 6, 6] blocks
     (index n is the dump row for the fixed scan 0 / padded links),
  5. Jacobi-scaled dense solve of the 6n-dim SPD system in f32,
  6. vmapped Ha⁻¹X pose corrections and the convergence scalar,

with a per-iteration pose history buffer so `.frames` semantics (one
LUM-tagged frame per iteration, scan.cc:918-1009) are replayed on the
host afterwards from ONE device→host transfer.

Shape discipline (SURVEY §7 hard-part 3): S (scan slots), N (points per
scan) and L (link slots) are padded by the caller; ``n_scans`` and
``link_mask`` are *dynamic*, so GraphPipeline's growing prefixes and
link sets reuse one compiled executable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math3d
from ..ops import nn as nn_ops
from .graphslam import lum_pair_stats

__all__ = ["lum_run", "build_local_grids", "lum_step_cached",
           "link_cov_cached", "CorrCache"]


@functools.partial(jax.jit, static_argnames=("n_buckets",))
def build_local_grids(locals_pts, masks, cell, n_buckets: int):
    """Per-scan hashed cell lists over LOCAL points (vmapped build).
    Rigid motions preserve density, so these serve every iteration of a
    relaxation at any pose.  Returns (CellHash with leading S dim,
    max occupancy over all scans — host checks it against bucket_cap
    BEFORE running and falls back to brute)."""
    inf3 = jnp.full((3,), jnp.float32(jnp.inf))

    def build_one(pts, msk):
        origin = jnp.min(jnp.where(msk[:, None], pts, inf3), axis=0)
        origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
        return nn_ops.build_cell_hash(pts, msk, origin, cell, n_buckets)

    grids = jax.vmap(build_one)(locals_pts, masks)
    occ = grids.bucket_start[:, 1:] - grids.bucket_start[:, :-1]
    return grids, jnp.max(occ)


def _rigid_inv(T):
    """Inverse of a rigid 4x4 (R^T, -R^T t) — cheaper and better
    conditioned than a general inverse (ref M4inv, globals.icc:282)."""
    R = T[:3, :3]
    t = T[:3, 3]
    Rt = R.T
    ti = -(Rt @ t)
    top = jnp.concatenate([Rt, ti[:, None]], axis=1)
    bot = jnp.asarray([[0.0, 0.0, 0.0, 1.0]], top.dtype)
    return jnp.concatenate([top, bot], axis=0)


def _link_stats_all(locals_pts, masks, mats, points_g, links, link_mask,
                    max_dist2, chunk, local_grids, bucket_cap):
    """(C [L,6,6], CD [L,6], m [L]) for all link slots.

    Grid path: queries = scan j's points in scan i's local frame
    (T_i⁻¹ T_j), matched against scan i's resident local hash; the
    matched pairs are lifted back to the global frame for the stats.
    Brute path: global-frame NN over points_g (no big gathers)."""
    if local_grids is not None:

        def one(link):
            i, j = link[0], link[1]
            g = nn_ops.CellHash(
                points=local_grids.points[i],
                src_idx=local_grids.src_idx[i],
                bucket_start=local_grids.bucket_start[i],
                origin=local_grids.origin[i],
                cell=local_grids.cell[i],
            )
            rel = _rigid_inv(mats[i]) @ mats[j]
            q_local = math3d.transform3(rel, locals_pts[j]).astype(
                jnp.float32
            )
            idx, d2, found = nn_ops.nn_cell_hash(
                q_local, masks[j], g, max_dist2, bucket_cap
            )
            a = math3d.transform3(mats[i], locals_pts[i][idx]).astype(
                jnp.float32
            )
            return lum_pair_stats(a, points_g[j], found)
    else:

        def one(link):
            i, j = link[0], link[1]
            idx, d2, found = nn_ops.nn_brute_auto(
                points_g[j], masks[j], points_g[i], masks[i], max_dist2
            )
            return lum_pair_stats(points_g[i][idx], points_g[j], found)

    # fori_loop over VALID slots only: the link bucket rounds L up to a
    # power of two and valid links come first, so a dynamic trip count
    # makes padding free.  (A lax.cond skip under lax.map's vmapped
    # chunks degenerates to computing BOTH branches — measured: no
    # savings at all.)
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

    C, CD, m = jax.lax.fori_loop(
        0, n_valid, body,
        (
            jnp.zeros((L, 6, 6), jnp.float32),
            jnp.zeros((L, 6), jnp.float32),
            jnp.zeros(L, jnp.float32),
        ),
    )
    w = link_mask.astype(C.dtype)
    return C * w[:, None, None], CD * w[:, None], m * w


def _assemble_solve(links, link_mask, C, CD, S, n_scans, axis_name=None):
    """Scatter links into block G/B, solve G X = B (FillGB3D +
    solveSparseCholesky, lum6Deuler.cc:265-303 / graphSlam6D.cc:345-366).

    Index n = S-1 is the dump row: scan 0 (fixed) and invalid links
    scatter there and the row is dropped before the solve.  Slots for
    scans >= n_scans get identity diagonal blocks so the padded system
    stays non-singular and yields X = 0 for them.

    With ``axis_name`` (links sharded over a mesh axis inside
    shard_map), the G/B block partials are psum-merged so every device
    solves the full system identically — the batched re-expression of the
    reference's OpenMP critical-section scatter (lum6Deuler.cc:285).
    The blocks accumulate in f64 and are rounded after the merge, so the
    sharded and single-device systems round alike.
    """
    out_dtype = C.dtype
    C = C.astype(jnp.float64)
    CD = CD.astype(jnp.float64)
    n = S - 1
    a = links[:, 0] - 1
    b = links[:, 1] - 1
    sa = (a >= 0) & link_mask
    sb = (b >= 0) & link_mask
    ai = jnp.where(sa, a, n)
    bi = jnp.where(sb, b, n)
    both = sa & sb
    abi = jnp.where(both, a, n)
    bbi = jnp.where(both, b, n)

    Gb = jnp.zeros((n + 1, n + 1, 6, 6), C.dtype)
    Bb = jnp.zeros((n + 1, 6), CD.dtype)
    wa = sa.astype(C.dtype)[:, None, None]
    wb = sb.astype(C.dtype)[:, None, None]
    wboth = both.astype(C.dtype)[:, None, None]
    Gb = Gb.at[ai, ai].add(C * wa)
    Gb = Gb.at[bi, bi].add(C * wb)
    Gb = Gb.at[abi, bbi].add(-C * wboth)
    Gb = Gb.at[bbi, abi].add(-C * wboth)
    Bb = Bb.at[ai].add(CD * wa[:, :, 0])
    Bb = Bb.at[bi].add(-CD * wb[:, :, 0])
    if axis_name is not None:
        Gb = jax.lax.psum(Gb, axis_name)
        Bb = jax.lax.psum(Bb, axis_name)

    # identity diagonal for pad slots and any slot with an empty block
    # row (all its links lost every pair) — keeps G non-singular
    pad = (jnp.arange(n) >= (n_scans - 1))
    diag = Gb[jnp.arange(n), jnp.arange(n)]  # [n,6,6]
    empty = jnp.sum(jnp.abs(diag), axis=(1, 2)) == 0
    fix = (pad | empty).astype(C.dtype)
    eye6 = jnp.eye(6, dtype=C.dtype)
    Gb = Gb.at[jnp.arange(n), jnp.arange(n)].add(eye6 * fix[:, None, None])

    G = Gb[:n, :n].transpose(0, 2, 1, 3).reshape(6 * n, 6 * n)
    G = G.astype(out_dtype)
    B = Bb[:n].reshape(6 * n).astype(out_dtype)
    # Jacobi scaling: translation and rotation columns differ by the
    # squared scene extent (~1e6 in cm²); rescaling keeps the f32 solve
    # well-conditioned.
    d = jnp.sqrt(jnp.maximum(jnp.diagonal(G), 1e-20))
    Gs = G / (d[:, None] * d[None, :])
    y = jnp.linalg.solve(Gs, B / d)
    X = (y / d).reshape(n, 6)
    return X


def _ha_corrections(pos, theta, X):
    """Ha⁻¹ X per scan (lum6Deuler.cc:375-436), batched on device.
    pos/theta: [n,3] for scans 1..n.  Returns [n,6]."""
    xa, ya, za = pos[:, 0], pos[:, 1], pos[:, 2]
    tx, ty = theta[:, 0], theta[:, 1]
    ctx, stx = jnp.cos(tx), jnp.sin(tx)
    cty, sty = jnp.cos(ty), jnp.sin(ty)
    z = jnp.zeros_like(xa)
    o = jnp.ones_like(xa)
    rows = [
        [o, z, z, z, -za * ctx + ya * stx, ya * cty * ctx + za * stx * cty],
        [z, o, z, za, -xa * stx, -xa * ctx * cty + za * sty],
        [z, z, o, -ya, xa * ctx, -xa * cty * stx - ya * sty],
        [z, z, z, o, z, sty],
        [z, z, z, z, stx, ctx * cty],
        [z, z, z, z, ctx, -stx * cty],
    ]
    Ha = jnp.stack(
        [jnp.stack(r, axis=-1) for r in rows], axis=-2
    )  # [n, 6, 6]
    return jnp.linalg.solve(Ha, X[..., None])[..., 0]


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "chunk", "bucket_cap", "axis_name"),
)
def lum_run(
    locals_pts,       # [S, N, 3] f32 reduced points, local frames
    masks,            # [S, N] bool
    links,            # [L, 2] int32 (pad slots anything; masked out)
    link_mask,        # [L] bool
    pos0,             # [S, 3] f32 Euler positions
    theta0,           # [S, 3] f32 Euler angles
    n_scans,          # scalar int32, real scan count (<= S)
    max_dist2,        # scalar f32
    epsilon,          # scalar f32 (--epsSLAM mean position shift)
    local_grids=None,  # CellHash with leading S dim (build_local_grids)
    *,
    iterations: int,
    chunk: int = 4,
    bucket_cap: int = 0,
    axis_name: str | None = None,
):
    """Run the full LUM relaxation on device.

    Returns (pos [S,3], theta [S,3], hist [iterations, S, 6],
    n_iters, final_ret).  ``hist[k]`` is the pose state AFTER iteration
    k (concat pos, theta); entries >= n_iters are undefined.

    ``axis_name``: when traced inside shard_map with the LINK slots
    sharded over a mesh axis (everything else replicated), the G/B
    block partials are psum-merged so every device solves the full
    system identically.
    """
    S = locals_pts.shape[0]
    md2 = jnp.float32(max_dist2)
    eps = jnp.float32(epsilon)

    def body(carry):
        pos, theta, ret, it, hist = carry
        mats = math3d.euler_to_matrix4(pos, theta, xp=jnp).astype(jnp.float32)
        points_g = (
            jnp.einsum("sij,snj->sni", mats[:, :3, :3], locals_pts)
            + mats[:, None, :3, 3]
        )
        C, CD, m = _link_stats_all(
            locals_pts, masks, mats, points_g, links, link_mask, md2,
            chunk, local_grids, bucket_cap,
        )
        X = _assemble_solve(links, link_mask, C, CD, S, n_scans, axis_name)
        corr = _ha_corrections(pos[1:], theta[1:], X)
        valid = (jnp.arange(1, S) < n_scans).astype(corr.dtype)
        corr = corr * valid[:, None]
        pos = pos.at[1:].add(-corr[:, :3])
        theta = theta.at[1:].add(-corr[:, 3:])
        ret = jnp.sum(jnp.linalg.norm(corr[:, :3], axis=1)) / jnp.maximum(
            n_scans.astype(jnp.float32), 1.0
        )
        hist = hist.at[it].set(jnp.concatenate([pos, theta], axis=-1))
        return pos, theta, ret, it + 1, hist

    def cond(carry):
        _, _, ret, it, _ = carry
        return (it < iterations) & (ret > eps)

    hist0 = jnp.zeros((iterations, S, 6), jnp.float32)
    init = (
        pos0.astype(jnp.float32),
        theta0.astype(jnp.float32),
        jnp.float32(jnp.inf),
        jnp.int32(0),
        hist0,
    )
    pos, theta, ret, it, hist = jax.lax.while_loop(cond, body, init)
    return pos, theta, hist, it, ret


# ---------------------------------------------------------------------------
# Correspondence-cached link covariances (continuous-closure fast path)
# ---------------------------------------------------------------------------
#
# The reference recomputes every link's NN pairing on every closure
# (elch6Dslerp.cc:56-85 loops covarianceQuat over ALL edges; slam6D.cc:508
# re-runs doGraphSlam6D over the full prefix graph).  In the continuous-
# closure regime (hannover2 -L 4) that is the dominant cost: each closure
# pays O(links) brute NN passes while the poses have barely moved since
# the previous closure two scans earlier.
#
# NN correspondences depend ONLY on the relative pose T_i^-1 T_j of a
# link's endpoints (distances are rigid-invariant), so they are cached
# per link and refreshed only when the relative pose drifts beyond a
# tolerance.  The covariance STATS (lum_pair_stats: global-frame midpoint
# sums, lum6Deuler.cc:141-232) are recomputed EXACTLY from the current
# global poses every call — only the argmin is reused, so the result
# equals the uncached path up to pairs whose NN assignment flipped within
# the drift tolerance (distance error bounded by 2*(dt + r*dtheta)).


def _refresh_and_stats(locals_pts, masks, mats, links, link_mask,
                       idx_cache, found_cache, stale_idx, n_stale,
                       max_dist2):
    """Shared body: refresh NN for stale link slots, then batched
    (C, CD, m) for ALL slots from cached pairings at current poses."""
    points_g = (
        jnp.einsum("sij,snj->sni", mats[:, :3, :3], locals_pts)
        + mats[:, None, :3, 3]
    ).astype(jnp.float32)
    md2 = jnp.float32(max_dist2)

    def body(k, carry):
        idx_c, found_c = carry
        sl = stale_idx[k]
        i, j = links[sl, 0], links[sl, 1]
        idx, _, found = nn_ops.nn_brute_auto(
            points_g[j], masks[j], points_g[i], masks[i], md2
        )
        return idx_c.at[sl].set(idx.astype(jnp.int32)), found_c.at[sl].set(found)

    idx_cache, found_cache = jax.lax.fori_loop(
        0, n_stale, body, (idx_cache, found_cache)
    )

    pi = links[:, 0]
    pj = links[:, 1]
    a = jnp.take_along_axis(points_g[pi], idx_cache[..., None], axis=1)
    b = points_g[pj]
    d2 = jnp.sum((a - b) ** 2, axis=-1)
    found = found_cache & (d2 <= md2)
    C, CD, m = jax.vmap(lum_pair_stats)(a, b, found)
    w = link_mask.astype(C.dtype)
    return (
        idx_cache, found_cache,
        C * w[:, None, None], CD * w[:, None], m * w,
    )


@functools.partial(jax.jit, donate_argnames=("idx_cache", "found_cache"))
def link_cov_cached(locals_pts, masks, mats, links, link_mask,
                    idx_cache, found_cache, stale_idx, n_stale, max_dist2):
    """(C, CD, m, idx_cache, found_cache) for all link slots with cached
    correspondences — the ELCH edge-covariance fast path."""
    idx_cache, found_cache, C, CD, m = _refresh_and_stats(
        locals_pts, masks, mats, links, link_mask,
        idx_cache, found_cache, stale_idx, n_stale, max_dist2,
    )
    return C, CD, m, idx_cache, found_cache


@functools.partial(jax.jit, donate_argnames=("idx_cache", "found_cache"))
def lum_step_cached(locals_pts, masks, links, link_mask, pos0, theta0,
                    n_scans, max_dist2, idx_cache, found_cache,
                    stale_idx, n_stale):
    """ONE LUM iteration (the per-closure doGraphSlam6D(gr, scans, 1),
    slam6D.cc:508) with cached correspondences: refresh stale links →
    exact stats → assemble → dense solve → pose update, in one jit.

    Returns (pos [S,3], theta [S,3], ret, idx_cache, found_cache)."""
    S = locals_pts.shape[0]
    pos = pos0.astype(jnp.float32)
    theta = theta0.astype(jnp.float32)
    mats = math3d.euler_to_matrix4(pos, theta, xp=jnp).astype(jnp.float32)
    idx_cache, found_cache, C, CD, m = _refresh_and_stats(
        locals_pts, masks, mats, links, link_mask,
        idx_cache, found_cache, stale_idx, n_stale, max_dist2,
    )
    X = _assemble_solve(links, link_mask, C, CD, S, n_scans)
    corr = _ha_corrections(pos[1:], theta[1:], X)
    valid = (jnp.arange(1, S) < n_scans).astype(corr.dtype)
    corr = corr * valid[:, None]
    pos = pos.at[1:].add(-corr[:, :3])
    theta = theta.at[1:].add(-corr[:, 3:])
    ret = jnp.sum(jnp.linalg.norm(corr[:, :3], axis=1)) / jnp.maximum(
        n_scans.astype(jnp.float32), 1.0
    )
    return pos, theta, ret, idx_cache, found_cache


class CorrCache:
    """Host-side bookkeeping for the correspondence cache: persistent
    slot assignment per link, per-slot relative pose at the last NN
    refresh, and the resident [L, N] idx/found device arrays.

    ``tol_t`` (cm) / ``tol_r`` (rad): relative-pose drift beyond which a
    link's correspondences are recomputed.  New links are always stale.
    """

    def __init__(self, n_points: int, tol_t: float = 0.5,
                 tol_r: float = 2e-3, slot_cap_min: int = 64):
        self.N = int(n_points)
        self.tol_t = float(tol_t)
        self.tol_r = float(tol_r)
        self.slot_cap_min = int(slot_cap_min)
        self.slots: dict = {}
        self.L = 0
        self.idx = None
        self.found = None
        self.rel = None  # [L, 4, 4] f64 relative pose at last refresh
        self.n_refresh = 0
        self.n_reuse = 0

    def _grow(self, need: int) -> None:
        L2 = max(self.slot_cap_min, self.L or self.slot_cap_min)
        while L2 < need:
            L2 *= 2
        if L2 == self.L:
            return
        idx2 = jnp.zeros((L2, self.N), jnp.int32)
        fnd2 = jnp.zeros((L2, self.N), bool)
        rel2 = np.tile(np.eye(4), (L2, 1, 1))
        if self.L:
            idx2 = idx2.at[: self.L].set(self.idx)
            fnd2 = fnd2.at[: self.L].set(self.found)
            rel2[: self.L] = self.rel
        self.idx, self.found, self.rel, self.L = idx2, fnd2, rel2, L2

    def prepare(self, links: "np.ndarray", mats: "np.ndarray"):
        """links [E,2] int, mats [n,4,4] f64 current poses.  Returns
        (links_pad [L,2] i32, link_mask [L] bool, stale_idx [L] i32,
        n_stale) and records the refreshed relative poses."""
        E = len(links)
        new_set = set()
        for l in links:
            key = tuple(map(int, l))
            if key not in self.slots:
                self.slots[key] = len(self.slots)
                new_set.add(key)
        self._grow(len(self.slots))
        slot = np.array(
            [self.slots[tuple(map(int, l))] for l in links], np.int64
        )
        links_pad = np.zeros((self.L, 2), np.int32)
        link_mask = np.zeros(self.L, bool)
        links_pad[slot] = np.asarray(links, np.int32)
        link_mask[slot] = True

        Ti = mats[links[:, 0]]
        Tj = mats[links[:, 1]]
        Ri = Ti[:, :3, :3]
        rel_R = np.einsum("lji,ljk->lik", Ri, Tj[:, :3, :3])
        rel_t = np.einsum(
            "lji,lj->li", Ri, Tj[:, :3, 3] - Ti[:, :3, 3]
        )
        old_R = self.rel[slot, :3, :3]
        old_t = self.rel[slot, :3, 3]
        dt = np.linalg.norm(rel_t - old_t, axis=1)
        tr = np.einsum("lij,lij->l", rel_R, old_R)
        ang = np.arccos(np.clip((tr - 1.0) * 0.5, -1.0, 1.0))
        fresh_rel = np.zeros(E, bool)
        if E:
            known = np.array(
                [tuple(map(int, l)) not in new_set for l in links]
            )
            fresh_rel = known & (dt <= self.tol_t) & (ang <= self.tol_r)
        stale = ~fresh_rel
        stale_slots = slot[stale]
        self.n_refresh += int(stale.sum())
        self.n_reuse += int(fresh_rel.sum())
        rel_new = np.tile(np.eye(4), (stale.sum(), 1, 1))
        rel_new[:, :3, :3] = rel_R[stale]
        rel_new[:, :3, 3] = rel_t[stale]
        self.rel[stale_slots] = rel_new
        stale_idx = np.zeros(self.L, np.int32)
        stale_idx[: len(stale_slots)] = stale_slots.astype(np.int32)
        return links_pad, link_mask, stale_idx, int(stale.sum())
