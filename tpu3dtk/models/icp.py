"""ICP matching engine — the JAX-native ``icp6D`` (ref
src/slam6d/icp6D.cc:104-285).

Design (not a port): the reference's hot loop is a per-point kd-tree
recursion inside an OpenMP region; here one jitted ``lax.while_loop``
fuses, per iteration:

  1. transform target points by the current pose (ref transformReduced,
     scan.cc:851-873 — but we keep local points immutable and compose
     the pose instead of mutating point storage),
  2. batched NN search against the model points (ops.nn),
  3. masked centered pair statistics (ref icp6D.cc:144-191),
  4. a closed-form minimizer (models.minimizers),
  5. pose update T <- align @ T (ref transformMatrix, scan.cc:878-898),
  6. the two-delta convergence test
     |err - prev| < eps and |err - prevprev| < eps (ref icp6D.cc:266-279).

Pairing semantics match ``SearchTree::getPtPairs``
(src/slam6d/searchTree.cc:91-188): model points live in the model's
current global frame, target (data) points in the target's current
estimate; matches beyond max_dist_match2 are rejected (strict <).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math3d
from ..ops import nn as nn_ops
from . import minimizers as mz

__all__ = ["IcpParams", "IcpResult", "icp_pair", "icp_step"]


class IcpParams(NamedTuple):
    max_dist_match2: float = 625.0  # -d 25 -> 25^2 (cm^2)
    max_iterations: int = 50  # -i
    epsilon: float = 1e-5  # --epsICP
    minimizer: str = "quat"  # -a
    subsample: int = 1  # rnd: take ~1/rnd of target points per iteration
    pairing: str = "closest_point"  # ref PairingMode (pairingMode.h):
    # "closest_point" | "closest_plane" (point-to-plane projection) |
    # "along_normal" (normal shooting)


class IcpResult(NamedTuple):
    T: jnp.ndarray  # [4,4] final pose of the target scan (global)
    error: jnp.ndarray  # final RMS point-to-point error
    iterations: jnp.ndarray  # iterations executed
    n_pairs: jnp.ndarray  # pairs in last iteration
    # max hash-bucket occupancy seen (0 on the brute path): the cell
    # list is exact only while this stays <= grid_bucket_cap; drivers
    # re-match with brute NN when it overflows.  (Plain-int default:
    # must not touch the device backend at import time.)
    maxocc: int = 0


def _find_pairs(
    model, mmask, tgt_global, tmask, max_dist2, pairing="closest_point",
    tgt_normals=None, grid=None,
):  # noqa: D401 — see docstring below
    """Correspondence search for one iteration: returns matched model
    points [N,3] (projected per pairing mode) and the accept mask [N].

    Pairing semantics follow SearchTree::getPtPairs
    (searchTree.cc:126-163): for "closest_plane" the matched model point
    is projected onto the plane through the target point with the
    *target's* normal (s' = (n·(s−t))n + t); for "along_normal" the NN
    metric is perpendicular distance to the target's normal ray.

    When ``grid`` (a prebuilt :class:`ops.nn.CellHash`) is given, the
    closest-point search runs through the sublinear hashed cell-list
    kernel instead of brute force (the reference's kd-tree role,
    include/slam6d/kdTreeImpl.h:345).
    """
    if pairing == "along_normal":
        idx, d2, found = nn_ops.nn_brute_line(
            tgt_global, tgt_normals, tmask, model, mmask, max_dist2
        )
    elif grid is not None:
        ghash, bucket_cap = grid
        idx, d2, found = nn_ops.nn_cell_hash(
            tgt_global, tmask, ghash, max_dist2, bucket_cap
        )
    else:
        idx, d2, found = nn_ops.nn_brute_auto(
            tgt_global, tmask, model, mmask, max_dist2
        )
    m_pts = model[idx]
    if pairing == "closest_plane":
        dot = jnp.sum(tgt_normals * (m_pts - tgt_global), axis=1, keepdims=True)
        m_pts = tgt_global + dot * tgt_normals
    return m_pts, found


def _pair_statistics(
    model, mmask, tgt_global, tmask, max_dist2, pairing="closest_point",
    tgt_normals=None, grid=None, axis_name=None,
):
    m_pts, found = _find_pairs(
        model, mmask, tgt_global, tmask, max_dist2,
        pairing=pairing, tgt_normals=tgt_normals, grid=grid,
    )
    return mz.pair_stats(m_pts, tgt_global, found, axis_name=axis_name)


def _build_grid_inline(model, mmask, max_dist2, n_buckets: int):
    """Trace the hash build (masked-min origin + sort) and its max
    occupancy.  Drivers call :func:`build_match_grid` (a separate jit)
    and pass the result INTO the loop jit, so the hash is built once per
    match and its arrays reach the loop as parameters; this inline
    variant serves the single-program paths (the on-device sequence
    loop and shard_map bodies)."""
    inf3 = jnp.full((3,), jnp.float32(jnp.inf))
    origin = jnp.min(jnp.where(mmask[:, None], model, inf3), axis=0)
    origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
    cell = jnp.sqrt(jnp.float32(max_dist2))
    ghash = nn_ops.build_cell_hash(model, mmask, origin, cell, n_buckets)
    return ghash, nn_ops.cell_hash_max_occupancy(ghash)


build_match_grid = jax.jit(_build_grid_inline, static_argnames=("n_buckets",))


def _icp_pair_impl(
    model,
    mmask,
    target_local,
    tmask,
    T0,
    *,
    max_dist_match2,
    epsilon,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
    target_normals_local=None,
    grid=None,
    grid_bucket_cap: int = 0,
    axis_name: str | None = None,
) -> IcpResult:
    """Match one target scan against fixed model points.

    ``axis_name``: when traced inside shard_map with the target points
    sharded over a mesh axis (model replicated), pair statistics are
    psum-merged over it each iteration — the multi-device parallel ICP
    (see parallel.icp_shard.icp_pair_sharded).

    model: [M,3] f32 model points in global frame; target_local: [N,3]
    f32 target points in the target's **local** frame; T0: [4,4] initial
    global pose of the target (transMatOrg composed with odometry
    extrapolation, ref scan.cc:826-833).

    subsample = the reference's ``rnd`` (-R): each iteration uses a
    fresh ~1/subsample random subset of target points
    (searchTree.cc:54-55 ``rand(rnd) != 0 -> skip``).

    ``grid``: a PREBUILT ops.nn.CellHash (from build_match_grid) +
    grid_bucket_cap > 0 routes the closest-point search through the
    hashed cell list (ops.nn.nn_cell_hash): the model is fixed across
    iterations, so the hash is built ONCE per match and every
    ``lax.while_loop`` iteration pays O(Q·27·cap) instead of O(Q·M) —
    the role the kd-tree build plays in the reference
    (BasicScan::createSearchTreePrivate, basicScan.cc:702-728).  Size
    the statics with ops.nn.cell_hash_spec on the host.  The hash MUST
    enter as an argument, not be built inline — see _build_grid_inline.
    """
    model = model.astype(jnp.float32)
    target_local = target_local.astype(jnp.float32)
    T0 = T0.astype(jnp.float32)
    if minimizer == "napx" and target_normals_local is None:
        raise ValueError("napx minimizer requires target normals")
    align_fn = mz.MINIMIZERS[minimizer]
    eps = jnp.float32(epsilon)
    key0 = jax.random.PRNGKey(seed)
    need_normals = pairing != "closest_point" or minimizer == "napx"

    if grid is not None and pairing != "along_normal":
        grid = (grid, grid_bucket_cap)
    else:
        grid = None

    def cond(carry):
        T, ret, prev, prev2, it, done, npairs = carry
        return (~done) & (it < max_iterations)

    def body(carry):
        T, ret, prev, prev2, it, done, _ = carry
        if subsample > 1:
            k = jax.random.fold_in(key0, it)
            keep = (
                jax.random.randint(k, tmask.shape, 0, subsample) == 0
            )
            it_mask = tmask & keep
        else:
            it_mask = tmask
        tgt_global = math3d.transform3(T, target_local).astype(jnp.float32)
        if need_normals:
            normals_g = math3d.transform3normal(
                T, target_normals_local
            ).astype(jnp.float32)
        else:
            normals_g = None
        if minimizer == "napx":
            m_pts, found = _find_pairs(
                model, mmask, tgt_global, it_mask,
                jnp.float32(max_dist_match2),
                pairing=pairing, tgt_normals=normals_g, grid=grid,
            )
            nstats = mz.napx_stats(
                m_pts, tgt_global, normals_g, found, axis_name=axis_name
            )
            enough = nstats.n > 3
            align, err = align_fn(nstats)
            npairs = nstats.n
        else:
            stats = _pair_statistics(
                model, mmask, tgt_global, it_mask,
                jnp.float32(max_dist_match2),
                pairing=pairing, tgt_normals=normals_g, grid=grid,
                axis_name=axis_name,
            )
            enough = stats.n > 3
            if minimizer in ("lumeuler", "lumquat"):
                # ref icp6D.cc:242-245: algo 7/8 receive the current pose
                align, err = align_fn(stats, T)
            else:
                align, err = align_fn(stats)
            npairs = stats.n
        align = jnp.where(enough, align, jnp.eye(4, dtype=jnp.float32))
        T_new = align @ T
        prev2_new = prev
        prev_new = ret
        ret_new = jnp.where(enough, err, ret)
        conv = (jnp.abs(ret_new - prev_new) < eps) & (
            jnp.abs(ret_new - prev2_new) < eps
        )
        # pose-fixpoint test: an increment below 100 um / ~1e-5 rad is
        # the f32 stats-noise floor (measured: increments jitter at
        # 13-85 um with the error frozen to 4 decimals) — further
        # iterations random-walk the pose without progress.  The f64
        # reference reaches the same state as an exact fixpoint and
        # stops via its eps test; at city-scale pair counts the RMS
        # churns by far more than any usable eps, so without this the
        # error test alone never stops f32 pipelines.
        pose_conv = (
            jnp.linalg.norm(align[:3, 3]) < jnp.float32(1e-2)
        ) & (
            jnp.linalg.norm(
                align[:3, :3] - jnp.eye(3, dtype=align.dtype)
            ) < jnp.float32(1e-5)
        )
        done_new = conv | (pose_conv & enough) | ~enough
        return (T_new, ret_new, prev_new, prev2_new, it + 1, done_new, npairs)

    init = (
        T0,
        jnp.float64(0.0),  # err carried in f64 (see pair_stats sum_d2)
        jnp.float64(0.0),
        jnp.float64(0.0),
        jnp.int32(0),
        jnp.bool_(False),
        jnp.float32(0.0),
    )
    T, ret, prev, prev2, it, done, npairs = jax.lax.while_loop(cond, body, init)
    return IcpResult(
        T=T, error=ret, iterations=it, n_pairs=npairs, maxocc=jnp.int32(0)
    )


_icp_loop = jax.jit(
    _icp_pair_impl,
    static_argnames=(
        "max_iterations",
        "minimizer",
        "subsample",
        "pairing",
        "grid_bucket_cap",
        "axis_name",
    ),
)


def icp_pair(
    model, mmask, target_local, tmask, T0, *,
    max_dist_match2, epsilon,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
    target_normals_local=None,
    grid_buckets: int = 0,
    grid_bucket_cap: int = 0,
) -> IcpResult:
    """Match one target scan against fixed model points (two jit calls:
    hash build + the while_loop; see _icp_pair_impl for semantics and
    _build_grid_inline for the split)."""
    grid = None
    occ = None
    if grid_buckets > 0 and pairing != "along_normal":
        grid, occ = build_match_grid(
            jnp.asarray(model, jnp.float32), jnp.asarray(mmask),
            jnp.float32(max_dist_match2), n_buckets=grid_buckets,
        )
    res = _icp_loop(
        model, mmask, target_local, tmask, T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
        target_normals_local=target_normals_local,
        grid=grid, grid_bucket_cap=grid_bucket_cap,
    )
    if occ is not None:
        res = res._replace(maxocc=occ)
    return res


def _icp_pair_seq_impl(
    locals_all,       # [S, N, 3] f32 all scans' reduced points, local frames
    masks_all,        # [S, N] bool
    normals_all,      # [S, N, 3] f32 or dummy zeros (see has_normals)
    mats,             # [S, 4, 4] f32 current global poses
    lo, hi,           # scalars int32: model window = scans [lo, hi)
    tgt_idx,          # scalar int32: target scan index
    T0,               # [4, 4] f32 initial target pose (odometry-extrapolated)
    max_dist_match2,
    epsilon,
    seed,
    *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    has_normals: bool = False,
    grid_buckets: int = 0,
    grid_bucket_cap: int = 0,
    axis_name: str | None = None,
    n_shards: int = 1,
    window_cap: int = 0,
):
    """Sequence-resident ICP match: the metascan model is built ON
    DEVICE from the resident sequence tensors — transform the window's
    scans by their current poses and mask to [lo, hi) — so the driver
    never rebuilds/re-uploads the model per match (the reference instead
    keeps a kd-tree per scan resident, basicScan.cc:702-728).

    lo/hi/tgt_idx are DYNAMIC scalars: every match of a sequence reuses
    one compiled executable regardless of the window position or model
    size.  ``window_cap`` (static, 0 = all S scans): the model is a
    dynamic_slice of window_cap scans, so per-match NN cost is
    O(window_cap * N), not O(S * N) — required for long non-metascan
    sequences (without it every sharded match paid the full-sequence
    model).  Under shard_map (axis_name set, n_shards
    static), the target points are the device's 1/n_shards slice and
    pair statistics psum.
    """
    S, N = masks_all.shape
    W = min(window_cap, S) if window_cap else S
    s0 = jnp.clip(lo, 0, S - W).astype(jnp.int32)
    zero = jnp.int32(0)
    win_locals = jax.lax.dynamic_slice(locals_all, (s0, zero, zero), (W, N, 3))
    win_mats = jax.lax.dynamic_slice(mats, (s0, zero, zero), (W, 4, 4))
    win_masks = jax.lax.dynamic_slice(masks_all, (s0, zero), (W, N))
    pts_g = (
        jnp.einsum("sij,snj->sni", win_mats[:, :3, :3], win_locals)
        + win_mats[:, None, :3, 3]
    )
    model = pts_g.reshape(W * N, 3)
    sid = s0 + jnp.arange(W)
    active = (sid >= lo) & (sid < hi)
    mmask = (win_masks & active[:, None]).reshape(W * N)
    tgt = locals_all[tgt_idx]
    tmask = masks_all[tgt_idx]
    normals = normals_all[tgt_idx] if has_normals else None
    if axis_name is not None and n_shards > 1:
        rank = jax.lax.axis_index(axis_name).astype(jnp.int32)
        chunk = N // n_shards
        start = rank * jnp.int32(chunk)
        zero = jnp.int32(0)
        tgt = jax.lax.dynamic_slice(tgt, (start, zero), (chunk, 3))
        tmask = jax.lax.dynamic_slice(tmask, (start,), (chunk,))
        if normals is not None:
            normals = jax.lax.dynamic_slice(normals, (start, zero), (chunk, 3))
    grid = None
    occ = jnp.int32(0)
    if grid_buckets > 0 and pairing != "along_normal":
        grid, occ = _build_grid_inline(
            model, mmask, jnp.float32(max_dist_match2), grid_buckets
        )
    res = _icp_pair_impl(
        model, mmask, tgt, tmask, T0,
        max_dist_match2=max_dist_match2,
        epsilon=epsilon,
        max_iterations=max_iterations,
        minimizer=minimizer,
        subsample=subsample,
        seed=seed,
        pairing=pairing,
        target_normals_local=normals,
        grid=grid,
        grid_bucket_cap=grid_bucket_cap,
        axis_name=axis_name,
    )
    return res._replace(maxocc=occ)


@functools.partial(
    jax.jit, static_argnames=("has_normals", "n_buckets", "window_cap")
)
def _seq_build(
    locals_all, masks_all, normals_all, mats, lo, hi, tgt_idx,
    max_dist2, *, has_normals: bool, n_buckets: int, window_cap: int = 0,
):
    """Build phase of the sequence-resident match: metascan model from
    the resident tensors + the hash.  A SEPARATE jit from the loop so
    the hash arrays cross a program boundary and enter the loop as
    parameters (see _build_grid_inline).

    ``window_cap`` (static): number of scan slots in the model.  The
    window [lo, hi) is contiguous, so the model is a dynamic_slice of
    ``window_cap`` scans — per-match NN cost is O(window_cap * N), not
    O(S * N), which is what makes long non-metascan sequences (model =
    previous scan only, window_cap=1) scale.  0 means all S scans."""
    S, N = masks_all.shape
    W = min(window_cap, S) if window_cap else S
    s0 = jnp.clip(lo, 0, S - W).astype(jnp.int32)
    zero = jnp.int32(0)
    # slice BEFORE transforming: only the window's W scans are rotated,
    # not all S (at S=100, W=1 this is 100x less transform work/match)
    win_locals = jax.lax.dynamic_slice(locals_all, (s0, zero, zero), (W, N, 3))
    win_mats = jax.lax.dynamic_slice(mats, (s0, zero, zero), (W, 4, 4))
    win_mask = jax.lax.dynamic_slice(masks_all, (s0, zero), (W, N))
    win = (
        jnp.einsum("sij,snj->sni", win_mats[:, :3, :3], win_locals)
        + win_mats[:, None, :3, 3]
    )
    sid = s0 + jnp.arange(W)
    active = (sid >= lo) & (sid < hi)
    model = win.reshape(W * N, 3)
    mmask = (win_mask & active[:, None]).reshape(W * N)
    tgt = locals_all[tgt_idx]
    tmask = masks_all[tgt_idx]
    normals = normals_all[tgt_idx] if has_normals else jnp.zeros((1, 3))
    if n_buckets > 0:
        grid, occ = _build_grid_inline(
            model, mmask, jnp.float32(max_dist2), n_buckets
        )
    else:
        grid, occ = None, jnp.int32(0)
    return model, mmask, tgt, tmask, normals, grid, occ


def icp_pair_seq(
    locals_all, masks_all, normals_all, mats, lo, hi, tgt_idx, T0,
    max_dist_match2, epsilon, seed,
    *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    has_normals: bool = False,
    grid_buckets: int = 0,
    grid_bucket_cap: int = 0,
    window_cap: int = 0,
) -> IcpResult:
    """Sequence-resident match as TWO jit calls (build + loop); see
    _icp_pair_seq_impl for the semantics (that single-program variant
    remains for shard_map, where the split is impossible)."""
    use_grid = grid_buckets if pairing != "along_normal" else 0
    model, mmask, tgt, tmask, normals, grid, occ = _seq_build(
        locals_all, masks_all, normals_all, mats,
        jnp.int32(lo), jnp.int32(hi), jnp.int32(tgt_idx),
        jnp.float32(max_dist_match2),
        has_normals=has_normals, n_buckets=use_grid,
        window_cap=window_cap,
    )
    res = _icp_loop(
        model, mmask, tgt, tmask, T0,
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
        subsample=subsample, seed=seed, pairing=pairing,
        target_normals_local=normals if has_normals else None,
        grid=grid, grid_bucket_cap=grid_bucket_cap,
    )
    return res._replace(maxocc=occ)


def _orthonormalize_rot(T):
    """Two Newton steps R <- R(3I - RᵀR)/2: re-orthonormalizes a
    near-rotation in-place of the host SVD (traceable, converges
    quadratically — accumulated f32 drift per match is ~1e-6)."""
    R = T[:3, :3]
    eye = jnp.eye(3, dtype=T.dtype)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.T @ R))
    return T.at[:3, :3].set(R)


@functools.partial(
    jax.jit,
    static_argnames=(
        "metascan", "extrapolate", "window_cap", "max_iterations",
        "minimizer", "subsample", "pairing", "has_normals",
    ),
)
def register_sequence_device(
    locals_all,    # [S, N, 3] f32 reduced points, local frames
    masks_all,     # [S, N] bool
    normals_all,   # [S, N, 3] f32 (dummy when has_normals=False)
    mats_org,      # [S, 4, 4] f32 odometry poses (transMatOrg)
    mats0,         # [S, 4, 4] f32 current poses (== mats_org for fresh scans)
    n_scans,       # scalar int32: real scan count (<= S)
    max_dist_match2,
    epsilon,
    *,
    metascan: bool = False,
    extrapolate: bool = True,
    window_cap: int = 1,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    has_normals: bool = False,
):
    """The WHOLE sequential registration on device: one jitted fori_loop
    over scans, each step = odometry extrapolation + a full ICP
    while_loop match against the resident model window + pose update —
    the batched ``icp6D::doICP`` (icp6D.cc:374-437) with zero host
    round trips per match: one dispatch and one fetch for the whole
    sequence instead of one of each per match.

    Returns (mats [S,4,4] final poses, errs [S], iters [S], npairs [S]);
    entry 0 keeps its odometry pose.  The driver replays `.frames`
    bookkeeping from the pose history afterwards.
    """
    S, N = masks_all.shape
    md2 = jnp.float32(max_dist_match2)
    eps = jnp.float32(epsilon)

    def step(i, carry):
        mats, errs, iters, npairs = carry
        prev = mats[i - 1]
        if extrapolate:
            # deltaMat = prev.transMat @ inv(prev.transMatOrg), applied
            # to the target's current pose (scan.cc:826-833)
            delta = prev @ _rigid_inv_f32(mats_org[i - 1])
            T0 = delta @ mats[i]
        else:
            T0 = mats[i]
        lo = jnp.where(jnp.bool_(metascan), 0, i - 1).astype(jnp.int32)
        res = _icp_pair_seq_impl(
            locals_all, masks_all, normals_all, mats,
            lo, i, i, T0, md2, eps, i,
            max_iterations=max_iterations, minimizer=minimizer,
            subsample=subsample, pairing=pairing,
            has_normals=has_normals,
            window_cap=window_cap,
        )
        T_new = _orthonormalize_rot(res.T)
        live = i < n_scans
        mats = mats.at[i].set(jnp.where(live, T_new, mats[i]))
        errs = errs.at[i].set(res.error.astype(jnp.float32))
        iters = iters.at[i].set(res.iterations)
        npairs = npairs.at[i].set(res.n_pairs)
        return mats, errs, iters, npairs

    init = (
        mats0.astype(jnp.float32),
        jnp.zeros(S, jnp.float32),
        jnp.zeros(S, jnp.int32),
        jnp.zeros(S, jnp.float32),
    )
    return jax.lax.fori_loop(1, S, step, init)


@functools.partial(
    jax.jit,
    static_argnames=(
        "metascan", "extrapolate", "window_cap", "max_iterations",
        "minimizer", "subsample", "pairing", "has_normals",
    ),
)
def register_segment_device(
    locals_all,    # [S, N, 3] f32 reduced points, local frames
    masks_all,     # [S, N] bool
    normals_all,   # [S, N, 3] f32 (dummy when has_normals=False)
    mats_org,      # [S, 4, 4] f32 odometry poses (transMatOrg)
    mats0,         # [S, 4, 4] f32 current poses (post-relax for matched scans)
    i_start,       # scalar int32: first scan to match in this segment
    n_scans,       # scalar int32: real scan count (<= S)
    loopsize,      # scalar int32: -L loopsize (slam6D.cc:480)
    cldist2,       # scalar f32: cldist^2 (slam6D.cc:483)
    state0,        # [4] f32: (loop_state, min_dist, first, last) carried
                   # across segments (min_dist < 0 = unset)
    max_dist_match2,
    epsilon,
    *,
    metascan: bool = False,
    extrapolate: bool = True,
    window_cap: int = 1,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    has_normals: bool = False,
):
    """One SEGMENT of the GraphPipeline's sequential phase, fully on
    device: a jitted while_loop that matches scan after scan (odometry
    extrapolation + full ICP while_loop vs the resident model window)
    AND evaluates the loop-closure detector after every match — the
    pose-proximity scan of ``matchGraph6Dautomatic``
    (ref src/slam6d/slam6D.cc:479-489: j < i - loopsize and
    dist²(rPos_j, rPos_i) < cldist², two-scan confirmation state
    machine).  The loop exits when a closure must run (loop_state
    reaches 2) or the sequence ends, so the host pays ONE packed fetch
    per closure instead of a dispatch and a fetch per match.  ELCH +
    LUM then run host-orchestrated on the
    fetched poses and the next segment resumes from the relaxed mats.

    Returns ONE packed f32 vector (see unpack_segment):
    [mats S*16 | errs S | iters S | npairs S | i_next ls min_dist first last].
    """
    S, N = masks_all.shape
    md2 = jnp.float32(max_dist_match2)
    eps = jnp.float32(epsilon)

    def cond(carry):
        mats, errs, iters, npairs, i, ls, mind, first, last = carry
        return (i < n_scans) & (ls < 2)

    def body(carry):
        mats, errs, iters, npairs, i, ls, mind, first, last = carry
        prev = mats[i - 1]
        if extrapolate:
            delta = prev @ _rigid_inv_f32(mats_org[i - 1])
            T0 = delta @ mats[i]
        else:
            T0 = mats[i]
        lo = jnp.where(jnp.bool_(metascan), 0, i - 1).astype(jnp.int32)
        res = _icp_pair_seq_impl(
            locals_all, masks_all, normals_all, mats,
            lo, i, i, T0, md2, eps, i,
            max_iterations=max_iterations, minimizer=minimizer,
            subsample=subsample, pairing=pairing,
            has_normals=has_normals, window_cap=window_cap,
        )
        T_new = _orthonormalize_rot(res.T)
        mats = mats.at[i].set(T_new)
        errs = errs.at[i].set(res.error.astype(jnp.float32))
        iters = iters.at[i].set(res.iterations)
        npairs = npairs.at[i].set(res.n_pairs)
        # two-scan confirmation: a 1 set by the PREVIOUS scan becomes 2
        # (slam6D.cc:476-478), then this scan's proximity scan may still
        # improve (first, last)
        ls = jnp.where(ls == jnp.int32(1), jnp.int32(2), ls)
        pos = mats[:, :3, 3]
        d = jnp.sum((pos - pos[i]) ** 2, axis=1)
        jmask = jnp.arange(S, dtype=jnp.int32) < (i - loopsize)
        close = jmask & (d < cldist2)
        any_close = jnp.any(close)
        dmask = jnp.where(close, d, jnp.float32(jnp.inf))
        jmin = jnp.argmin(dmask).astype(jnp.float32)
        dmin = jnp.min(dmask)
        ls = jnp.where(any_close, jnp.maximum(ls, 1), ls)
        better = any_close & ((mind < 0) | (dmin < mind))
        mind = jnp.where(better, dmin, mind)
        first = jnp.where(better, jmin, first)
        last = jnp.where(better, i.astype(jnp.float32), last)
        return (mats, errs, iters, npairs, i + 1, ls, mind, first, last)

    init = (
        mats0.astype(jnp.float32),
        jnp.zeros(S, jnp.float32),
        jnp.zeros(S, jnp.int32),
        jnp.zeros(S, jnp.float32),
        jnp.asarray(i_start, jnp.int32),
        state0[0].astype(jnp.int32),
        state0[1].astype(jnp.float32),
        state0[2].astype(jnp.float32),
        state0[3].astype(jnp.float32),
    )
    mats, errs, iters, npairs, i, ls, mind, first, last = jax.lax.while_loop(
        cond, body, init
    )
    return jnp.concatenate([
        mats.reshape(S * 16),
        errs,
        iters.astype(jnp.float32),
        npairs,
        jnp.stack([
            i.astype(jnp.float32), ls.astype(jnp.float32), mind, first, last
        ]),
    ])


def unpack_segment(packed, S: int):
    """Host-side inverse of :func:`register_segment_device`'s packing
    (numpy in / numpy out; ONE device→host transfer upstream)."""
    p = np.asarray(packed)
    mats = p[: S * 16].reshape(S, 4, 4)
    errs = p[S * 16 : S * 17]
    iters = p[S * 17 : S * 18].astype(np.int32)
    npairs = p[S * 18 : S * 19]
    i_next, ls, mind, first, last = p[S * 19 : S * 19 + 5]
    return dict(
        mats=mats, errs=errs, iters=iters, npairs=npairs,
        i_next=int(i_next), loop_state=int(ls), min_dist=float(mind),
        first=int(first), last=int(last),
    )


def _rigid_inv_f32(T):
    """Inverse of a rigid 4x4 (Rᵀ, -Rᵀt), traceable."""
    R = T[:3, :3]
    t = T[:3, 3]
    Rt = R.T
    ti = -(Rt @ t)
    top = jnp.concatenate([Rt, ti[:, None]], axis=1)
    bot = jnp.asarray([[0.0, 0.0, 0.0, 1.0]], top.dtype)
    return jnp.concatenate([top, bot], axis=0)


@jax.jit
def pack_result(res: IcpResult) -> jnp.ndarray:
    """Pack an IcpResult into ONE [20] f32 vector on device so drivers
    pay a single device→host transfer per match instead of one per
    leaf."""
    return jnp.concatenate([
        res.T.reshape(16).astype(jnp.float32),
        jnp.stack([
            res.error.astype(jnp.float32),
            res.iterations.astype(jnp.float32),
            res.n_pairs.astype(jnp.float32),
            jnp.asarray(res.maxocc, jnp.float32),
        ]),
    ])


def unpack_result(packed: "np.ndarray") -> IcpResult:
    """Host-side inverse of :func:`pack_result` (numpy in, numpy out)."""
    import numpy as np

    p = np.asarray(packed)
    return IcpResult(
        T=p[:16].reshape(4, 4),
        error=np.float32(p[16]),
        iterations=int(p[17]),
        n_pairs=int(p[18]),
        maxocc=int(p[19]),
    )


@functools.partial(jax.jit, static_argnames=("wm", "wt"))
def _window_build(
    locals_all, masks_all, mats, m_lo, m_hi, t_lo, t_hi, n_real,
    *, wm: int, wt: int,
):
    """Build ELCH loop-closure windows from the RESIDENT sequence
    tensors: model = scans [m_lo, m_hi] and target = scans [t_lo, t_hi]
    (inclusive, clipped to [0, n_real)), both transformed to the global
    frame on device.  Window sizes wm/wt are STATIC (5 and 3 in the
    reference, elch6Dslerp.cc:93-110) and the scan indices dynamic, so
    every closure of a run reuses ONE compiled executable — the round-3
    ELCH cost (52.5 s) was per-closure host padding + recompiles."""
    S, N = masks_all.shape
    pts_g = (
        jnp.einsum("sij,snj->sni", mats[:, :3, :3], locals_all)
        + mats[:, None, :3, 3]
    )
    zero = jnp.int32(0)

    def window(lo, hi, W):
        s0 = jnp.clip(lo, 0, S - W).astype(jnp.int32)
        win = jax.lax.dynamic_slice(pts_g, (s0, zero, zero), (W, N, 3))
        wmask = jax.lax.dynamic_slice(masks_all, (s0, zero), (W, N))
        sid = s0 + jnp.arange(W)
        active = (sid >= lo) & (sid <= hi) & (sid < n_real)
        return win.reshape(W * N, 3), (wmask & active[:, None]).reshape(W * N)

    model, mmask = window(m_lo, m_hi, wm)
    tgt, tmask = window(t_lo, t_hi, wt)
    return model, mmask, tgt, tmask


def icp_window_align(
    locals_all, masks_all, mats, first, last, n_real,
    max_dist_match2, epsilon,
    *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    wm: int = 5,
    wt: int = 3,
) -> IcpResult:
    """ELCH loop-closure match: metascan(first±2) as model vs
    metascan(last-2..last) as target, both already in global frames, so
    T0 = identity and the result ``T`` is the loop-closing ``align``
    (elch6D*.cc my_icp6D->match(start, end)).  Two jit calls (window
    build + the shared ICP loop), all window positions dynamic."""
    model, mmask, tgt, tmask = _window_build(
        locals_all, masks_all, mats,
        jnp.int32(first - (wm - 1) // 2), jnp.int32(first + (wm - 1) // 2),
        jnp.int32(last - (wt - 1)), jnp.int32(last),
        jnp.int32(n_real), wm=wm, wt=wt,
    )
    return _icp_loop(
        model, mmask, tgt, tmask, jnp.eye(4, dtype=jnp.float32),
        max_dist_match2=max_dist_match2, epsilon=epsilon,
        max_iterations=max_iterations, minimizer=minimizer,
    )


@functools.partial(jax.jit, static_argnames=("minimizer",))
def icp_step(model, mmask, target_local, tmask, T, max_dist_match2, *, minimizer="quat"):
    """One un-rolled ICP iteration (building block for the graft entry
    point and for schedulers that interleave steps across scan pairs)."""
    tgt_global = math3d.transform3(T, target_local).astype(jnp.float32)
    stats = _pair_statistics(
        model, mmask, tgt_global, tmask, jnp.float32(max_dist_match2)
    )
    align, err = mz.MINIMIZERS[minimizer](stats)
    ok = stats.n > 3
    align = jnp.where(ok, align, jnp.eye(4, dtype=jnp.float32))
    return align @ T, err, stats.n
