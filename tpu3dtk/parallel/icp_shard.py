"""Multi-device ICP: target points sharded over the ``points`` mesh
axis, model replicated, pair statistics psum-merged across devices.

This is the batched re-expression of the reference's parallel ICP
(src/slam6d/icp6D.cc:129-222, after Langis/Greenspan/Godin "The Parallel
Iterative Closest Point Algorithm"): per-OpenMP-thread partial
(n, sum, centroid, Si) accumulators become per-device partials combined
with ``jax.lax.psum`` — the merge the reference does serially in
``Align_Parallel`` (icp6Dminimizer.h:61-82) rides the interconnect.

The full ``lax.while_loop`` ICP runs inside one ``shard_map``: no host
round-trips between iterations, every device ends with the identical
pose (psum-consistent), and the NN search — the FLOPs — scales linearly
in device count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..core import math3d
from ..models import minimizers as mz
from ..models.icp import IcpResult
from ..ops import nn as nn_ops

__all__ = ["icp_pair_sharded", "icp_step_batch_sharded", "shard_target"]


def shard_target(mesh, target, tmask, axis: str = "points"):
    """Place padded target points with the leading dim sharded over
    ``axis`` (pad count must divide the axis size)."""
    s = NamedSharding(mesh, P(axis, None))
    sm = NamedSharding(mesh, P(axis))
    return jax.device_put(target, s), jax.device_put(tmask, sm)


def _global_stats(model, mmask, tgt_global, tmask, max_dist2, axis):
    """Per-shard NN + partial sums, merged with psum (two tiny
    reductions: centroids first, then centered second moments)."""
    idx, d2, found = nn_ops.nn_brute_auto(
        tgt_global, tmask, model, mmask, max_dist2
    )
    m = model[idx]
    t = tgt_global
    w = found.astype(jnp.float32)
    n = jax.lax.psum(jnp.sum(w), axis)
    sm = jax.lax.psum(jnp.sum(w[:, None] * m, axis=0), axis)
    sd = jax.lax.psum(jnp.sum(w[:, None] * t, axis=0), axis)
    ns = jnp.maximum(n, 1.0)
    cm = sm / ns
    cd = sd / ns
    dm = m - cm
    dd = t - cd
    wdd = w[:, None] * dd
    S = jax.lax.psum(jnp.einsum("ni,nj->ij", wdd, dm), axis)
    Sdd = jax.lax.psum(jnp.einsum("ni,nj->ij", wdd, dd), axis)
    Smm = jax.lax.psum(jnp.einsum("ni,nj->ij", w[:, None] * dm, dm), axis)
    diff = m - t
    sum_d2 = jax.lax.psum(jnp.sum(w * jnp.sum(diff * diff, axis=1)), axis)
    return mz.PairStats(
        n=n, centroid_m=cm, centroid_d=cd, S=S, Sdd=Sdd, Smm=Smm, sum_d2=sum_d2
    )


def icp_pair_sharded(
    mesh,
    model,
    mmask,
    target_local,
    tmask,
    T0,
    *,
    max_dist_match2: float,
    epsilon: float = 1e-5,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    seed: int = 0,
    pairing: str = "closest_point",
    target_normals_local=None,
    grid_buckets: int = 0,
    grid_bucket_cap: int = 0,
    axis: str = "points",
) -> IcpResult:
    """Sharded equivalent of models.icp.icp_pair, same feature surface
    (all minimizers, pairing modes, subsampling, hashed cell-list NN).

    model/mmask replicated; target_local/tmask (and normals) sharded on
    ``axis``.  The full while_loop runs inside one shard_map — pair
    statistics psum every iteration, no host round-trips; every device
    ends with the identical pose.  Target length must divide the axis
    size (pad first).
    """
    have_normals = target_normals_local is not None
    # the hash is built in a SEPARATE jit on the replicated model and
    # enters the shard_map body as a parameter — built inline it would
    # put the candidate gather on XLA's serial path (the measured
    # ~10,000x slowdown documented at models.icp._build_grid_inline)
    grid = None
    occ = None
    if grid_buckets > 0 and pairing != "along_normal":
        from ..models.icp import build_match_grid

        grid, occ = build_match_grid(
            jnp.asarray(model, jnp.float32), jnp.asarray(mmask),
            jnp.float32(max_dist_match2), n_buckets=int(grid_buckets),
        )
    fn = _sharded_icp_fn(
        mesh,
        axis,
        float(max_dist_match2),
        float(epsilon),
        int(max_iterations),
        minimizer,
        int(subsample),
        int(seed),
        pairing,
        have_normals,
        grid is not None,
        int(grid_bucket_cap),
    )
    if not have_normals:
        # dummy sharded arg keeps one code path
        target_normals_local = jnp.zeros_like(jnp.asarray(target_local))
    if grid is None:
        from ..ops.nn import CellHash

        grid = CellHash(
            points=jnp.zeros((1, 3), jnp.float32),
            src_idx=jnp.zeros((1,), jnp.int32),
            bucket_start=jnp.zeros((2,), jnp.int32),
            origin=jnp.zeros((3,), jnp.float32),
            cell=jnp.float32(1.0),
        )
    res = fn(
        jnp.asarray(model, jnp.float32),
        jnp.asarray(mmask),
        jnp.asarray(target_local, jnp.float32),
        jnp.asarray(tmask),
        jnp.asarray(T0, jnp.float32),
        jnp.asarray(target_normals_local, jnp.float32),
        grid,
    )
    if occ is not None:
        res = res._replace(maxocc=occ)
    return res


@functools.lru_cache(maxsize=64)
def _sharded_icp_fn(
    mesh,
    axis,
    max_dist_match2,
    epsilon,
    max_iterations,
    minimizer,
    subsample,
    seed,
    pairing,
    have_normals,
    have_grid,
    grid_bucket_cap,
):
    """Build + cache the jitted shard_map ICP for one static config, so
    repeated matches reuse the XLA compile cache.  The cell hash (when
    used) arrives as a replicated PARAMETER — see icp_pair_sharded."""
    from ..models.icp import _icp_pair_impl
    from ..ops.nn import CellHash

    def shard_fn(model, mmask, tgt, tmsk, T0, normals, grid):
        return _icp_pair_impl(
            model, mmask, tgt, tmsk, T0,
            max_dist_match2=max_dist_match2,
            epsilon=epsilon,
            max_iterations=max_iterations,
            minimizer=minimizer,
            subsample=subsample,
            seed=seed,
            pairing=pairing,
            target_normals_local=normals if have_normals else None,
            grid=grid if have_grid else None,
            grid_bucket_cap=grid_bucket_cap,
            axis_name=axis,
        )

    grid_spec = CellHash(
        points=P(), src_idx=P(), bucket_start=P(), origin=P(), cell=P()
    )
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis, None), P(axis), P(), P(axis, None),
            grid_spec,
        ),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def icp_step_batch_sharded(
    mesh,
    models,
    mmasks,
    targets,
    tmasks,
    Ts,
    *,
    max_dist_match2: float,
    minimizer: str = "quat",
):
    """One ICP iteration over a *batch* of scan pairs on a 2-D mesh:

    - ``scans`` axis: scan pairs data-parallel (independent problems)
    - ``points`` axis: each pair's target points sharded; pair partials
      psum over ``points`` only.

    models: [B, M, 3] (replicated over points), targets: [B, N, 3]
    (sharded over points), Ts: [B, 4, 4].  B must divide the scans axis,
    N the points axis.  This is the full multi-chip registration step
    the driver dry-runs.
    """
    align_fn = mz.MINIMIZERS[minimizer]
    md2 = jnp.float32(max_dist_match2)

    def one_pair(model, mmask, tgt, tmsk, T):
        tgt_global = math3d.transform3(T, tgt).astype(jnp.float32)
        stats = _global_stats(model, mmask, tgt_global, tmsk, md2, "points")
        enough = stats.n > 3
        align, err = align_fn(stats)
        align = jnp.where(enough, align, jnp.eye(4, dtype=jnp.float32))
        return align @ T, err, stats.n

    def shard_fn(models, mmasks, targets, tmasks, Ts):
        return jax.vmap(one_pair)(models, mmasks, targets, tmasks, Ts)

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P("scans", None, None),
            P("scans", None),
            P("scans", "points", None),
            P("scans", "points"),
            P("scans", None, None),
        ),
        out_specs=(P("scans", None, None), P("scans"), P("scans")),
        check_vma=False,
    )
    return jax.jit(fn)(
        jnp.asarray(models, jnp.float32),
        jnp.asarray(mmasks),
        jnp.asarray(targets, jnp.float32),
        jnp.asarray(tmasks),
        jnp.asarray(Ts, jnp.float32),
    )


def icp_pair_seq_sharded(
    mesh,
    locals_all, masks_all, normals_all, mats,
    lo, hi, tgt_idx, T0,
    max_dist_match2, epsilon, seed,
    *,
    max_iterations: int = 50,
    minimizer: str = "quat",
    subsample: int = 1,
    pairing: str = "closest_point",
    has_normals: bool = False,
    grid_buckets: int = 0,
    grid_bucket_cap: int = 0,
    axis: str = "points",
    window_cap: int = 0,
) -> IcpResult:
    """Sequence-resident sharded match (models.icp.icp_pair_seq under
    shard_map): sequence tensors replicated, each device takes its
    1/n_dev slice of the target scan, pair stats psum across devices every
    iteration.  N must be divisible by the axis size.  ``window_cap``
    bounds the model window exactly as in icp_pair_seq (without it a
    non-metascan match would pay the full-sequence O(S*N) model)."""
    from ..models.icp import _icp_pair_seq_impl

    n_dev = mesh.devices.size
    fn = _seq_sharded_fn(
        mesh, axis, int(max_iterations), minimizer, int(subsample),
        pairing, bool(has_normals), int(grid_buckets),
        int(grid_bucket_cap), n_dev, int(window_cap),
    )
    return fn(
        jnp.asarray(locals_all, jnp.float32),
        jnp.asarray(masks_all),
        jnp.asarray(normals_all, jnp.float32),
        jnp.asarray(mats, jnp.float32),
        jnp.int32(lo), jnp.int32(hi), jnp.int32(tgt_idx),
        jnp.asarray(T0, jnp.float32),
        jnp.float32(max_dist_match2), jnp.float32(epsilon),
        jnp.int32(seed),
    )


@functools.lru_cache(maxsize=64)
def _seq_sharded_fn(mesh, axis, max_iterations, minimizer, subsample,
                    pairing, has_normals, grid_buckets, grid_bucket_cap,
                    n_dev, window_cap=0):
    from ..models.icp import _icp_pair_seq_impl

    def shard_fn(lp, mk, nm, mt, lo, hi, ti, T0, md2, eps, seed):
        return _icp_pair_seq_impl(
            lp, mk, nm, mt, lo, hi, ti, T0, md2, eps, seed,
            max_iterations=max_iterations, minimizer=minimizer,
            subsample=subsample, pairing=pairing,
            has_normals=has_normals, grid_buckets=grid_buckets,
            grid_bucket_cap=grid_bucket_cap,
            axis_name=axis, n_shards=n_dev, window_cap=window_cap,
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(),) * 11,
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)
