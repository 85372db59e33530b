"""Batched range/box/segment searches — the remaining kd-tree query
surface (ref include/slam6d/kdTreeImpl.h:491-828: FixedRangeSearch,
fixedRangeSearchAlongDir, AABBSearch, segmentSearch_1NearestPoint,
segmentSearch_all), used by the shapes and collision tooling.

Batched design: every query is a dense masked reduction — distance matrices
run as matmuls (same centered-matmul precision discipline as ops.nn) and
variable-size result sets become capped [Q, K] top-k blocks + exact
counts (callers grow K and re-run when count > K; the same exactness
guard pattern as the hashed cell list's bucket_cap).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .nn import _pairwise_d2

__all__ = [
    "fixed_range_search",
    "fixed_range_search_along_dir",
    "aabb_search",
    "segment_search_1nn",
    "segment_search_all",
]

# plain python float: a module-level jnp scalar would initialize the
# XLA backend at import time (breaking jax.distributed.initialize in
# multi-host programs that import tpu3dtk first)
_BIG = 3.4e38


@functools.partial(jax.jit, static_argnames=("K", "q_tile"))
def fixed_range_search(
    query, qmask, model, mmask, max_dist2, K: int = 64, q_tile: int = 512
):
    """ALL model points within sqrt(max_dist2) of each query
    (kdTreeImpl.h FixedRangeSearch), as capped top-K blocks.

    Returns (idx [Q,K] int32, d2 [Q,K] f32, found [Q,K] bool,
    count [Q] int32).  Exact iff max(count) <= K; results are sorted by
    distance.  Strict d2 < max_dist2 (reference boundary semantics)."""
    Q = query.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    center = jnp.sum(
        jnp.where(mmask[:, None], model, 0.0), axis=0
    ) / jnp.maximum(jnp.sum(mmask), 1)
    qp = jnp.pad(query, ((0, pad), (0, 0))) - center
    mc = model - center
    minf = jnp.where(mmask, 0.0, _BIG)[None, :]

    def one_tile(qt):
        d2 = _pairwise_d2(qt, mc) + minf
        neg, idx = jax.lax.top_k(-d2, K)
        return idx.astype(jnp.int32), -neg

    idx, d2r = jax.lax.map(one_tile, qp.reshape(-1, q_tile, 3))
    idx = idx.reshape(-1, K)[:Q]
    # exact recompute of the candidates' distances (full f32 accuracy)
    diff = query[:, None, :] - model[idx]
    d2x = jnp.sum(diff * diff, axis=-1)
    d2x = jnp.where(mmask[idx], d2x, _BIG)
    found = qmask[:, None] & (d2x < max_dist2)
    # top-K keeps the K smallest distances, so count == K iff the set
    # may be truncated (caller grows K and re-runs); count < K is exact
    count = jnp.sum(found, axis=1).astype(jnp.int32)
    order = jnp.argsort(jnp.where(found, d2x, _BIG), axis=1)
    idx = jnp.take_along_axis(idx, order, axis=1)
    d2x = jnp.take_along_axis(d2x, order, axis=1)
    found = jnp.take_along_axis(found, order, axis=1)
    return idx, d2x, found, count


@functools.partial(jax.jit, static_argnames=("K", "q_tile"))
def fixed_range_search_along_dir(
    query, qdir, qmask, model, mmask, max_dist2, K: int = 64,
    q_tile: int = 512,
):
    """All model points within line distance sqrt(max_dist2) of the ray
    through each query along qdir (kdTreeImpl.h:491-536
    fixedRangeSearchAlongDir, the normal-shooting range variant).
    Same capped-K contract as :func:`fixed_range_search`."""
    Q = query.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    center = jnp.sum(
        jnp.where(mmask[:, None], model, 0.0), axis=0
    ) / jnp.maximum(jnp.sum(mmask), 1)
    qp = jnp.pad(query, ((0, pad), (0, 0))) - center
    dp = jnp.pad(qdir, ((0, pad), (0, 0)))
    mc = model - center
    minf = jnp.where(mmask, 0.0, _BIG)[None, :]
    m2 = jnp.sum(mc * mc, axis=1)[None, :]

    def one_tile(args):
        qt, dt = args
        cross = jnp.dot(
            qt, mc.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        q2 = jnp.sum(qt * qt, axis=1, keepdims=True)
        d2 = q2 + m2 - 2.0 * cross
        qd = jnp.sum(qt * dt, axis=1, keepdims=True)
        md = jnp.dot(
            dt, mc.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        proj = qd - md
        d2l = d2 - proj * proj + minf
        neg, idx = jax.lax.top_k(-d2l, K)
        return idx.astype(jnp.int32)

    idx = jax.lax.map(
        one_tile, (qp.reshape(-1, q_tile, 3), dp.reshape(-1, q_tile, 3))
    ).reshape(-1, K)[:Q]
    diff = model[idx] - query[:, None, :]
    proj = jnp.sum(diff * qdir[:, None, :], axis=-1)
    d2x = jnp.sum(diff * diff, axis=-1) - proj * proj
    d2x = jnp.where(mmask[idx], d2x, _BIG)
    found = qmask[:, None] & (d2x < max_dist2)
    count = jnp.sum(found, axis=1).astype(jnp.int32)
    order = jnp.argsort(jnp.where(found, d2x, _BIG), axis=1)
    return (
        jnp.take_along_axis(idx, order, axis=1),
        jnp.take_along_axis(d2x, order, axis=1),
        jnp.take_along_axis(found, order, axis=1),
        count,
    )


@jax.jit
def aabb_search(model, mmask, lo, hi):
    """Mask of model points inside the axis-aligned box [lo, hi]
    (kdTreeImpl.h:540-580 AABBSearch; inclusive bounds as in the
    reference's >= / <= tests)."""
    inside = jnp.all((model >= lo) & (model <= hi), axis=1)
    return inside & mmask


@jax.jit
def segment_search_1nn(p1, p2, model, mmask, max_dist2):
    """Closest model point to the SEGMENT p1-p2
    (kdTreeImpl.h segmentSearch_1NearestPoint): distance to the clamped
    projection.  Returns (idx, d2, found) scalars."""
    seg = p2 - p1
    L2 = jnp.maximum(jnp.sum(seg * seg), 1e-30)
    t = jnp.clip(jnp.dot(model - p1, seg) / L2, 0.0, 1.0)
    proj = p1[None, :] + t[:, None] * seg[None, :]
    diff = model - proj
    d2 = jnp.sum(diff * diff, axis=1)
    d2 = jnp.where(mmask, d2, _BIG)
    idx = jnp.argmin(d2).astype(jnp.int32)
    best = d2[idx]
    return idx, best, best < max_dist2


@jax.jit
def segment_search_all(p1, p2, model, mmask, max_dist2):
    """Mask of all model points within sqrt(max_dist2) of the segment
    (kdTreeImpl.h segmentSearch_all)."""
    seg = p2 - p1
    L2 = jnp.maximum(jnp.sum(seg * seg), 1e-30)
    t = jnp.clip(jnp.dot(model - p1, seg) / L2, 0.0, 1.0)
    proj = p1[None, :] + t[:, None] * seg[None, :]
    diff = model - proj
    d2 = jnp.sum(diff * diff, axis=1)
    return mmask & (d2 < max_dist2)
