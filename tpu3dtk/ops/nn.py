"""Nearest-neighbor correspondence search — the centerpiece kernel.

Replaces the reference's pointer-chasing kd-tree
(``KDTreeImpl::_FindClosest``, include/slam6d/kdTreeImpl.h:345-389 — the
hottest loop of the whole toolkit per SURVEY §3) with dense, batched
search:

- :func:`nn_brute`: tiled brute force, d²(q, m) = Σ(q−m)² fused into
  the argmin per query tile.  Exact; the CPU engine.  On a GPU,
  :func:`nn_brute_auto` runs the fused kernel
  ops.nn_triton.nn_brute_triton with the same contract.
- :func:`nn_grid`: uniform-grid bucketed search (the analog of the
  reference's CUDA grid NN, src/cuda/grid_kernel.cu:314-420): model
  points are bucketed into cells of edge ``max_dist``, queries scan the
  27 neighboring buckets only.  O(Q·27·B) instead of O(Q·M).
- :func:`nn_cell_hash`: the same 27-cell search over a hashed bucket
  table — the sublinear engine for large model windows.

Which engine a driver runs: brute below :data:`GRID_MIN_POINTS` model
points, the hashed cell list at or above it (when its buckets stay
within :data:`GRID_MAX_CAP`).

Semantics shared with the reference kd-tree: a match is accepted only if
d² is strictly below ``max_dist2`` (ref kd params: closest_d2 initialised
to maxdist2, accepted when d2 < closest_d2; boundary exclusion is tested
in testing/kdtree/kdtree.cc:20-27).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "nn_brute",
    "nn_brute_auto",
    "nn_brute_line",
    "nn_grid",
    "GridIndex",
    "build_grid",
    "CellHash",
    "build_cell_hash",
    "cell_hash_spec",
    "cell_hash_max_occupancy",
    "nn_cell_hash",
]


# Model points (per match window, or per scan for LUM links) from which
# the drivers switch from brute NN to the hashed cell list: the in-loop
# crossover at the city radius, measured on an H100.  Smaller windows
# stay on brute even where the hash wins in the loop, because the
# pipeline leaves its device-resident segments and LUM correspondence
# cache on the hash route (docs/PERF.md, "Crossover").
GRID_MIN_POINTS = 32768
# Largest hash bucket occupancy for which the cell list is used; denser
# clouds stay on brute NN.
GRID_MAX_CAP = 768


def nn_brute_auto(query, qmask, model, mmask, max_dist2):
    """Exact brute NN with the contract of :func:`nn_brute`: the fused
    Triton kernel (ops.nn_triton) on a GPU, :func:`nn_brute` elsewhere."""
    if jax.default_backend() == "gpu":
        from .nn_triton import nn_brute_triton

        return nn_brute_triton(query, qmask, model, mmask, max_dist2)
    return nn_brute(query, qmask, model, mmask, max_dist2)


def _pairwise_d2(q, m):
    """[Q,3],[M,3] -> [Q,M] squared distances via a matmul.

    precision=HIGHEST is load-bearing: a reduced-precision product
    (bf16 or TF32, ~3 decimal digits) corrupts d² at cm-scale extents
    (±500 cm centered ⇒ errors of order 10³ cm², beyond the 625 cm²
    match gate) and mis-ranks neighbours."""
    cross = jnp.dot(
        q, m.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    q2 = jnp.sum(q * q, axis=1, keepdims=True)
    m2 = jnp.sum(m * m, axis=1, keepdims=True).T
    return q2 + m2 - 2.0 * cross


@functools.partial(jax.jit, static_argnames=("q_tile",))
def nn_brute(query, qmask, model, mmask, max_dist2, q_tile: int = 2048):
    """Exact NN of each query point among masked model points.

    query: [Q,3] f32; model: [M,3] f32; masks bool.
    Returns (idx [Q] int32, d2 [Q] f32, found [Q] bool) where found
    requires d2 < max_dist2 (strict, matching the reference boundary
    semantics) and both masks.

    Ranking uses direct differences Σ(q−m)², like the GPU kernel
    (ops.nn_triton): the matmul expansion |q|²+|m|²−2q·m cancels in f32
    (error ~ eps·|coord|², several cm² at 50 m extents) and would
    mis-rank near-ties.  XLA fuses the differences into the argmin, so
    no [tile, M] distance array is written.
    """
    Q = query.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    qp = jnp.pad(query, ((0, pad), (0, 0)))
    big = jnp.float32(3.4e38)

    def one_tile(qt):
        d2 = jnp.sum((qt[:, None, :] - model[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(mmask[None, :], d2, big)
        return jnp.argmin(d2, axis=1).astype(jnp.int32)

    qtiles = qp.reshape(-1, q_tile, 3)
    idx = jax.lax.map(one_tile, qtiles).reshape(-1)[:Q]
    diff = query - model[idx]
    best = jnp.sum(diff * diff, axis=1)
    best = jnp.where(mmask[idx], best, big)
    found = qmask & (best < max_dist2)
    return idx, best, found


@functools.partial(jax.jit, static_argnames=("q_tile",))
def nn_brute_line(query, qdir, qmask, model, mmask, max_dist2, q_tile: int = 1024):
    """Closest model point to the *line* through each query along its
    (unit) direction — the reference's ``FindClosestAlongDir`` metric
    d² = |p−x|² − ((p−x)·dir)² (kdTreeImpl.h:390-405), used by
    normal-shooting pairing (searchTree.cc:133-141).

    query: [Q,3]; qdir: [Q,3] unit directions.  Strict acceptance at
    max_dist2 like nn_brute.

    Precision: the line metric is translation-invariant, so coordinates
    are centered on the model's masked mean before the matmul expansion
    (which cancels in f32 at large extents, error ~ eps·|coord|²) and
    the winning candidate's distance is recomputed exactly by direct
    subtraction — ranking and the accept test carry full f32 accuracy
    on large-extent clouds.
    """
    Q = query.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    center = jnp.sum(
        jnp.where(mmask[:, None], model, 0.0), axis=0
    ) / jnp.maximum(jnp.sum(mmask), 1)
    qp = jnp.pad(query, ((0, pad), (0, 0))) - center
    dp = jnp.pad(qdir, ((0, pad), (0, 0)))
    mc = model - center
    big = jnp.float32(3.4e38)
    minf = jnp.where(mmask, 0.0, big)[None, :]
    m2 = jnp.sum(mc * mc, axis=1)[None, :]

    def one_tile(args):
        qt, dt = args
        cross = jnp.dot(
            qt, mc.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        q2 = jnp.sum(qt * qt, axis=1, keepdims=True)
        d2 = q2 + m2 - 2.0 * cross
        # projection: ((q - m)·dir)² = (q·dir - m·dir)²
        qd = jnp.sum(qt * dt, axis=1, keepdims=True)
        md = jnp.dot(
            dt, mc.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        proj = qd - md
        d2l = d2 - proj * proj + minf
        idx = jnp.argmin(d2l, axis=1).astype(jnp.int32)
        return idx

    qtiles = qp.reshape(-1, q_tile, 3)
    dtiles = dp.reshape(-1, q_tile, 3)
    idx = jax.lax.map(one_tile, (qtiles, dtiles))
    idx = idx.reshape(-1)[:Q]
    # exact recompute of the winner's line distance by direct subtraction
    diff = model[idx] - query
    proj = jnp.sum(diff * qdir, axis=1)
    best = jnp.sum(diff * diff, axis=1) - proj * proj
    best = jnp.where(mmask[idx], best, big)
    found = qmask & (best < max_dist2)
    return idx, best, found


# ---------------------------------------------------------------------------
# Uniform-grid NN (analog of the reference CUDA grid, grid_kernel.cu)
# ---------------------------------------------------------------------------

from typing import NamedTuple


class GridIndex(NamedTuple):
    """Bucketed model points: sorted copies + per-cell CSR offsets."""

    points: jnp.ndarray  # [M, 3] sorted by cell id
    src_idx: jnp.ndarray  # [M] original index of each sorted point
    cell_of: jnp.ndarray  # [M] cell id of each sorted point
    cell_start: jnp.ndarray  # [C+1] CSR offsets into points
    origin: jnp.ndarray  # [3]
    dims: tuple[int, int, int]  # static grid dims
    cell: jnp.ndarray  # scalar cell edge


def _cell_id(ij, dims):
    nx, ny, nz = dims
    return (ij[..., 0] * ny + ij[..., 1]) * nz + ij[..., 2]


@functools.partial(jax.jit, static_argnames=("dims",))
def build_grid(model, mmask, origin, cell, dims) -> GridIndex:
    """Sort model points by cell id and build CSR offsets.

    dims must be static (host computes from the bounding box / cell).
    Masked points land in the last cell (excluded from search since the
    query clamp keeps neighbors in-range only via the offset table).
    """
    nx, ny, nz = dims
    C = nx * ny * nz
    ij = jnp.floor((model - origin) / cell).astype(jnp.int32)
    ij = jnp.clip(ij, 0, jnp.array([nx - 1, ny - 1, nz - 1]))
    cid = _cell_id(ij, dims)
    cid = jnp.where(mmask, cid, C)  # masked -> sentinel cell C
    order = jnp.argsort(cid)
    cid_s = cid[order]
    pts_s = model[order]
    # CSR: cell_start[c] = first sorted position with cell id >= c
    cell_start = jnp.searchsorted(cid_s, jnp.arange(C + 1))
    return GridIndex(
        points=pts_s,
        src_idx=order.astype(jnp.int32),
        cell_of=cid_s,
        cell_start=cell_start,
        origin=origin,
        dims=dims,
        cell=cell,
    )


@functools.partial(jax.jit, static_argnames=("dims", "bucket_cap"))
def nn_grid(
    query,
    qmask,
    grid: GridIndex,
    max_dist2,
    dims,
    bucket_cap: int = 32,
):
    """Grid NN: for each query, gather up to ``bucket_cap`` candidates
    from each of the 27 neighboring cells and take the arg-min.

    Exact iff every cell holds <= bucket_cap model points (cell edge =
    max_dist guarantees all true neighbors are inside the 27 cells, the
    same argument as the reference CUDA kernel_FindNN 27-bucket search).
    Callers should size bucket_cap from the true max occupancy (host-side
    after build_grid) to keep exactness.
    """
    nx, ny, nz = dims
    qij = jnp.floor((query - grid.origin) / grid.cell).astype(jnp.int32)
    qij = jnp.clip(qij, 0, jnp.array([nx - 1, ny - 1, nz - 1]))

    # [27, 3] neighbor offsets
    off = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(27, 3)
    nij = qij[:, None, :] + off[None, :, :]  # [Q, 27, 3]
    inb = jnp.all((nij >= 0) & (nij < jnp.array([nx, ny, nz])), axis=-1)
    nid = _cell_id(jnp.clip(nij, 0, jnp.array([nx - 1, ny - 1, nz - 1])), dims)
    start = grid.cell_start[nid]  # [Q, 27]
    end = grid.cell_start[nid + 1]
    # candidate sorted-array positions: start + k, k < bucket_cap
    k = jnp.arange(bucket_cap)
    pos = start[..., None] + k  # [Q, 27, B]
    valid = inb[..., None] & (pos < end[..., None])
    M = grid.points.shape[0]
    pos_c = jnp.clip(pos, 0, M - 1).reshape(query.shape[0], -1)
    valid = valid.reshape(query.shape[0], -1)
    cand = grid.points[pos_c]  # [Q, 27B, 3]
    diff = cand - query[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid, d2, jnp.float32(3.4e38))
    best = jnp.argmin(d2, axis=1)
    bestd = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
    sorted_idx = jnp.take_along_axis(pos_c, best[:, None], axis=1)[:, 0]
    idx = grid.src_idx[sorted_idx]
    found = qmask & (bestd < max_dist2)
    return idx, bestd, found


# ---------------------------------------------------------------------------
# Hashed cell list — the production sublinear NN for the ICP/LUM hot loops
# ---------------------------------------------------------------------------
#
# Batched re-design of the reference's two NN engines: the kd-tree
# recursion (include/slam6d/kdTreeImpl.h:345-389) and the CUDA uniform
# grid (src/cuda/grid_kernel.cu:314-420, 27-neighbor-bucket search).
# Pointer chasing and per-point recursion don't batch; a dense [nx,ny,nz]
# grid blows memory on city-scale extents (bremen: ~2000^3 cells).  The
# hashed cell list keeps the 27-cell argument — cell edge = max_dist, so
# every true neighbor within the radius lies in the 3x3x3 ring — but maps
# cell coordinates through an open spatial hash into a fixed power-of-two
# bucket table.  Hash collisions only ever ADD candidates (two far-apart
# cells sharing a bucket), never drop them, so the search stays exact as
# long as ``bucket_cap`` covers the fullest bucket (host: cell_hash_spec;
# device check: cell_hash_max_occupancy).
#
# Everything is static-shaped and jit-compatible: build = one argsort +
# gathers, query = [q_tile, 27*bucket_cap] gathers + masked argmin under
# lax.map.  Per-iteration cost is O(Q * 27 * bucket_cap), independent of
# model size M — the sublinearity the kd-tree provides on CPU.


class CellHash(NamedTuple):
    """Model points bucketed by spatial hash (device-resident, traceable).

    The bucket count is static via ``bucket_start.shape[0] - 1`` (a power
    of two); ``bucket_cap`` is passed separately at query time.
    """

    points: jnp.ndarray  # [M, 3] sorted by hash bucket
    src_idx: jnp.ndarray  # [M] original index of each sorted point
    bucket_start: jnp.ndarray  # [H+1] CSR offsets (masked points at end)
    origin: jnp.ndarray  # [3]
    cell: jnp.ndarray  # scalar cell edge (= search radius)


def _hash3(ij, n_buckets):
    """Open spatial hash of integer cell coords: Teschner et al. 2003
    prime products followed by a murmur3-style avalanche, so the masked
    low bits are decorrelated (the raw prime XOR collides structurally
    for small coordinate ranges).  uint32 wraparound semantics."""
    ij = ij.astype(jnp.uint32)
    h = (
        ij[..., 0] * jnp.uint32(73856093)
        ^ ij[..., 1] * jnp.uint32(19349663)
        ^ ij[..., 2] * jnp.uint32(83492791)
    )
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h & jnp.uint32(n_buckets - 1)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_buckets",))
def build_cell_hash(points, mask, origin, cell, n_buckets: int) -> CellHash:
    """Sort points by hash bucket and build CSR offsets.  Masked points
    sort to a sentinel past the last bucket and are never candidates."""
    H = n_buckets
    ij = jnp.floor((points - origin) / cell).astype(jnp.int32)
    h = jnp.where(mask, _hash3(ij, H), jnp.int32(H))
    order = jnp.argsort(h)
    h_s = h[order]
    bucket_start = jnp.searchsorted(h_s, jnp.arange(H + 1)).astype(jnp.int32)
    return CellHash(
        points=points[order],
        src_idx=order.astype(jnp.int32),
        bucket_start=bucket_start,
        origin=origin,
        cell=cell,
    )


def cell_hash_max_occupancy(grid: CellHash) -> jnp.ndarray:
    """Fullest bucket (device scalar) — exactness requires
    ``bucket_cap >= cell_hash_max_occupancy(grid)``."""
    return jnp.max(grid.bucket_start[1:] - grid.bucket_start[:-1])


def cell_hash_spec(points, mask, max_dist, target_load=0.5, min_buckets=1024):
    """Host-side sizing: choose (n_buckets, bucket_cap) for a point set.

    n_buckets = power of two >= n_valid / target_load; bucket_cap = max
    actual occupancy rounded up to a multiple of 8 (bounds recompiles).
    Returns (n_buckets, bucket_cap).  numpy in, python ints out.
    """
    import numpy as np

    pts = np.asarray(points)
    msk = np.asarray(mask)
    valid = pts[msk]
    n = max(1, len(valid))
    H = min_buckets
    while H < n / target_load:
        H *= 2
    origin = valid.min(axis=0) if len(valid) else np.zeros(3)
    ij = (
        np.floor((valid - origin) / max(max_dist, 1e-6))
        .astype(np.int64)
        .astype(np.uint32)
    )
    # must mirror _hash3 exactly (uint32 wraparound + avalanche)
    with np.errstate(over="ignore"):
        h = (
            ij[:, 0] * np.uint32(73856093)
            ^ ij[:, 1] * np.uint32(19349663)
            ^ ij[:, 2] * np.uint32(83492791)
        )
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    h = (h & np.uint32(H - 1)).astype(np.int64)
    occ = int(np.bincount(h, minlength=H).max()) if len(valid) else 1
    cap = ((occ + 7) // 8) * 8
    return H, max(cap, 8)


@functools.partial(
    jax.jit, static_argnames=("bucket_cap", "q_tile")
)
def nn_cell_hash(
    query, qmask, grid: CellHash, max_dist2, bucket_cap: int, q_tile: int = 2048
):
    """Exact NN within radius sqrt(max_dist2) through the hashed cell
    list.  Same return contract and strict-boundary semantics as
    :func:`nn_brute` (ref testing/kdtree/kdtree.cc:20-27).

    Exact iff bucket_cap >= the fullest bucket (see cell_hash_spec);
    distances are computed by direct subtraction on gathered candidates,
    so there is no catastrophic-cancellation concern.
    """
    Q = query.shape[0]
    H = grid.bucket_start.shape[0] - 1
    M = grid.points.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    qp = jnp.pad(query, ((0, pad), (0, 0)))
    big = jnp.float32(3.4e38)
    off = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(27, 3)
    karange = jnp.arange(bucket_cap, dtype=jnp.int32)

    def one_tile(qt):
        T = qt.shape[0]
        qij = jnp.floor((qt - grid.origin) / grid.cell).astype(jnp.int32)
        nij = qij[:, None, :] + off[None, :, :]  # [T,27,3]
        hb = _hash3(nij, H)  # [T,27]
        start = grid.bucket_start[hb]
        end = grid.bucket_start[hb + 1]
        pos = start[..., None] + karange  # [T,27,B]
        valid = (pos < end[..., None]).reshape(T, -1)
        pos_c = jnp.clip(pos, 0, M - 1).reshape(T, -1)
        cand = grid.points[pos_c]  # [T,27B,3]
        diff = cand - qt[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(valid, d2, big)
        best = jnp.argmin(d2, axis=1).astype(jnp.int32)
        bestd = jnp.take_along_axis(d2, best[:, None].astype(jnp.int64), axis=1)[:, 0]
        sidx = jnp.take_along_axis(pos_c, best[:, None].astype(jnp.int64), axis=1)[:, 0]
        return grid.src_idx[sidx], bestd

    qtiles = qp.reshape(-1, q_tile, 3)
    idx, bestd = jax.lax.map(one_tile, qtiles)
    idx = idx.reshape(-1)[:Q]
    bestd = bestd.reshape(-1)[:Q]
    found = qmask & (bestd < max_dist2)
    return idx, bestd, found
