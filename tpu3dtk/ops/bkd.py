"""Bkd forest — dynamic (insert/remove) nearest-neighbor index, the
JAX-native ``BkdTree`` (ref include/slam6d/bkd.h:47-135: a forest of
logarithmically-sized kd-trees; inserts land in a small buffer, full
levels merge upward — amortized O(log n) rebuild instead of a full
re-index per insert).

Batched re-design: the per-level structure is not a pointer kd-tree but a
device-resident point block searched by the batched exact kernels
(ops.nn brute); removal is a tombstone mask (the reference swaps
the point out of its leaf array — same effect, bkd.h:67-75).  Queries
scan the O(log n) levels and merge, so dynamic workloads (streaming
SLAM, collision sweeps) keep exact NN without ever rebuilding the
whole index.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BkdForest"]


class _Block:
    def __init__(self, pts: np.ndarray):
        import jax.numpy as jnp

        self.pts_np = np.asarray(pts, np.float32)
        self.alive = np.ones(len(self.pts_np), bool)
        self.pts_dev = jnp.asarray(self.pts_np)
        self._mask_dev = None  # refreshed lazily after removals
        self._mask_dirty = True

    @property
    def mask_dev(self):
        import jax.numpy as jnp

        if self._mask_dirty:
            self._mask_dev = jnp.asarray(self.alive)
            self._mask_dirty = False
        return self._mask_dev

    def n_alive(self) -> int:
        return int(self.alive.sum())


class BkdForest:
    """Insert/remove-able exact NN index over a forest of point blocks.

    ``buffer_size``: level-0 capacity; level k holds up to
    buffer_size * 2**k points (one block per level, bkd.h forest
    invariant).  All queries are exact over alive points.
    """

    def __init__(self, points=None, buffer_size: int = 4096):
        self.buffer_size = int(buffer_size)
        self._buffer: list[np.ndarray] = []
        self._levels: dict[int, _Block] = {}
        if points is not None and len(points):
            self.insert(points)

    # -- dynamic interface (bkd.h insert/remove) -----------------------
    def insert(self, pts) -> None:
        pts = np.atleast_2d(np.asarray(pts, np.float32))
        self._buffer.extend(pts)
        if len(self._buffer) >= self.buffer_size:
            self._flush()

    def remove(self, pt, tol: float = 1e-6) -> int:
        """Tombstone every alive point equal to ``pt`` (within tol).
        Returns the number removed (bkd.h remove contract)."""
        pt = np.asarray(pt, np.float32)
        removed = 0
        kept = []
        for b in self._buffer:
            if np.all(np.abs(b - pt) <= tol):
                removed += 1
            else:
                kept.append(b)
        self._buffer = kept
        for blk in self._levels.values():
            hit = blk.alive & np.all(
                np.abs(blk.pts_np - pt) <= tol, axis=1
            )
            n = int(hit.sum())
            if n:
                blk.alive[hit] = False
                blk._mask_dirty = True
                removed += n
        return removed

    def _flush(self) -> None:
        """Merge the buffer upward: find the first free level whose
        capacity holds the union of the buffer and all lower levels
        (mergeTreesLogarithmic, bkd.h:135)."""
        chunks = [np.asarray(self._buffer, np.float32).reshape(-1, 3)]
        self._buffer = []
        total = len(chunks[0])
        level = 0
        while True:
            blk = self._levels.pop(level, None)
            if blk is not None:
                alive = blk.pts_np[blk.alive]
                chunks.append(alive)
                total += len(alive)
            if total <= self.buffer_size * (2**level) and level not in self._levels:
                break
            level += 1
        merged = np.concatenate([c for c in chunks if len(c)], axis=0)
        if len(merged):
            self._levels[level] = _Block(merged)

    # -- queries (SearchTree interface) --------------------------------
    def _parts(self):
        parts = list(self._levels.values())
        if self._buffer:
            parts.append(_Block(np.asarray(self._buffer).reshape(-1, 3)))
        return [p for p in parts if p.n_alive()]

    def size(self) -> int:
        return len(self._buffer) + sum(
            b.n_alive() for b in self._levels.values()
        )

    def collect_pts(self) -> np.ndarray:
        parts = [np.asarray(self._buffer).reshape(-1, 3)] if self._buffer else []
        parts += [b.pts_np[b.alive] for b in self._levels.values()]
        if not parts:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(parts, axis=0)

    def find_closest(self, query, qmask, max_dist2):
        """Batched FindClosest over the forest: exact NN per level,
        merged by min distance.  Returns (points [Q,3], d2 [Q],
        found [Q]) — the matched coordinates, since block-local indices
        are not stable across merges (the reference returns double*)."""
        import jax.numpy as jnp

        from .nn import nn_brute_auto

        query = jnp.asarray(query, jnp.float32)
        qmask = jnp.asarray(qmask)
        Q = query.shape[0]
        best_d2 = np.full(Q, np.float32(3.4e38))
        best_pt = np.zeros((Q, 3), np.float32)
        found_any = np.zeros(Q, bool)
        for blk in self._parts():
            idx, d2, found = nn_brute_auto(
                query, qmask, blk.pts_dev, blk.mask_dev,
                jnp.float32(max_dist2),
            )
            idx = np.asarray(idx)
            d2 = np.asarray(d2)
            found = np.asarray(found)
            better = found & (d2 < best_d2)
            best_d2 = np.where(better, d2, best_d2)
            best_pt = np.where(better[:, None], blk.pts_np[idx], best_pt)
            found_any |= better
        return best_pt, np.where(found_any, best_d2, np.inf), found_any

    def fixed_range_search(self, query, qmask, max_dist2, K: int = 64):
        """All alive points within radius per query, merged across
        levels.  Returns (points [Q, K, 3], d2 [Q, K], found [Q, K],
        count [Q]); exact iff every count < K."""
        import jax.numpy as jnp

        from .search import fixed_range_search

        query = jnp.asarray(query, jnp.float32)
        qmask = jnp.asarray(qmask)
        Q = query.shape[0]
        all_pts = []
        all_d2 = []
        all_found = []
        for blk in self._parts():
            idx, d2, found, _cnt = fixed_range_search(
                query, qmask, blk.pts_dev, blk.mask_dev,
                jnp.float32(max_dist2), K=K,
            )
            all_pts.append(blk.pts_np[np.asarray(idx)])
            all_d2.append(np.asarray(d2))
            all_found.append(np.asarray(found))
        if not all_pts:
            return (
                np.zeros((Q, K, 3), np.float32),
                np.full((Q, K), np.inf, np.float32),
                np.zeros((Q, K), bool),
                np.zeros(Q, np.int32),
            )
        pts = np.concatenate(all_pts, axis=1)
        d2 = np.concatenate(all_d2, axis=1)
        found = np.concatenate(all_found, axis=1)
        d2m = np.where(found, d2, np.inf)
        order = np.argsort(d2m, axis=1)[:, :K]
        take = lambda a: np.take_along_axis(a, order[..., None] if a.ndim == 3 else order, axis=1)  # noqa: E731
        return (
            take(pts), take(d2m).astype(np.float32), take(found),
            found.sum(axis=1).astype(np.int32),
        )
