"""Batched k-nearest-neighbor search (JAX-native replacement for the
reference's ANN/kd KNN queries used by normals and feature tools;
ref include/slam6d/kdTreeImpl.h:432 _KNNSearch, src/slam6d/normals.cc).

Strategy: tiled distance matmul + jax.lax.top_k over model points.
Exact, O(Q·M); for the point counts normals run at (reduced scans,
~1e4-1e5) this is matmul-friendly and fast.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["knn_brute"]


@functools.partial(jax.jit, static_argnames=("k", "q_tile"))
def knn_brute(query, qmask, model, mmask, k: int, q_tile: int = 1024):
    """k nearest model points for each query point.

    Returns (idx [Q,k] int32, d2 [Q,k] f32), sorted ascending by
    distance.  Masked model points never appear (d2 = +inf).
    Self-matches are NOT excluded; callers querying a cloud against
    itself get the point itself as neighbor 0 (the reference includes
    it in the PCA neighborhood too).
    """
    Q = query.shape[0]
    q_tile = min(q_tile, Q)
    pad = (-Q) % q_tile
    qp = jnp.pad(query, ((0, pad), (0, 0)))
    big = jnp.float32(3.4e38)
    minf = jnp.where(mmask, 0.0, big)[None, :]
    m2 = jnp.sum(model * model, axis=1)[None, :]

    def one_tile(qt):
        cross = jnp.dot(qt, model.T, preferred_element_type=jnp.float32)
        q2 = jnp.sum(qt * qt, axis=1, keepdims=True)
        d2 = q2 + m2 - 2.0 * cross + minf
        neg, idx = jax.lax.top_k(-d2, k)
        return idx.astype(jnp.int32), -neg

    qtiles = qp.reshape(-1, q_tile, 3)
    idx, d2 = jax.lax.map(one_tile, qtiles)
    return idx.reshape(-1, k)[:Q], d2.reshape(-1, k)[:Q]
