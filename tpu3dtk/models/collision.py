"""Collision detection — model geometry moved along a trajectory vs an
environment cloud (ref src/collision/collision_model.cc: per trajectory
pose, count environment points within a collision radius of the moved
model; kd-tree or CUDA grid backend; SURVEY §2.6).

Batched design: a batched job — poses [P, 4, 4] x model [M, 3] against the
environment via the same NN machinery; for each pose the model is
transformed and every model point's nearest environment distance is
thresholded.  vmap over poses, lax.map chunks to bound memory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CollisionParams", "detect_collisions"]


@dataclasses.dataclass
class CollisionParams:
    radius: float = 10.0  # collision distance (cm)
    chunk: int = 4  # poses processed at once


def detect_collisions(
    environment: np.ndarray,
    model: np.ndarray,
    poses: np.ndarray,
    params: CollisionParams | None = None,
):
    """Returns (colliding [P] bool, n_hits [P] int32): per pose, how
    many model points lie within ``radius`` of the environment."""
    import jax
    import jax.numpy as jnp

    from ..core import math3d
    from ..ops import nn as nn_ops

    params = params or CollisionParams()
    env = jnp.asarray(environment, jnp.float32)
    emask = jnp.ones(len(environment), bool)
    mdl = jnp.asarray(model, jnp.float32)
    mmask = jnp.ones(len(model), bool)
    poses_j = jnp.asarray(poses, jnp.float32)
    r2 = jnp.float32(params.radius**2)

    def one(T):
        moved = math3d.transform3(T, mdl).astype(jnp.float32)
        _, d2, found = nn_ops.nn_brute(moved, mmask, env, emask, r2)
        return jnp.sum(found.astype(jnp.int32))

    hits = jax.lax.map(one, poses_j, batch_size=params.chunk)
    return np.asarray(hits) > 0, np.asarray(hits)


def sweep_collisions(
    environment: np.ndarray,
    trajectory: np.ndarray,
    radius: float,
):
    """Swept-path collision: environment points within ``radius`` of ANY
    segment of the trajectory polyline (the reference's kd segment
    search used by collision sweeps, kdTreeImpl.h segmentSearch_all).

    trajectory: [P, 3] waypoints.  Returns (mask [N] bool, n_hits int).
    """
    import jax.numpy as jnp

    from ..ops import search as search_ops

    env = jnp.asarray(environment, jnp.float32)
    emask = jnp.ones(len(environment), bool)
    r2 = jnp.float32(radius**2)
    hit = np.zeros(len(environment), bool)
    traj = np.asarray(trajectory, np.float32)
    for a, b in zip(traj[:-1], traj[1:]):
        m = search_ops.segment_search_all(
            jnp.asarray(a), jnp.asarray(b), env, emask, r2
        )
        hit |= np.asarray(m)
    return hit, int(hit.sum())
