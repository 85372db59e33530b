"""Device-mesh helpers.

The reference is single-node (SURVEY §2.8: OpenMP threads + an optional
shared-memory daemon; no distributed backend).  This layer introduces
the missing axis: JAX meshes with named axes

- ``points``: correspondence batches sharded across devices; ICP pair
  partials are psum-merged across devices (the batched re-expression of the
  OpenMP parallel-ICP reduction, icp6D.cc:129-222).
- ``scans``:  independent scan pairs / graph links data-parallel across
  devices (used by GraphSLAM covariance assembly and block matching).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "default_points_mesh", "P", "NamedSharding", "Mesh"]


def make_mesh(
    n_devices: int | None = None,
    axes: tuple[str, ...] = ("points",),
    shape: tuple[int, ...] | None = None,
) -> Mesh:
    """Build a mesh over available devices.

    Default: 1-D mesh over all devices with a single ``points`` axis.
    shape lets callers split devices over (scans, points) for 2-D
    sharding (scan-pair data parallel x point-shard parallel).
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axes)


_DEFAULT_MESH: list = []


def default_points_mesh() -> Mesh | None:
    """The mesh drivers pick up automatically: a 1-D ``points`` mesh over
    all local devices when more than one is present, else None (single
    chip — plain jit is faster than a 1-device shard_map).  Cached; the
    device set is fixed per process."""
    if not _DEFAULT_MESH:
        devs = jax.devices()
        _DEFAULT_MESH.append(
            make_mesh(axes=("points",)) if len(devs) > 1 else None
        )
    return _DEFAULT_MESH[0]
