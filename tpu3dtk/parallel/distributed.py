"""Multi-host execution skeleton — SURVEY §2.8 "Distributed
communication backend".

The reference has NO multi-node path at all (its only cross-process
channel is the scanserver's shared memory, include/scanserver/
clientInterface.h:15-84); this layer introduces a ``hosts`` mesh
dimension across the hosts' network on top of the per-host
``points``/``scans`` axes over the devices of one host.

Model:

- Every host runs the same program and calls :func:`initialize` first
  (jax.distributed handshake; coordinator = process 0).
- Scan INGEST is host-sharded: each host reads only its contiguous
  range of the sequence (:func:`host_scan_range`) — the multi-host
  replacement for the scanserver's out-of-core cache role (the cache
  budget becomes per-host RAM, see io.cache).
- Global arrays are assembled with
  ``jax.make_array_from_process_local_data`` under a mesh from
  :func:`host_device_mesh` whose leading ``hosts`` axis maps one row
  per host, so cross-host collectives (the LUM G/B psum, ICP pair-stat
  psums) cross hosts exactly once per iteration while everything else
  stays within one host.

Launch recipe (4 hosts):

    # on every host h = 0..3:
    JAX_COORDINATOR=host0:8476 NPROC=4 PROC_ID=$h python my_slam.py

    # my_slam.py
    from tpu3dtk.parallel import distributed as dist
    dist.initialize()                       # reads the env vars above
    mesh = dist.host_device_mesh(("hosts", "points"))
    lo, hi = dist.host_scan_range(n_scans)  # this host's ingest range
    ...

Single-host usage degrades gracefully: ``initialize()`` is a no-op
when NPROC is unset/1, and ``host_device_mesh`` returns a (1, n)
mesh over local devices.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = [
    "initialize",
    "is_distributed",
    "host_scan_range",
    "host_device_mesh",
    "global_scan_array",
]


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the multi-host job (jax.distributed.initialize wrapper).

    Arguments default to the env vars JAX_COORDINATOR / NPROC /
    PROC_ID.  Returns True when running distributed, False for the
    single-host no-op.  Safe to call more than once.
    """
    num_processes = num_processes or int(os.environ.get("NPROC", "1"))
    if num_processes <= 1:
        return False
    # NOTE: must not call jax.process_count() here — it would initialise
    # the XLA backend, after which jax.distributed.initialize refuses to
    # run.  The distributed client's own state is the only safe probe.
    from jax._src import distributed as _dist_state

    if _dist_state.global_state.client is not None:  # already initialized
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR", "localhost:8476"
    )
    process_id = (
        process_id
        if process_id is not None
        else int(os.environ.get("PROC_ID", "0"))
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_scan_range(n_scans: int, n_hosts: int | None = None,
                    host_id: int | None = None) -> tuple[int, int]:
    """This host's contiguous ingest range [lo, hi) of the scan
    sequence (hosts own scan ranges; the multi-host scanserver role)."""
    n_hosts = n_hosts or jax.process_count()
    host_id = host_id if host_id is not None else jax.process_index()
    per = -(-n_scans // n_hosts)
    lo = min(host_id * per, n_scans)
    return lo, min(lo + per, n_scans)


def host_device_mesh(
    axes: tuple[str, str] = ("hosts", "points"),
    devices=None,
) -> Mesh:
    """2-D mesh [n_hosts, devices_per_host]: the leading axis groups
    each host's devices in one row, so collectives over it cross hosts
    and collectives over the trailing axis stay within one host.

    With ``devices`` given (testing), the same shape logic applies to
    that flat device list using NPROC (or 1) as the host count —
    this is how the driver's virtual-CPU dryrun simulates a 2x4
    hosts-x-devices layout on one machine.
    """
    devs = list(devices) if devices is not None else jax.devices()
    n_hosts = jax.process_count()
    if devices is not None:
        n_hosts = int(os.environ.get("DRYRUN_HOSTS", "0")) or n_hosts
    if len(devs) % max(n_hosts, 1):
        n_hosts = 1
    arr = np.array(devs).reshape(max(n_hosts, 1), -1)
    return Mesh(arr, axes)


def allsum_hosts(mesh: Mesh, local_block: np.ndarray) -> np.ndarray:
    """Sum each host's contribution into a replicated array (ONE cross-host
    all-reduce).  local_block: this host's [.,...] numpy block; all
    hosts must pass the same shape.  Single-host: identity."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    if jax.process_count() == 1:
        return np.asarray(local_block)
    spec = P(mesh.axis_names[0], *([None] * local_block.ndim))
    sharding = NamedSharding(mesh, spec)
    glob = jax.make_array_from_process_local_data(
        sharding, np.asarray(local_block)[None]
    )
    out = jax.jit(
        lambda a: jnp.sum(a, axis=0),
        out_shardings=NamedSharding(mesh, P()),
    )(glob)
    return np.asarray(jax.device_get(out))


def distributed_ingest(
    directory: str,
    format: str = "uos",
    start: int = 0,
    end: int = -1,
    point_filter=None,
    reduce_voxel: float = -1.0,
    octree_n: int = 1,
    mesh: Mesh | None = None,
    pad_multiple: int = 512,
):
    """Host-sharded scan ingest (the multi-host scanserver role, SURVEY
    §2.8): each host reads + reduces ONLY its contiguous range of the
    sequence, then the reduced point sets are exchanged with one cross-host
    all-reduce so every host ends with the full sequence resident.

    Returns list[TPUScan].  Non-owned scans carry their pose (read from
    the cheap .pose files) and the exchanged reduced points, but not
    the raw channels — operations needing full-resolution points
    (e.g. --exportAllPoints) only work on this host's own range.
    """
    from ..core.scan import TPUScan
    from ..io.scandir import (
        _POSE_READERS, get_format, list_identifiers, read_scan,
    )

    spec = get_format(format)
    idents = list(list_identifiers(directory, spec, start, end))
    S = len(idents)
    lo, hi = host_scan_range(S)
    if mesh is None:
        mesh = host_device_mesh(("hosts", "points"))

    scans: list[TPUScan] = []
    for k, ident in enumerate(idents):
        if lo <= k < hi:
            raw = read_scan(directory, ident, spec, point_filter)
            s = TPUScan.from_raw(raw)
            s.set_reduction(reduce_voxel, octree_n if reduce_voxel > 0 else 0)
            s.reduced_local()
        else:
            pose_path = os.path.join(
                directory, f"{spec.pose_prefix}{ident}{spec.pose_suffix}"
            )
            if os.path.exists(pose_path):
                pos, theta = _POSE_READERS[spec.pose_reader](pose_path)
            else:
                pos = np.zeros(3)
                theta = np.zeros(3)
            from ..core import math3d

            T = np.asarray(math3d.pose_to_matrix(pos, np.rad2deg(theta)))
            s = TPUScan.from_points(np.zeros((0, 3)), ident, pose=T)
        scans.append(s)

    # exchange reduced point counts, then the padded point blocks
    counts = np.zeros(S, np.float32)
    for k in range(lo, hi):
        counts[k] = len(scans[k].reduced_local())
    counts = allsum_hosts(mesh, counts).astype(np.int64)
    cap = int(counts.max()) if S else 0
    cap = ((cap + pad_multiple - 1) // pad_multiple) * pad_multiple
    block = np.zeros((S, max(cap, pad_multiple), 3), np.float32)
    for k in range(lo, hi):
        r = scans[k].reduced_local()
        block[k, : len(r)] = r
    block = allsum_hosts(mesh, block)
    for k, s in enumerate(scans):
        if not (lo <= k < hi):
            s._reduced_local = block[k, : counts[k]].astype(np.float64)
    return scans


def global_scan_array(mesh: Mesh, local_block: np.ndarray, axis: int = 0):
    """Assemble a globally-sharded array from each host's local scan
    block (jax.make_array_from_process_local_data): dimension ``axis``
    is sharded over the ``hosts`` mesh axis, the rest replicated.
    Single-host: a plain device_put."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    spec = [None] * local_block.ndim
    spec[axis] = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(*spec))
    if jax.process_count() == 1:
        return jax.device_put(local_block, sharding)
    return jax.make_array_from_process_local_data(
        sharding, local_block
    )
