"""Worker for the 2-process jax.distributed LUM test (run by
tests/test_distributed.py, one process per simulated host).

Exercises the documented launch recipe from parallel/distributed.py:
JAX_COORDINATOR / NPROC / PROC_ID env vars -> dist.initialize() ->
host_device_mesh -> link-sharded LUM with the G/B psum crossing the
process boundary (cross-host path).  Process 0 writes the relaxed poses to the
output file for the parent to compare against a single-process run.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def build_problem():
    """Deterministic tiny LUM problem — identical on every host."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from conftest import make_room_cloud

    from tpu3dtk.core import math3d

    rng = np.random.default_rng(0)
    world = make_room_cloud(rng, n=1200, size=600.0)
    S = 4
    locals_ = np.zeros((S, len(world), 3), np.float32)
    pos0 = np.zeros((S, 3), np.float32)
    theta0 = np.zeros((S, 3), np.float32)
    for k in range(S):
        pos_true = np.array([40.0 * k, 0.0, 0.0])
        T = np.asarray(math3d.euler_to_matrix4(pos_true, np.zeros(3)))
        locals_[k] = np.asarray(
            math3d.transform3(np.asarray(math3d.m4inv(T)), world)
        )
        jitter = rng.normal(0, 2.0, 3) if k else np.zeros(3)
        pos0[k] = pos_true + jitter
    masks = np.ones((S, locals_.shape[1]), bool)
    links = np.array(
        [(i, i + 1) for i in range(S - 1)] + [(0, S - 1)], np.int32
    )
    return locals_, masks, links, pos0, theta0


def main():
    from tpu3dtk.parallel import distributed as dist

    was_dist = dist.initialize()  # reads JAX_COORDINATOR/NPROC/PROC_ID
    out = sys.argv[1]
    locals_, masks, links, pos0, theta0 = build_problem()
    S = len(locals_)

    # ingest sharding helper must partition the sequence across hosts
    n_hosts = max(jax.process_count(), 1)
    ranges = [dist.host_scan_range(S, n_hosts, h) for h in range(n_hosts)]
    covered = sorted(i for lo, hi in ranges for i in range(lo, hi))
    assert covered == list(range(S)), ranges

    mesh = dist.host_device_mesh(("hosts", "points"))
    from tpu3dtk.parallel.lum_shard import lum_run_sharded

    link_mask = np.ones(len(links), bool)
    pos, theta, hist, it, ret = lum_run_sharded(
        mesh,
        jnp.asarray(locals_), jnp.asarray(masks),
        jnp.asarray(links), jnp.asarray(link_mask),
        jnp.asarray(pos0), jnp.asarray(theta0),
        S, 625.0, 1e-4,
        iterations=5,
        axis=("hosts", "points"),
    )
    pos = np.asarray(jax.device_get(pos))
    theta = np.asarray(jax.device_get(theta))
    if jax.process_index() == 0:
        np.savez(
            out, pos=pos, theta=theta, it=int(it),
            n_proc=jax.process_count(), was_dist=was_dist,
            mesh_shape=np.asarray(list(mesh.devices.shape)),
        )
    print(f"worker {jax.process_index()}/{jax.process_count()} done")


if __name__ == "__main__":
    main()
