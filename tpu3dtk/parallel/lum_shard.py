"""Multi-device GraphSLAM: graph-link covariance assembly sharded over
the device mesh.

The reference parallelizes LUM's per-link covariance loop with OpenMP
threads scattering into shared G/B under a critical section
(lum6Deuler.cc:270-301, SURVEY §2.8 item 2).  Here the links — each an
independent NN search + 6x6 reduction — are data-parallel across
devices via shard_map; every device runs the batched link kernel on its
shard against the replicated point tensor, and results are gathered for
the (tiny, host-side) sparse assembly.  This is the dominant phase of
hannover2-class workloads (the BASELINE north-star's allreduce plan).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..models.graphslam import _one_link_stats

__all__ = ["link_covariances_sharded"]


def link_covariances_sharded(
    mesh,
    points_g,
    masks,
    links,
    max_dist2: float,
    axis: str | tuple | None = None,
    chunk: int = 4,
    n_buckets: int = 0,
    bucket_cap: int = 0,
):
    """Batched (C, CD, m, overflow) for all links, links sharded over
    ``axis``.

    points_g: [S, N, 3] replicated; links: [L, 2] (L padded to the axis
    size internally; padding links are (0, 0) and their outputs are
    dropped).  n_buckets/bucket_cap > 0 routes the per-link NN through
    per-scan hashed cell lists (models.graphslam.link_covariances_grid
    semantics — each device builds the hashes over the replicated point
    tensor once per call); overflow=True means a bucket exceeded
    bucket_cap and the caller must redo with brute.  Returns numpy
    (C [L,6,6], CD [L,6], m [L], overflow bool).
    """
    if axis is None:
        axis = tuple(mesh.axis_names)
    n_dev = mesh.devices.size
    L = len(links)
    Lpad = ((L + n_dev - 1) // n_dev) * n_dev
    links_p = np.zeros((Lpad, 2), np.int32)
    links_p[:L] = np.asarray(links, np.int32)

    fn = _sharded_links_fn(
        mesh, axis, int(chunk), int(n_buckets), int(bucket_cap)
    )
    C, CD, m, overflow = fn(
        jnp.asarray(points_g, jnp.float32),
        jnp.asarray(masks),
        jnp.asarray(links_p),
        jnp.float32(max_dist2),
    )
    return (
        np.asarray(C)[:L],
        np.asarray(CD)[:L],
        np.asarray(m)[:L],
        bool(overflow),
    )


@functools.lru_cache(maxsize=32)
def _sharded_links_fn(mesh, axis, chunk, n_buckets, bucket_cap):
    from ..ops import nn as nn_ops

    def shard_fn(pts, msk, lnk, md2):
        if n_buckets > 0:
            cell = jnp.sqrt(md2)
            inf3 = jnp.full((3,), jnp.float32(jnp.inf))

            def build_one(p, m):
                origin = jnp.min(jnp.where(m[:, None], p, inf3), axis=0)
                origin = jnp.where(jnp.isfinite(origin), origin, 0.0)
                return nn_ops.build_cell_hash(p, m, origin, cell, n_buckets)

            grids = jax.vmap(build_one)(pts, msk)
            occ = grids.bucket_start[:, 1:] - grids.bucket_start[:, :-1]
            overflow = jnp.max(occ) > bucket_cap
        else:
            grids = None
            overflow = jnp.bool_(False)

        def one(link):
            i, j = link[0], link[1]
            grid = None
            if grids is not None:
                g = nn_ops.CellHash(
                    points=grids.points[i],
                    src_idx=grids.src_idx[i],
                    bucket_start=grids.bucket_start[i],
                    origin=grids.origin[i],
                    cell=grids.cell[i],
                )
                grid = (g, bucket_cap)
            return _one_link_stats(
                pts[i], msk[i], pts[j], msk[j], md2, grid=grid
            )

        C, CD, m = jax.lax.map(
            one, lnk, batch_size=min(chunk, max(1, lnk.shape[0]))
        )
        return C, CD, m, overflow

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(axis, None), P()),
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def lum_run_sharded(
    mesh,
    locals_pts, masks, links, link_mask, pos0, theta0,
    n_scans, max_dist2, epsilon, local_grids=None,
    *,
    iterations: int,
    chunk: int = 4,
    bucket_cap: int = 0,
    axis: str | tuple | None = None,
):
    """The ENTIRE on-device LUM relaxation (models.lum_device.lum_run)
    under shard_map with the LINK slots sharded over ``axis``: each
    device computes covariances for its link shard, the G/B block
    partials psum-merge across devices, and every device runs the (tiny)
    replicated solve + pose update — so the while_loop state stays
    bitwise identical across devices with one collective per iteration
    (the batched form of the reference's OpenMP scatter,
    lum6Deuler.cc:270-303)."""
    from ..models.lum_device import lum_run

    if axis is None:
        # shard links over EVERY mesh axis (a multi-host hosts x points
        # mesh then carries the G/B psum across hosts once per iteration)
        axis = tuple(mesh.axis_names)
    ax = axis if isinstance(axis, tuple) else (axis,)
    n_dev = 1
    for a in ax:
        n_dev *= mesh.shape[a]
    L = links.shape[0]
    Lpad = ((L + n_dev - 1) // n_dev) * n_dev
    if Lpad != L:
        links = jnp.concatenate(
            [links, jnp.zeros((Lpad - L, 2), links.dtype)]
        )
        link_mask = jnp.concatenate(
            [link_mask, jnp.zeros(Lpad - L, link_mask.dtype)]
        )

    def shard_fn(lp, mk, lnk, lmask, p0, t0, ns, md2, eps, grids):
        return lum_run(
            lp, mk, lnk, lmask, p0, t0, ns, md2, eps, grids,
            iterations=iterations, chunk=chunk,
            bucket_cap=bucket_cap,
            axis_name=ax if len(ax) > 1 else ax[0],
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(ax, None), P(ax), P(), P(), P(), P(), P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(
        locals_pts, masks, links, link_mask, pos0, theta0,
        jnp.int32(n_scans), jnp.float32(max_dist2), jnp.float32(epsilon),
        local_grids,
    )
