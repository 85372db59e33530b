"""Voxel-grid point reduction — the JAX-native equivalent of the
reference's octree reduction (``BOctTree::GetOctTreeCenter/Random/Avg``,
include/slam6d/Boctree.h:435-492, driven by ``Scan::calcReducedPoints``,
src/slam6d/scan.cc:432-687).

Instead of building a pointer-free octree (a CPU idiom), points are
hashed to voxel ids, sorted, and reduced with segment ops — one fused
XLA program with static shapes.  Semantics match the reference's modes:

- nrpts == 0  -> voxel center          (GetOctTreeCenter)
- nrpts == -1 -> mean of voxel points  (GetOctTreeAvg)
- nrpts == 1  -> one random point      (GetOctTreeRandom)
- nrpts == n  -> up to n random points per voxel; with ``rm_scatter``
  voxels holding fewer than n points are dropped entirely
  (scan.cc:594-601).

Deviation from the reference (documented): voxels are a uniform grid of
edge ``voxel_size`` anchored at the data minimum, not power-of-two
subdivisions of the bounding cube.  Reduction density is equivalent; the
contract is ATE-bounded trajectory equality, not bitwise (SURVEY §7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["voxel_reduce", "reduce_scan"]

_BITS = 20  # bits per axis of voxel id; supports 1M voxels per axis


def _voxel_ids(pts, mask, voxel_size):
    """Linear voxel id per point; masked points get the max id so they
    sort to the end."""
    origin = jnp.min(jnp.where(mask[:, None], pts, jnp.inf), axis=0)
    ij = jnp.floor((pts - origin) / voxel_size).astype(jnp.int64)
    ij = jnp.clip(ij, 0, (1 << _BITS) - 2)
    lin = (ij[:, 0] << (2 * _BITS)) | (ij[:, 1] << _BITS) | ij[:, 2]
    big = jnp.int64((1 << 62) - 1)
    lin = jnp.where(mask, lin, big)
    return lin, origin


@functools.partial(
    jax.jit, static_argnames=("mode", "nrpts", "rm_scatter")
)
def voxel_reduce(
    pts,
    mask,
    voxel_size,
    *,
    mode: str = "center",
    nrpts: int = 1,
    rm_scatter: bool = False,
    key=None,
):
    """Reduce a padded point set to one (or nrpts) representatives per
    voxel.

    pts: [N, 3]; mask: [N] bool; voxel_size: scalar (cm).
    mode: "center" | "mean" | "random" (nrpts per voxel).
    Returns (out_pts [N, 3], out_mask [N]) — same padded capacity; valid
    entries are compacted to the front.
    """
    n = pts.shape[0]
    dtype = pts.dtype
    if key is not None and mode == "random":
        # random pick per voxel == first point per voxel after a random
        # permutation (ref GetOctTreeRandom draws rand(nrpts) per leaf)
        perm = jax.random.permutation(key, n)
        pts = pts[perm]
        mask = mask[perm]

    lin, origin = _voxel_ids(pts, mask, voxel_size)
    order = jnp.argsort(lin)
    lin_s = lin[order]
    pts_s = pts[order]
    mask_s = mask[order]

    head = jnp.concatenate(
        [jnp.ones((1,), bool), lin_s[1:] != lin_s[:-1]]
    ) & mask_s
    seg = jnp.cumsum(head) - 1  # voxel index per sorted point (0-based)
    nvox = jnp.sum(head)

    if mode == "mean":
        sums = jax.ops.segment_sum(
            jnp.where(mask_s[:, None], pts_s, 0.0), seg, num_segments=n
        )
        cnts = jax.ops.segment_sum(mask_s.astype(dtype), seg, num_segments=n)
        out = sums / jnp.maximum(cnts, 1.0)[:, None]
        out_mask = jnp.arange(n) < nvox
        return jnp.where(out_mask[:, None], out, 0.0).astype(dtype), out_mask

    if mode == "center":
        # decode voxel center from the first point of each voxel
        first = jax.ops.segment_min(
            jnp.where(mask_s, jnp.arange(n), n - 1), seg, num_segments=n
        )
        rep = pts_s[first]
        ij = jnp.floor((rep - origin) / voxel_size)
        out = (ij + 0.5) * voxel_size + origin
        out_mask = jnp.arange(n) < nvox
        return jnp.where(out_mask[:, None], out, 0.0).astype(dtype), out_mask

    if mode == "random":
        # rank within voxel; keep rank < nrpts
        first_idx = jax.ops.segment_min(
            jnp.where(mask_s, jnp.arange(n), n - 1), seg, num_segments=n
        )
        rank = jnp.arange(n) - first_idx[seg]
        keep = mask_s & (rank < nrpts)
        if rm_scatter and nrpts > 1:
            cnts = jax.ops.segment_sum(
                mask_s.astype(jnp.int32), seg, num_segments=n
            )
            keep = keep & (cnts[seg] >= nrpts)
        # compact kept points to the front
        kidx = jnp.cumsum(keep) - 1
        out = jnp.zeros_like(pts_s)
        out = out.at[jnp.where(keep, kidx, n - 1)].set(
            jnp.where(keep[:, None], pts_s, 0.0), mode="drop"
        )
        # note: masked writes may collide on slot n-1; rewrite valid tail
        total = jnp.sum(keep)
        out_mask = jnp.arange(n) < total
        # ensure the last slot holds its real point when total == n
        out = jnp.where(out_mask[:, None], out, 0.0)
        return out.astype(dtype), out_mask

    raise ValueError(f"unknown reduction mode {mode!r}")


def reduce_scan(xyz, voxel_size, nrpts, *, seed: int = 0):
    """Host convenience wrapper mirroring calcReducedPoints' mode switch
    (scan.cc:588-601).  xyz: numpy/jax [N,3].  Returns compacted [Nr,3]
    numpy array (trimmed to the true count)."""
    import numpy as np

    if voxel_size <= 0:
        return np.asarray(xyz)
    # bucket the padded size to powers of two so a whole scan directory
    # (every scan a slightly different size after range filtering)
    # compiles voxel_reduce once, not per scan
    n = np.asarray(xyz).shape[0]
    cap = 1024
    while cap < n:
        cap *= 2
    xyz = jnp.asarray(
        np.pad(np.asarray(xyz, np.float32), ((0, cap - n), (0, 0)))
    )
    mask = jnp.arange(cap) < n
    if nrpts == 0:
        out, m = voxel_reduce(xyz, mask, voxel_size, mode="center")
    elif nrpts == -1:
        out, m = voxel_reduce(xyz, mask, voxel_size, mode="mean")
    else:
        out, m = voxel_reduce(
            xyz,
            mask,
            voxel_size,
            mode="random",
            nrpts=int(nrpts),
            key=jax.random.PRNGKey(seed),
        )
    out = np.asarray(out)
    m = np.asarray(m)
    return out[m]
