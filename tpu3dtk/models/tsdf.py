"""TSDF volume integration — the JAX-native ``tsdf`` module
(ref src/tsdf/: SensorPolar3D projective model + TsdSpaceVDB voxel
space driven by scan2tsdf.cc, meshed by vdb2mesh.cc).

Batched re-design: the reference's VDB sparse tree + per-voxel ray casts
become a DENSE device voxel block updated by one jitted scatter per
scan — for each measured point, K static samples along the sensor ray
within ±truncation of the surface update (tsdf, weight) running
averages.  Memory is bounded by the axis-aligned volume (dense is the
Device-friendly trade: a 256³ f32 block is 64 MB — trivial for device memory, and
every update is a vectorized gather/scatter instead of tree walks).

Meshing runs through ops.surfacenets (the vdb2mesh role).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math3d

__all__ = ["TsdfParams", "TsdfVolume"]


@dataclasses.dataclass
class TsdfParams:
    voxel: float = 5.0          # cm
    truncation: float = 15.0    # cm (ref TsdSpace truncation radius)
    samples: int = 9            # ray samples across the truncation band
    max_weight: float = 64.0    # running-average clamp


@functools.partial(jax.jit, static_argnames=("dims", "samples"))
def _integrate(
    tsdf, weight, points_g, mask, sensor, origin, voxel, trunc,
    max_weight, *, dims, samples: int,
):
    """Scatter one scan into the volume.  points_g [N,3] global-frame
    surface points; sensor [3] global sensor origin."""
    nx, ny, nz = dims
    rays = points_g - sensor[None, :]
    depth = jnp.linalg.norm(rays, axis=1, keepdims=True)
    dirs = rays / jnp.maximum(depth, 1e-9)
    # K samples at signed offsets u in [-trunc, +trunc] around the
    # surface: sample position x = p - u * dir, sdf(x) = u
    us = jnp.linspace(-trunc, trunc, samples)
    pos = points_g[:, None, :] - us[None, :, None] * dirs[:, None, :]
    sdf = jnp.broadcast_to(us[None, :], (points_g.shape[0], samples))
    ijk = jnp.floor((pos - origin) / voxel).astype(jnp.int32)
    inb = (
        mask[:, None]
        & jnp.all(ijk >= 0, axis=-1)
        & (ijk[..., 0] < nx)
        & (ijk[..., 1] < ny)
        & (ijk[..., 2] < nz)
    )
    flat = (
        jnp.clip(ijk[..., 0], 0, nx - 1) * ny
        + jnp.clip(ijk[..., 1], 0, ny - 1)
    ) * nz + jnp.clip(ijk[..., 2], 0, nz - 1)
    dump = nx * ny * nz
    flat = jnp.where(inb, flat, dump).reshape(-1)
    sdf_n = (sdf / trunc).reshape(-1)  # normalized [-1, 1]
    acc_t = jnp.zeros(dump + 1, jnp.float32).at[flat].add(
        jnp.where(inb.reshape(-1), sdf_n, 0.0)
    )
    acc_w = jnp.zeros(dump + 1, jnp.float32).at[flat].add(
        inb.reshape(-1).astype(jnp.float32)
    )
    acc_t = acc_t[:dump].reshape(dims)
    acc_w = acc_w[:dump].reshape(dims)
    w_new = weight + acc_w
    t_new = jnp.where(
        w_new > 0, (tsdf * weight + acc_t) / jnp.maximum(w_new, 1e-9), tsdf
    )
    return t_new, jnp.minimum(w_new, max_weight)


class TsdfVolume:
    """Dense TSDF block over an axis-aligned region."""

    def __init__(self, origin, dims, params: TsdfParams | None = None):
        self.params = params or TsdfParams()
        self.origin = np.asarray(origin, np.float64)
        self.dims = tuple(int(d) for d in dims)
        self.tsdf = jnp.ones(self.dims, jnp.float32)
        self.weight = jnp.zeros(self.dims, jnp.float32)

    @classmethod
    def for_bounds(cls, lo, hi, params: TsdfParams | None = None):
        params = params or TsdfParams()
        lo = np.asarray(lo, np.float64) - 2 * params.truncation
        hi = np.asarray(hi, np.float64) + 2 * params.truncation
        dims = np.maximum(
            np.ceil((hi - lo) / params.voxel).astype(int) + 1, 2
        )
        return cls(lo, tuple(dims), params)

    def integrate(self, points_local, pose, mask=None) -> None:
        """Fuse one scan: local points + global pose (the scan2tsdf
        per-scan loop).  The sensor origin is the pose translation."""
        p = self.params
        pts_g = np.asarray(
            math3d.transform3(np.asarray(pose), np.asarray(points_local))
        ).astype(np.float32)
        if mask is None:
            mask = np.ones(len(pts_g), bool)
        self.tsdf, self.weight = _integrate(
            self.tsdf, self.weight,
            jnp.asarray(pts_g), jnp.asarray(mask),
            jnp.asarray(np.asarray(pose)[:3, 3], jnp.float32),
            jnp.asarray(self.origin, jnp.float32),
            jnp.float32(p.voxel), jnp.float32(p.truncation),
            jnp.float32(p.max_weight),
            dims=self.dims, samples=p.samples,
        )

    def extract_mesh(self):
        """Zero-surface triangles (the vdb2mesh role).  Returns
        (vertices [V,3], faces [F,3])."""
        from ..ops.surfacenets import surface_nets

        return surface_nets(
            np.asarray(self.tsdf),
            np.asarray(self.weight) > 0,
            origin=self.origin,
            voxel=self.params.voxel,
        )
