"""Surface reconstruction from oriented points — the JAX-native
``mesh`` module (ref src/mesh/recon.cc: calc normals → screened
Poisson → exportMesh .obj).

Two reconstructions are provided:

- :func:`reconstruct_poisson` — the reference's own algorithm
  (screened Poisson), re-expressed as a dense spectral solve
  (see the PoissonParams section below) instead of the octree-FEM
  multigrid of 3rdparty/poisson, whose adaptive refinement and sparse
  pointer structure XLA cannot express.
- :func:`reconstruct_imls` — an IMLS implicit: the signed field
f(x) = Σ w_i(x) n_i·(x − p_i) / Σ w_i with Gaussian weights over the k
nearest samples — every grid node evaluates as one batched KNN + fused
reductions (matmul-shaped), and the zero surface meshes through
ops.surfacenets.  IMLS is the standard implicit-moving-least-squares
reconstruction (Kolluri 2008 provably reconstructs under sampling
conditions), so accuracy-wise this occupies the same slot as Poisson.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MeshParams", "reconstruct_imls", "imls_field",
           "PoissonParams", "reconstruct_poisson", "poisson_field"]


@dataclasses.dataclass
class MeshParams:
    voxel: float = 8.0       # grid resolution (cm)
    k: int = 12              # neighbors per field evaluation
    bandwidth: float = 2.0   # Gaussian h, in voxel units
    max_dist: float = 4.0    # field trusted within this many voxels
    # of the nearest sample (outside: unseen)


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _field_chunked(
    grid_pts, points, normals, h2, trust_d2, *, k: int, chunk: int = 8192
):
    """IMLS field on grid nodes, chunked over nodes.  Returns
    (f [G], valid [G])."""
    from ..ops import knn as knn_ops

    G = grid_pts.shape[0]
    pad = (-G) % chunk
    gp = jnp.pad(grid_pts, ((0, pad), (0, 0)))
    mask = jnp.ones(points.shape[0], bool)

    def one(chunk_pts):
        idx, d2 = knn_ops.knn_brute(
            chunk_pts, jnp.ones(chunk_pts.shape[0], bool),
            points, mask, k,
        )
        p = points[idx]            # [c, k, 3]
        n = normals[idx]
        w = jnp.exp(-d2 / h2)      # [c, k]
        sd = jnp.sum(n * (chunk_pts[:, None, :] - p), axis=-1)
        f = jnp.sum(w * sd, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1e-20)
        valid = d2[:, 0] < trust_d2
        return f, valid

    f, valid = jax.lax.map(one, gp.reshape(-1, chunk, 3))
    return f.reshape(-1)[:G], valid.reshape(-1)[:G]


def imls_field(points, normals, params: MeshParams | None = None):
    """Evaluate the IMLS field on a regular grid over the cloud bounds.
    Returns (field [X,Y,Z], valid [X,Y,Z], origin, voxel)."""
    params = params or MeshParams()
    pts = np.asarray(points, np.float32)
    lo = pts.min(0) - 2 * params.voxel
    hi = pts.max(0) + 2 * params.voxel
    dims = np.maximum(np.ceil((hi - lo) / params.voxel).astype(int) + 1, 2)
    xs = lo[0] + params.voxel * np.arange(dims[0])
    ys = lo[1] + params.voxel * np.arange(dims[1])
    zs = lo[2] + params.voxel * np.arange(dims[2])
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    grid = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    h2 = (params.bandwidth * params.voxel) ** 2
    trust = (params.max_dist * params.voxel) ** 2
    f, valid = _field_chunked(
        jnp.asarray(grid), jnp.asarray(pts),
        jnp.asarray(np.asarray(normals, np.float32)),
        jnp.float32(h2), jnp.float32(trust), k=params.k,
    )
    shape = tuple(dims)
    return (
        np.asarray(f).reshape(shape),
        np.asarray(valid).reshape(shape),
        lo,
        params.voxel,
    )


def reconstruct_imls(
    points, normals=None, params: MeshParams | None = None
):
    """Oriented cloud → triangle mesh (the recon.cc pipeline: normals
    are estimated when absent, then implicit fit + meshing).  Returns
    (vertices [V,3], faces [F,3])."""
    from ..ops.surfacenets import surface_nets

    params = params or MeshParams()
    pts = np.asarray(points, np.float32)
    if normals is None:
        from ..ops.normals import estimate_normals_knn

        center = pts.mean(0) + np.array([0.0, 1e6, 0.0])  # above: outward-ish
        normals = np.asarray(
            estimate_normals_knn(
                jnp.asarray(pts), jnp.ones(len(pts), bool),
                jnp.asarray(center, jnp.float32), k=max(params.k, 12),
            )
        )
    field, valid, origin, voxel = imls_field(pts, normals, params)
    return surface_nets(field, valid, origin=origin, voxel=voxel)


# ---------------------------------------------------------------------------
# Screened Poisson reconstruction (ref src/mesh/poisson.cc + 3rdparty/poisson)
# ---------------------------------------------------------------------------
#
# The reference wraps Kazhdan's octree-FEM PoissonRecon.  The JAX-native
# equivalent solves the SAME PDE — find the indicator chi whose gradient
# matches the splatted oriented-normal field V:  (laplacian - alpha) chi
# = div V — but on a DENSE voxel grid in the spectral domain: trilinear
# normal splat, central-difference divergence, one 3-D real FFT, a
# pointwise division by the discrete-Laplacian symbol, and an inverse
# FFT.  A dense FFT solve is the regular, bandwidth-friendly program
# shape accelerators want (the octree multigrid is pointer-chasing XLA
# cannot express); at grid=256 the solve is a few hundred MB and
# milliseconds of FFT work.  The screening term alpha anchors the DC
# mode and pulls chi to zero away from data (Kazhdan & Hoppe 2013's
# screening role).


@dataclasses.dataclass
class PoissonParams:
    grid: int = 128          # dense grid resolution per axis
    screen: float = 4.0      # screening weight (relative, see alpha)
    margin: float = 0.08     # bbox margin fraction
    trim_dist: float = 3.0   # extract only within this many voxels of
    # a sample (<=0: full grid, fully watertight)


def _trilinear_splat(idx_f, values, G):
    """Scatter-add `values` [N, C] at fractional grid coords [N, 3]."""
    base = jnp.floor(idx_f).astype(jnp.int32)
    frac = idx_f - base
    out = jnp.zeros((G * G * G, values.shape[1]), jnp.float32)
    for corner in range(8):
        off = jnp.asarray(
            [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], jnp.int32
        )
        w = jnp.prod(
            jnp.where(off[None, :] == 1, frac, 1.0 - frac), axis=1
        )
        cell = jnp.clip(base + off[None, :], 0, G - 1)
        flat = (cell[:, 0] * G + cell[:, 1]) * G + cell[:, 2]
        out = out.at[flat].add(w[:, None] * values)
    return out.reshape(G, G, G, -1)


def _trilinear_sample(vol, idx_f):
    base = jnp.floor(idx_f).astype(jnp.int32)
    frac = idx_f - base
    G = vol.shape[0]
    acc = jnp.zeros(idx_f.shape[0], vol.dtype)
    for corner in range(8):
        off = jnp.asarray(
            [(corner >> 2) & 1, (corner >> 1) & 1, corner & 1], jnp.int32
        )
        w = jnp.prod(
            jnp.where(off[None, :] == 1, frac, 1.0 - frac), axis=1
        )
        cell = jnp.clip(base + off[None, :], 0, G - 1)
        acc = acc + w * vol[cell[:, 0], cell[:, 1], cell[:, 2]]
    return acc


def poisson_field(points, normals, params: PoissonParams | None = None):
    """Solve the screened Poisson equation for the indicator field.
    Returns (chi [G,G,G] f32 with the iso level already subtracted,
    occupancy [G,G,G] f32, origin [3], voxel)."""
    params = params or PoissonParams()
    G = params.grid
    pts = np.asarray(points, np.float64)
    nrm = np.asarray(normals, np.float64)
    lo = pts.min(0)
    hi = pts.max(0)
    span = float((hi - lo).max())
    pad = params.margin * span
    origin = lo - pad
    voxel = (span + 2 * pad) / (G - 1)

    idx_f = jnp.asarray((pts - origin) / voxel, jnp.float32)
    nj = jnp.asarray(nrm, jnp.float32)
    splat = _trilinear_splat(
        idx_f,
        jnp.concatenate(
            [nj, jnp.ones((len(pts), 1), jnp.float32)], axis=1
        ),
        G,
    )
    V = splat[..., :3]
    occ = splat[..., 3]

    # divergence by central differences (h = 1 voxel; scale is
    # irrelevant to the zero level set)
    div = jnp.zeros((G, G, G), jnp.float32)
    for ax in range(3):
        div = div + 0.5 * (
            jnp.roll(V[..., ax], -1, axis=ax)
            - jnp.roll(V[..., ax], 1, axis=ax)
        )

    # spectral solve with the symbol of the 7-point discrete Laplacian
    k = jnp.arange(G)
    lam1 = 2.0 * jnp.cos(2.0 * jnp.pi * k / G) - 2.0
    lam = (
        lam1[:, None, None] + lam1[None, :, None] + lam1[None, None, :]
    )
    alpha = params.screen * (2.0 * jnp.pi / G) ** 2
    denom = lam - alpha
    chi = jnp.real(
        jnp.fft.ifftn(jnp.fft.fftn(div) / denom)
    ).astype(jnp.float32)

    # iso level: mean indicator value at the samples (PoissonRecon's
    # iso-value extraction)
    iso = jnp.mean(_trilinear_sample(chi, idx_f))
    return (
        np.asarray(chi - iso),
        np.asarray(occ),
        np.asarray(origin),
        float(voxel),
    )


def reconstruct_poisson(
    points, normals=None, params: PoissonParams | None = None
):
    """Oriented cloud -> triangle mesh via the dense screened-Poisson
    solve (the reference's bin/poisson pipeline, src/mesh/poisson.cc).
    Returns (vertices [V,3], faces [F,3])."""
    from ..ops.surfacenets import surface_nets

    params = params or PoissonParams()
    pts = np.asarray(points, np.float32)
    if normals is None:
        from ..ops.normals import estimate_normals_knn

        center = pts.mean(0) + np.array([0.0, 1e6, 0.0])
        normals = np.asarray(
            estimate_normals_knn(
                jnp.asarray(pts), jnp.ones(len(pts), bool),
                jnp.asarray(center, jnp.float32), k=12,
            )
        )
    chi, occ, origin, voxel = poisson_field(pts, normals, params)
    valid = None
    if params.trim_dist > 0:
        from scipy.ndimage import binary_dilation

        valid = binary_dilation(
            np.asarray(occ) > 0, iterations=int(params.trim_dist)
        )
    return surface_nets(chi, valid, origin=origin, voxel=voxel)
