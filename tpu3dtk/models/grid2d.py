"""2D occupancy grids from registered scans — the JAX-native ``grid``
module (ref src/grid/2DGridder.cc + scanGrid/parcel machinery,
SURVEY §2.6: project scans to 2D occupancy maps with free-space
counting along rays).

One batched pass: points project to (x, z) cells (y-up frame); rays
from the scanner position accumulate free-space counts via the same
parametric sampling as the peopleremover; occupancy = hits vs
visits.  Parcels/world-map stitching reduce to array concatenation
here, so only the map math is kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Grid2DParams", "OccupancyGrid", "make_occupancy_grid"]


@dataclasses.dataclass
class Grid2DParams:
    resolution: float = 10.0  # cm per cell (ref --resolution)
    y_min: float | None = None  # height band filter (ref --minHeight)
    y_max: float | None = None
    count_free: bool = True  # ray-carve free space


@dataclasses.dataclass
class OccupancyGrid:
    origin: np.ndarray  # [2] world coords of cell (0,0) (x, z)
    resolution: float
    hits: np.ndarray  # [W, H] int32
    visits: np.ndarray  # [W, H] int32 (hits + free-space traversals)

    @property
    def occupancy(self) -> np.ndarray:
        """P(occupied): hits / visits, -1 for never-seen (ref grid
        convention of unknown cells)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            p = self.hits / np.maximum(self.visits, 1)
        p = np.where(self.visits > 0, p, -1.0)
        return p

    def write_pgm(self, path: str) -> None:
        """Grey occupancy image (ref writeGrid ppm/pgm outputs)."""
        occ = self.occupancy
        img = np.where(occ < 0, 128, (1.0 - occ) * 255).astype(np.uint8)
        with open(path, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())


def make_occupancy_grid(
    scan_points: list[np.ndarray],
    scan_origins: list[np.ndarray],
    params: Grid2DParams | None = None,
) -> OccupancyGrid:
    """Build a global 2D occupancy grid from global-frame points.

    scan_points[i]: [Ni, 3]; scan_origins[i]: [3].
    """
    import jax.numpy as jnp

    params = params or Grid2DParams()
    res = params.resolution
    pts_all = []
    for p in scan_points:
        p = np.asarray(p)
        keep = np.ones(len(p), bool)
        if params.y_min is not None:
            keep &= p[:, 1] >= params.y_min
        if params.y_max is not None:
            keep &= p[:, 1] <= params.y_max
        pts_all.append(p[keep])
    cat = np.concatenate(pts_all, axis=0)
    xz = cat[:, [0, 2]]
    orgs = np.stack([np.asarray(o)[[0, 2]] for o in scan_origins])
    origin = np.minimum(xz.min(0), orgs.min(0)) - res
    top = np.maximum(xz.max(0), orgs.max(0)) + res
    W = int(np.ceil((top[0] - origin[0]) / res)) + 1
    H = int(np.ceil((top[1] - origin[1]) / res)) + 1

    def cell_id(xy):
        ij = jnp.clip(
            jnp.floor((xy - origin) / res).astype(jnp.int32),
            0,
            jnp.asarray([W - 1, H - 1]),
        )
        return ij[..., 0] * H + ij[..., 1]

    hits = jnp.zeros((W * H,), jnp.int32)
    visits = jnp.zeros((W * H,), jnp.int32)
    for p, org in zip(pts_all, scan_origins):
        if len(p) == 0:
            continue
        pj = jnp.asarray(p[:, [0, 2]], jnp.float32)
        ids = cell_id(pj)
        hits = hits.at[ids].add(1)
        visits = visits.at[ids].add(1)
        if params.count_free:
            o = jnp.asarray(np.asarray(org)[[0, 2]], jnp.float32)
            ray = pj - o
            rlen = jnp.linalg.norm(ray, axis=1)
            kmax = int(np.ceil(float(jnp.max(rlen)) / (0.5 * res))) + 1
            ts = jnp.arange(1, kmax + 1, dtype=jnp.float32) * (0.5 * res)
            t = jnp.minimum(
                ts[None, :] / jnp.maximum(rlen, 1e-9)[:, None],
                ((rlen - res) / jnp.maximum(rlen, 1e-9))[:, None],
            )
            t = jnp.maximum(t, 0.0)
            samples = o[None, None, :] + ray[:, None, :] * t[:, :, None]
            sids = cell_id(samples)
            # dedupe-by-construction is unnecessary: visits count is a
            # weight, duplicates just weight near cells higher (the
            # reference increments per traversal too)
            visits = visits.at[sids.reshape(-1)].add(1)
    return OccupancyGrid(
        origin=np.asarray(origin),
        resolution=res,
        hits=np.asarray(hits).reshape(W, H),
        visits=np.asarray(visits).reshape(W, H),
    )


def write_gnuplot(grid: "OccupancyGrid", path: str,
                  threshold: float = 0.5) -> int:
    """Occupied cell centers as 'x z' lines for gnuplot (ref
    gridWriter.cc gnuplotWriter::write).  Returns cell count."""
    occ = grid.occupancy
    ys, xs = np.nonzero(occ.T >= threshold)  # transpose: rows = z
    n = 0
    with open(path, "w") as f:
        for x, z in zip(xs, ys):
            wx = grid.origin[0] + (x + 0.5) * grid.resolution
            wz = grid.origin[1] + (z + 0.5) * grid.resolution
            f.write(f"{wx} {wz}\n")
            n += 1
    return n


def write_world(grid: "OccupancyGrid", path: str) -> None:
    """World-map text format: header (bounds, resolution) + per-cell
    occupancy percentage rows (ref gridWriter.cc worldWriter)."""
    occ = grid.occupancy
    W, H = occ.shape
    with open(path, "w") as f:
        f.write(
            f"{grid.origin[0]} {grid.origin[0] + W * grid.resolution} "
            f"{grid.origin[1]} {grid.origin[1] + H * grid.resolution} "
            f"{grid.resolution}\n"
        )
        for j in range(H):
            f.write(
                " ".join(
                    "-1" if occ[i, j] < 0 else f"{int(occ[i, j] * 100)}"
                    for i in range(W)
                )
                + "\n"
            )


def extract_gridlines(
    grid: "OccupancyGrid",
    threshold: float = 0.5,
    min_length: float = 2.0,
    n_theta: int = 180,
    n_rho: int = 256,
    min_votes: int = 8,
    max_lines: int = 32,
):
    """Line segments from an occupancy grid — the ``gridlines`` tool
    (ref src/grid/gridlines.cc: Hough transform over solid cells, then
    segment extraction).  One [N_cells, n_theta] matmul computes every
    cell's rho against every direction (the same matmul Hough pattern as
    models.shapes).  Returns [(p0 [2], p1 [2])] world-coordinate
    segments with length >= min_length cells."""
    import jax.numpy as jnp

    occ = grid.occupancy
    xs, zs = np.nonzero(occ >= threshold)
    if len(xs) == 0:
        return []
    pts = np.stack(
        [
            grid.origin[0] + (xs + 0.5) * grid.resolution,
            grid.origin[1] + (zs + 0.5) * grid.resolution,
        ],
        axis=1,
    )
    thetas = np.linspace(0, np.pi, n_theta, endpoint=False)
    dirs = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    rho = np.asarray(
        jnp.dot(jnp.asarray(pts, jnp.float32), jnp.asarray(dirs.T, jnp.float32))
    )  # [N, n_theta]
    rmin, rmax = rho.min(), rho.max()
    bw = max((rmax - rmin) / n_rho, 1e-6)
    bins = np.clip(((rho - rmin) / bw).astype(int), 0, n_rho - 1)
    segments = []
    used = np.zeros(len(pts), bool)
    for _ in range(max_lines):
        acc = np.zeros((n_theta, n_rho), np.int32)
        alive = ~used
        for tI in range(n_theta):
            np.add.at(acc[tI], bins[alive, tI], 1)
        tI, rI = np.unravel_index(np.argmax(acc), acc.shape)
        if acc[tI, rI] < min_votes:
            break
        on_line = alive & (np.abs(bins[:, tI] - rI) <= 1)
        if on_line.sum() < min_votes:
            break
        sel = pts[on_line]
        d = dirs[tI]
        t = sel @ np.array([-d[1], d[0]])  # position along the line
        order = np.argsort(t)
        sel, t = sel[order], t[order]
        # split at gaps > 3 cells (segment extraction, gridlines.cc)
        gap = grid.resolution * 3.0
        start = 0
        for k in range(1, len(t) + 1):
            if k == len(t) or t[k] - t[k - 1] > gap:
                if (
                    t[k - 1] - t[start]
                    >= min_length * grid.resolution
                ):
                    segments.append((sel[start].copy(), sel[k - 1].copy()))
                start = k
        used |= on_line
    return segments
