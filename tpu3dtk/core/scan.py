"""Scan abstraction — the JAX-native ``Scan``/``BasicScan``
(ref include/slam6d/scan.h:124-531, src/slam6d/scan.cc, basicScan.cc).

Differences by design (batched, not a port):

- Points are immutable.  The reference mutates ``xyz reduced`` in place
  on every ``transform`` (scan.cc:851-873); here reduced points stay in
  the scan's *local* frame and the global view is ``transMat @ local``,
  composed inside the jitted ICP step — one fused matmul instead of a
  storage rewrite, and no error accumulation over thousands of
  transforms.
- Named lazy channels survive: ``get("xyz")``, ``get("xyz reduced")``
  etc. map to :meth:`channel` / :meth:`reduced`.
- Pose state mirrors the reference exactly: ``transMatOrg`` (initial
  pose from .pose), ``transMat`` (current), ``dalignxf`` (delta with
  transMat = dalignxf @ transMatOrg), rPos/rPosTheta derived
  (scan.h:402-413, scan.cc:878-898).
- The frames log is append-only (AlgoType-tagged pose history) and
  doubles as checkpoint + animation input, identical to `.frames`
  (SURVEY §5).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..io.frames import AlgoType
from ..io.scandir import RawScan
from ..ops import reduction as red_ops
from . import math3d

__all__ = ["TPUScan"]


@dataclasses.dataclass
class TPUScan:
    identifier: str
    channels: dict[str, np.ndarray]  # local frame
    transMatOrg: np.ndarray  # [4,4] initial pose (from .pose)
    transMat: np.ndarray  # [4,4] current pose
    dalignxf: np.ndarray  # [4,4] delta: transMat = dalignxf @ transMatOrg
    frames: list[tuple[np.ndarray, int]] = dataclasses.field(default_factory=list)
    reduction_voxel: float = 0.0
    reduction_nrpts: int = 0
    _reduced_local: Optional[np.ndarray] = None
    _pad_cache: Optional[tuple] = None
    # monotone content generation: bumped whenever the reduced point set
    # changes, so drivers can key resident-tensor caches on
    # (identifier, generation) instead of recyclable id()s
    generation: int = 0

    # -- construction -----------------------------------------------------
    @classmethod
    def from_raw(cls, raw: RawScan) -> "TPUScan":
        T = np.asarray(math3d.pose_to_matrix(raw.pose_pos, np.rad2deg(raw.pose_theta)))
        return cls(
            identifier=raw.identifier,
            channels=dict(raw.channels),
            transMatOrg=T,
            transMat=T.copy(),
            dalignxf=np.eye(4),
        )

    @classmethod
    def from_points(
        cls, xyz: np.ndarray, identifier: str = "000", pose: np.ndarray | None = None
    ) -> "TPUScan":
        T = np.eye(4) if pose is None else np.asarray(pose, dtype=np.float64)
        return cls(
            identifier=identifier,
            channels={"xyz": np.asarray(xyz, dtype=np.float64)},
            transMatOrg=T,
            transMat=T.copy(),
            dalignxf=np.eye(4),
        )

    # -- pose state -------------------------------------------------------
    @property
    def rPos(self) -> np.ndarray:
        _, pos = math3d.matrix4_to_euler(self.transMat)
        return np.asarray(pos)

    @property
    def rPosTheta(self) -> np.ndarray:
        theta, _ = math3d.matrix4_to_euler(self.transMat)
        return np.asarray(theta)

    def set_reduction(self, voxel: float, nrpts: int) -> None:
        """Ref Scan::setReductionParameter (-r voxel, -R nrpts)."""
        if voxel != self.reduction_voxel or nrpts != self.reduction_nrpts:
            self._reduced_local = None
            self._pad_cache = None
            self.generation += 1
        self.reduction_voxel = voxel
        self.reduction_nrpts = nrpts

    # -- channels ---------------------------------------------------------
    @property
    def xyz(self) -> np.ndarray:
        return self.channels["xyz"]

    def channel(self, name: str) -> np.ndarray:
        return self.channels[name]

    @property
    def size(self) -> int:
        return len(self.channels["xyz"])

    def reduced_local(self, seed: int = 0) -> np.ndarray:
        """Reduced points in the scan's local frame (ref
        calcReducedPoints, scan.cc:432-687: reduction runs on untransformed
        points; we defer the global transform to compute time)."""
        if self._reduced_local is None:
            self._reduced_local = red_ops.reduce_scan(
                self.xyz.astype(np.float32),
                self.reduction_voxel,
                self.reduction_nrpts,
                seed=seed,
            ).astype(np.float64)
        return self._reduced_local

    def reduced_normals_local(self, k: int = 20) -> np.ndarray:
        """Normals of the reduced points in local frame, viewpoint at the
        scanner origin (ref calculateNormalsKNN, normals.cc:220-440; the
        'normal reduced' channel)."""
        if "normal reduced" not in self.channels:
            import jax.numpy as jnp

            from ..ops import normals as normals_ops

            r = self.reduced_local().astype(np.float32)
            mask = np.ones(len(r), bool)
            n = normals_ops.estimate_normals_knn(
                jnp.asarray(r), jnp.asarray(mask), jnp.zeros(3, jnp.float32), k=k
            )
            self.channels["normal reduced"] = np.asarray(n, dtype=np.float64)
        return self.channels["normal reduced"]

    def reduced_normals_padded(self, cap: int) -> np.ndarray:
        n = self.reduced_normals_local()
        out = np.zeros((cap, 3), dtype=np.float32)
        out[: len(n)] = n
        return out

    def reduced_padded(self, cap: int) -> tuple[np.ndarray, np.ndarray]:
        """Reduced local points padded to a static cap: ([cap,3] f32,
        [cap] bool).  Cached per cap (bucketed static shapes avoid
        recompiles — SURVEY §7 'hard parts' #3)."""
        if self._pad_cache is not None and self._pad_cache[0] == cap:
            return self._pad_cache[1], self._pad_cache[2]
        r = self.reduced_local()
        n = len(r)
        if n > cap:
            raise ValueError(f"scan {self.identifier}: {n} reduced points > cap {cap}")
        pts = np.zeros((cap, 3), dtype=np.float32)
        pts[:n] = r
        mask = np.zeros(cap, dtype=bool)
        mask[:n] = True
        self._pad_cache = (cap, pts, mask)
        return pts, mask

    # -- transforms & frames ---------------------------------------------
    def transform(self, align: np.ndarray, algo: AlgoType, record: bool = True) -> None:
        """Left-apply an alignment (ref Scan::transformMatrix,
        scan.cc:878-898): transMat <- align @ transMat, dalignxf <- align
        @ dalignxf.  Appends a frame when record (AlgoType != INVALID in
        the reference's islum logic is handled by the sequence driver)."""
        align = np.asarray(align, dtype=np.float64)
        self.transMat = align @ self.transMat
        self.dalignxf = align @ self.dalignxf
        if record:
            self.add_frame(algo)

    def set_pose(self, T: np.ndarray, algo: AlgoType, record: bool = True) -> None:
        """Set absolute pose (equivalent to transform with T @ inv(transMat))."""
        T = np.asarray(T, dtype=np.float64)
        self.dalignxf = T @ np.asarray(math3d.m4inv(self.transMat)) @ self.dalignxf
        self.transMat = T
        if record:
            self.add_frame(algo)

    def add_frame(self, algo: AlgoType) -> None:
        self.frames.append((self.transMat.copy(), int(algo)))

    # -- global views -----------------------------------------------------
    def points_global(self) -> np.ndarray:
        return np.asarray(math3d.transform3(self.transMat, self.xyz))

    def reduced_global(self) -> np.ndarray:
        return np.asarray(math3d.transform3(self.transMat, self.reduced_local()))
