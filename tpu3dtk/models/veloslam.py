"""VeloSLAM — online SLAM with moving-object detection and tracking,
the JAX-native ``veloslam`` driver (ref src/veloslam/veloslam.cc:973
main loop: per frame FindingAllofObject → Classifi[byTracking]AllObject
→ remove moving points → sliding-window ICP → tracker update; cluster
classification in the reference is an SVM over hand-crafted cluster
features, src/veloslam/svm.cc).

Batched design: segmentation + feature extraction run vectorized per frame;
classification is a LINEAR scorer over the same feature family the
reference's SVM consumes (extent/height/density/shape eigenvalues) —
weights are data-free defaults tuned for vehicle/pedestrian-sized
clusters and can be replaced by learned ones; matching is the resident
windowed ICP (models.icp) against the last ``sliding_window`` scans;
tracking is the Kalman+Hungarian core (models.tracking) with
classify-by-tracking feeding confirmed-dynamic clusters back into the
point removal (the reference's tracking==2 mode).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import math3d
from ..core.scan import TPUScan
from ..io.frames import AlgoType
from ..ops.normals import sym3_eigenvalues
from . import icp as icp_mod
from .segmentation import FHParams, fh_segmentation
from .tracking import MultiObjectTracker, TrackerParams

__all__ = [
    "VeloParams",
    "cluster_features",
    "classify_clusters",
    "VeloSlam",
]


@dataclasses.dataclass
class VeloParams:
    tracking: int = 2           # 0 off, 1 classify, 2 classify-by-tracking
    sliding_window: int = 3     # scans in the match window (ref
    # sliding_window_size)
    max_dist_match2: float = 625.0
    max_iterations: int = 50
    epsilon: float = 1e-5
    cluster_threshold: float = 60.0
    cluster_min_size: int = 20
    # object-candidate gates (cm): the reference's vehicle/pedestrian
    # size priors (veloscan.cc cluster classification)
    min_extent: float = 30.0
    max_extent: float = 700.0
    max_height: float = 350.0
    pad_multiple: int = 4096


# feature vector: [extent_xz, height, log_count, planarity, linearity,
# sphericity, height_above_min]
_N_FEATS = 7

# default linear weights: positive score = moving-object candidate —
# compact volumetric clusters score high; large extents and planar
# sheets (walls/ground) score strongly negative
_DEFAULT_W = np.array([-0.004, 0.0, 0.1, -3.0, 0.0, 3.0, 0.005])
_DEFAULT_B = 0.5


def cluster_features(pts: np.ndarray, frame_min_y: float) -> np.ndarray:
    """Per-cluster features (the svm.cc feature family)."""
    import jax.numpy as jnp

    lo = pts.min(0)
    hi = pts.max(0)
    extent_xz = float(np.hypot(hi[0] - lo[0], hi[2] - lo[2]))
    height = float(hi[1] - lo[1])
    c = pts - pts.mean(0)
    cov = c.T @ c / max(len(pts), 1)
    lam = np.sort(
        np.asarray(sym3_eigenvalues(jnp.asarray(cov[None])))[0]
    )  # ascending
    s = max(float(lam.sum()), 1e-9)
    planarity = float((lam[1] - lam[0]) / s)
    linearity = float((lam[2] - lam[1]) / s)
    sphericity = float(lam[0] / s) * 3.0
    return np.array(
        [
            extent_xz,
            height,
            np.log(max(len(pts), 1)),
            planarity,
            linearity,
            sphericity,
            float(lo[1] - frame_min_y),
        ]
    )


def classify_clusters(
    feats: np.ndarray, weights=None, bias: float | None = None
) -> np.ndarray:
    """Linear moving-object scores for [K, 7] features; > 0 = candidate
    (the SVM decision role, svm.cc)."""
    w = _DEFAULT_W if weights is None else np.asarray(weights)
    b = _DEFAULT_B if bias is None else bias
    if len(feats) == 0:
        return np.zeros(0)
    return feats @ w + b


class VeloSlam:
    """Streaming per-frame SLAM + moving-object handling."""

    def __init__(self, params: VeloParams | None = None):
        self.params = params or VeloParams()
        self.tracker = MultiObjectTracker(
            TrackerParams(
                cluster_threshold=self.params.cluster_threshold,
                cluster_min_size=self.params.cluster_min_size,
            )
        )
        self.window: list[np.ndarray] = []  # global static points
        self.trajectory: list[np.ndarray] = []
        self._dynamic_boxes: list[tuple] = []  # confirmed by tracking
        self.infos: list[dict] = []

    # -- per-frame pipeline --------------------------------------------
    def _segment_and_classify(self, pts_local: np.ndarray):
        p = self.params
        labels = fh_segmentation(
            pts_local,
            FHParams(
                k=6, threshold=p.cluster_threshold,
                min_size=p.cluster_min_size,
            ),
        )
        frame_min_y = float(pts_local[:, 1].min())
        moving = np.zeros(len(pts_local), bool)
        clusters = []
        for lab in np.unique(labels):
            sel = labels == lab
            pts = pts_local[sel]
            if len(pts) < p.cluster_min_size:
                continue
            lo = pts.min(0)
            hi = pts.max(0)
            extent = float(np.hypot(hi[0] - lo[0], hi[2] - lo[2]))
            if not (p.min_extent <= extent <= p.max_extent):
                continue
            if hi[1] - lo[1] > p.max_height:
                continue
            f = cluster_features(pts, frame_min_y)
            clusters.append((sel, pts, f))
        if clusters and p.tracking >= 1:
            feats = np.stack([f for _, _, f in clusters])
            scores = classify_clusters(feats)
            for (sel, _, _), s in zip(clusters, scores):
                if s > 0:
                    moving[sel] = True
        return moving, clusters

    def process_scan(self, scan: TPUScan) -> dict:
        """One frame of the veloslam main loop.  Mutates the scan pose;
        returns per-frame info."""
        import jax.numpy as jnp

        p = self.params
        pts_local = np.asarray(scan.reduced_local())
        moving, clusters = self._segment_and_classify(pts_local)

        # classify-by-tracking: clusters overlapping a confirmed dynamic
        # track's gate are removed too (tracking==2 window logic)
        if p.tracking == 2 and self._dynamic_boxes:
            T_prev = scan.transMat
            for sel, pts, _ in clusters:
                c_g = np.asarray(
                    math3d.transform3(T_prev, pts.mean(0)[None])
                )[0]
                for lo, hi in self._dynamic_boxes:
                    pad = 100.0
                    if np.all(c_g >= lo - pad) and np.all(c_g <= hi + pad):
                        moving[sel] = True
                        break

        static_local = pts_local[~moving]
        info = {
            "identifier": scan.identifier,
            "n_points": len(pts_local),
            "n_moving": int(moving.sum()),
            "n_clusters": len(clusters),
        }

        # sliding-window ICP (MatchTwoScan with window metascan)
        if self.window:
            model = np.concatenate(self.window)
            cap_m = self._round_up(len(model))
            cap_t = self._round_up(len(static_local))
            mp = np.zeros((cap_m, 3), np.float32)
            mp[: len(model)] = model
            mm = np.zeros(cap_m, bool)
            mm[: len(model)] = True
            tp = np.zeros((cap_t, 3), np.float32)
            tp[: len(static_local)] = static_local
            tm = np.zeros(cap_t, bool)
            tm[: len(static_local)] = True
            res = icp_mod.icp_pair(
                jnp.asarray(mp), jnp.asarray(mm), jnp.asarray(tp),
                jnp.asarray(tm),
                jnp.asarray(scan.transMat.astype(np.float32)),
                max_dist_match2=p.max_dist_match2,
                epsilon=p.epsilon,
                max_iterations=p.max_iterations,
            )
            T = np.asarray(res.T, np.float64)
            u, _, vt = np.linalg.svd(T[:3, :3])
            T[:3, :3] = u @ vt
            scan.set_pose(T, AlgoType.ICP)
            info["iterations"] = int(res.iterations)
            info["error"] = float(res.error)
        else:
            scan.add_frame(AlgoType.ICP)

        # tracker update with GLOBAL cluster centroids
        if p.tracking >= 1 and clusters:
            cents = np.stack(
                [
                    np.asarray(
                        math3d.transform3(scan.transMat, pts.mean(0)[None])
                    )[0]
                    for _, pts, _ in clusters
                ]
            )
            tracks = self.tracker.step(cents)
            self._dynamic_boxes = []
            for t in tracks:
                if (
                    t.hits >= self.tracker.params.min_hits_dynamic
                    and t.displacement > self.tracker.params.min_motion
                ):
                    self._dynamic_boxes.append(
                        (t.pos - 150.0, t.pos + 150.0)
                    )
            info["n_tracks"] = len(tracks)
            info["n_dynamic"] = len(self._dynamic_boxes)

        # maintain the sliding window with the STATIC global points
        static_g = np.asarray(
            math3d.transform3(scan.transMat, static_local)
        ).astype(np.float32)
        self.window.append(static_g)
        if len(self.window) > p.sliding_window:
            self.window.pop(0)
        self.trajectory.append(scan.transMat[:3, 3].copy())
        self.infos.append(info)
        return info

    def _round_up(self, n: int) -> int:
        m = self.params.pad_multiple
        return max(((n + m - 1) // m) * m, m)

    def run(self, scans: list[TPUScan]) -> list[dict]:
        return [self.process_scan(s) for s in scans]
