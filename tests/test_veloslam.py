"""VeloSLAM online driver tests (ref src/veloslam/veloslam.cc:973 main
loop, svm.cc classification)."""

import numpy as np
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models.veloslam import (
    VeloParams, VeloSlam, classify_clusters, cluster_features,
)
from tests.conftest import make_room_cloud


def _moving_scene(rng, n_frames=6, jitter=2.0):
    """Static room + a compact box sweeping through it; scanner drifts
    with odometry error."""
    world = make_room_cloud(rng, n=4000, size=900.0)
    scans = []
    true_poses = []
    box_base = rng.uniform(100, 200, (250, 3)) * np.array([0.8, 0.8, 0.8])
    box_base[:, 1] += 20.0  # above the floor
    for k in range(n_frames):
        pos = np.array([15.0 * k, 0.0, 10.0 * k])
        T_true = np.asarray(math3d.euler_to_matrix4(pos, np.zeros(3)))
        true_poses.append(T_true)
        box = box_base + np.array([90.0 * k, 0.0, 0.0])  # fast mover
        frame_world = np.concatenate([world, box])
        local = np.asarray(
            math3d.transform3(math3d.m4inv(T_true), frame_world)
        )
        d = rng.normal(0, jitter, 3) if k else np.zeros(3)
        T0 = np.asarray(math3d.euler_to_matrix4(pos + d, np.zeros(3)))
        s = TPUScan.from_points(local, f"{k:03d}", pose=T0)
        s.set_reduction(12.0, 1)
        scans.append(s)
    return scans, true_poses


def test_cluster_features_and_classifier():
    rng = np.random.default_rng(0)
    # a compact car-sized blob well above the frame floor
    blob = rng.uniform(0, 1, (300, 3)) * np.array([300, 150, 150])
    blob[:, 1] += 30
    f_blob = cluster_features(blob, frame_min_y=0.0)
    # a large flat wall
    wall = rng.uniform(0, 1, (300, 3)) * np.array([2000, 2000, 2])
    f_wall = cluster_features(wall, frame_min_y=0.0)
    scores = classify_clusters(np.stack([f_blob, f_wall]))
    assert scores[0] > 0, scores  # blob flagged
    assert scores[1] < 0, scores  # wall kept


def test_veloslam_online_loop(rng):
    scans, true_poses = _moving_scene(rng)
    vs = VeloSlam(
        VeloParams(
            tracking=2, sliding_window=3, max_dist_match2=900.0,
            cluster_threshold=50.0, cluster_min_size=15,
        )
    )
    infos = vs.run(scans)
    assert len(infos) == len(scans)
    # moving-object points were detected in most frames
    flagged = [i["n_moving"] for i in infos]
    assert sum(1 for f in flagged if f > 0) >= len(scans) - 2, flagged
    # registration recovered the drifted poses despite the mover
    errs = [
        np.linalg.norm(s.transMat[:3, 3] - T[:3, 3])
        for s, T in zip(scans[1:], true_poses[1:])
    ]
    assert np.median(errs) < 3.0, errs
    # tracker produced tracks and confirmed the mover as dynamic
    assert any(i.get("n_tracks", 0) > 0 for i in infos)
    assert any(i.get("n_dynamic", 0) > 0 for i in infos[3:]), infos


def test_veloslam_static_scene_no_false_dynamics(rng):
    world = make_room_cloud(rng, n=3000, size=700.0)
    scans = []
    for k in range(4):
        T = np.asarray(
            math3d.euler_to_matrix4([10.0 * k, 0, 0], np.zeros(3))
        )
        local = np.asarray(math3d.transform3(math3d.m4inv(T), world))
        s = TPUScan.from_points(local, f"{k:03d}", pose=T)
        s.set_reduction(15.0, 1)
        scans.append(s)
    vs = VeloSlam(VeloParams(tracking=2, max_dist_match2=625.0))
    infos = vs.run(scans)
    assert all(i.get("n_dynamic", 0) == 0 for i in infos), infos
