"""Sequence driver tests: multi-scan registration with odometry
extrapolation + frames logging semantics (doICP, icp6D.cc:374-437)."""

import numpy as np
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.io.frames import AlgoType
from tpu3dtk.models.sequence import SequenceRegistration
from tpu3dtk.models.icp import IcpParams
from tests.conftest import make_room_cloud


def _make_sequence(rng, n_scans=3, drift=4.0):
    """World cloud seen from drifting poses: scan k's points = world
    points in frame of true pose k; .pose odometry is noisy."""
    world = make_room_cloud(rng, n=4000)
    scans = []
    true_poses = []
    for k in range(n_scans):
        theta = np.array([0.0, 0.01 * k, 0.0])
        pos = np.array([10.0 * k, 0.0, 5.0 * k])
        T_true = np.asarray(math3d.euler_to_matrix4(pos, theta))
        true_poses.append(T_true)
        local = np.asarray(math3d.transform3(math3d.m4inv(T_true), world))
        # odometry pose = true pose + noise (except scan 0)
        if k == 0:
            T_odo = T_true
        else:
            noise_t = rng.uniform(-drift, drift, 3)
            noise_r = rng.uniform(-0.01, 0.01, 3)
            T_noise = np.asarray(math3d.euler_to_matrix4(noise_t, noise_r))
            T_odo = T_noise @ T_true
        s = TPUScan.from_points(local, identifier=f"{k:03d}", pose=T_odo)
        s.set_reduction(10.0, 1)
        scans.append(s)
    return scans, true_poses


def test_sequence_registration_converges(rng):
    scans, true_poses = _make_sequence(rng)
    reg = SequenceRegistration(
        params=IcpParams(max_dist_match2=625.0, max_iterations=60, epsilon=1e-7)
    )
    results = reg.run(scans)
    assert len(results) == 2
    for s, T_true in zip(scans, true_poses):
        # position error small vs the injected ~4cm drift
        err = np.linalg.norm(s.transMat[:3, 3] - T_true[:3, 3])
        assert err < 2.0, f"scan {s.identifier}: {err}"


@pytest.mark.parametrize("metascan", [False, True])
def test_mesh_opt_in_matches_single_device(rng, metascan):
    """Sharding is opt-in: the default runs on one device, and
    mesh="auto" (every local device, pair statistics psum-merged) lands
    on the same poses."""
    import jax

    assert SequenceRegistration()._resolve_mesh() is None
    sharded = SequenceRegistration(mesh="auto")._resolve_mesh()
    assert sharded.devices.size == len(jax.devices()) > 1
    scans, _ = _make_sequence(rng)
    copies = [
        TPUScan.from_points(s.xyz, s.identifier, s.transMatOrg)
        for s in scans
    ]
    for c in copies:
        c.set_reduction(10.0, 1)
    params = IcpParams(max_dist_match2=625.0, max_iterations=60, epsilon=1e-7)
    SequenceRegistration(params=params, metascan=metascan).run(scans)
    SequenceRegistration(
        params=params, metascan=metascan, mesh="auto"
    ).run(copies)
    for a, b in zip(scans, copies):
        np.testing.assert_allclose(
            a.transMat[:3, 3], b.transMat[:3, 3], atol=1e-2
        )


def test_metascan_mode(rng):
    scans, true_poses = _make_sequence(rng)
    reg = SequenceRegistration(
        params=IcpParams(max_dist_match2=625.0, max_iterations=60, epsilon=1e-7),
        metascan=True,
    )
    reg.run(scans)
    for s, T_true in zip(scans, true_poses):
        err = np.linalg.norm(s.transMat[:3, 3] - T_true[:3, 3])
        assert err < 2.0


def test_frames_lengths_consistent(rng):
    scans, _ = _make_sequence(rng)
    SequenceRegistration(
        params=IcpParams(max_iterations=20, epsilon=1e-6)
    ).run(scans)
    lens = [len(s.frames) for s in scans]
    assert len(set(lens)) == 1  # every match event logged for every scan
    # final frame of matched scans is ICP-tagged
    assert scans[1].frames[-2][1] in (int(AlgoType.ICP), int(AlgoType.ICPINACTIVE), int(AlgoType.INVALID))


def test_dalignxf_invariant(rng):
    scans, _ = _make_sequence(rng, n_scans=2)
    SequenceRegistration(params=IcpParams(max_iterations=30)).run(scans)
    for s in scans:
        np.testing.assert_allclose(
            s.dalignxf @ s.transMatOrg, s.transMat, atol=1e-8
        )
