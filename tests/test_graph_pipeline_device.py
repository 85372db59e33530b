"""Equivalence of the device-resident segmented GraphPipeline with the
per-match host loop: same poses, same frames
records, same loop closures — the segmented driver only changes WHERE
the sequential loop and the loop detector (slam6D.cc:479-489) run, not
what they compute.
"""

import numpy as np
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models.graph_pipeline import GraphPipeline
from tpu3dtk.models.icp import IcpParams


def _circuit_scans(n_scans=24, n_pts=900, seed=3):
    """Closed circuit through a pillared hall, odometry with drift —
    small cousin of scripts/make_golden.synth_loop."""
    rng = np.random.default_rng(seed)
    size = 2000.0
    walls = []
    for axis in range(3):
        for side in (0.0, size):
            p = rng.uniform(0, size, (1800, 3))
            p[:, axis] = side
            walls.append(p)
    env = np.concatenate(walls)
    scans = []
    drift = np.zeros(3)
    for k in range(n_scans):
        ang = 2 * np.pi * k / n_scans
        center = np.array(
            [size / 2 + 600 * np.cos(ang), size / 2, size / 2 + 600 * np.sin(ang)]
        )
        T = np.asarray(
            math3d.euler_to_matrix4(center, np.array([0.0, -ang, 0.0]), xp=np)
        )
        d2 = ((env - center) ** 2).sum(1)
        vis = env[d2 < 900.0**2]
        vis = vis[rng.permutation(len(vis))[:n_pts]]
        Ti = np.linalg.inv(T)
        local = vis @ Ti[:3, :3].T + Ti[:3, 3]
        local += rng.normal(0, 1.0, local.shape)
        drift += rng.normal(0, 3.0, 3)
        To = T.copy()
        To[:3, 3] += drift
        s = TPUScan.from_points(local.astype(np.float32), f"{k:03d}", To)
        s.set_reduction(20.0, 1)
        s.reduced_local()
        scans.append(s)
    return scans


def _pipe(device_segments):
    return GraphPipeline(
        icp_params=IcpParams(
            max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6
        ),
        lum_max_dist2=2500.0,
        lum_iterations=5,
        lum_epsilon=0.1,
        elch=True,
        cldist=500.0,
        loopsize=6,
        seq_mesh=None,      # force the single-program path on the CPU tier
        lum_mesh=None,
        device_segments=device_segments,
    )


def _copy_scans(scans):
    out = []
    for s in scans:
        c = TPUScan.from_points(
            np.array(s.reduced_local()), s.identifier, s.transMatOrg.copy()
        )
        c._reduced_local = s.reduced_local()
        out.append(c)
    return out


def test_segmented_matches_host_loop():
    scans = _circuit_scans()
    host_scans = _copy_scans(scans)
    dev_scans = _copy_scans(scans)

    res_host = _pipe(device_segments=False).run(host_scans)
    res_dev = _pipe(device_segments=True).run(dev_scans)

    assert len(res_host) == len(res_dev) == len(scans) - 1
    # identical match schedule (same identifiers in order)
    assert [r["identifier"] for r in res_host] == [
        r["identifier"] for r in res_dev
    ]
    # frames record counts agree up to LUM-convergence boundary flips
    # (each LUM iteration appends one frame per scan; tiny f32-vs-f64
    # pose differences can move the convergence test by an iteration)
    for h, d in zip(host_scans, dev_scans):
        assert abs(len(h.frames) - len(d.frames)) <= 3
    # poses agree (f32 accumulation + Newton-vs-SVD orthonormalization
    # are the only differences)
    for h, d in zip(host_scans, dev_scans):
        np.testing.assert_allclose(
            h.transMat[:3, 3], d.transMat[:3, 3], atol=0.5
        )
        np.testing.assert_allclose(
            h.transMat[:3, :3], d.transMat[:3, :3], atol=1e-3
        )
    # and the trajectory is actually good (closed circuit recovered)
    for d in dev_scans:
        assert np.isfinite(d.transMat).all()


def test_segmented_runs_without_closure():
    """No closure in range: one single segment covers the sequence."""
    scans = _circuit_scans(n_scans=8)
    p = _pipe(device_segments=True)
    p.elch = False
    p.cldist = 1.0  # nothing ever within closure distance
    res = p.run(scans)
    assert len(res) == 7
    assert all(np.isfinite(s.transMat).all() for s in scans)


def test_corr_cache_matches_uncached():
    """The correspondence-cached closure path (lum_step_cached +
    link_cov_cached, round-5 perf work) must match the uncached
    recompute-everything path up to pairings that flipped inside the
    drift tolerance — small pose deltas, same trajectory quality."""
    scans = _circuit_scans()
    a_scans = _copy_scans(scans)
    b_scans = _copy_scans(scans)

    def pipe():
        p = _pipe(device_segments=False)
        p.closure_lum_iterations = 1  # the cached 1-iteration relax
        return p

    pa = pipe()
    pa.run(a_scans)
    assert pa._lum_corr_cache.n_refresh > 0
    assert pa._elch_corr_cache.n_refresh > 0

    pb = pipe()
    orig = pb._prepare_statics

    def no_cache(scans_):
        orig(scans_)
        pb._lum_corr_cache = None
        pb._elch_corr_cache = None

    pb._prepare_statics = no_cache
    pb.run(b_scans)

    for a, b in zip(a_scans, b_scans):
        np.testing.assert_allclose(
            a.transMat[:3, 3], b.transMat[:3, 3], atol=2.0
        )
        np.testing.assert_allclose(
            a.transMat[:3, :3], b.transMat[:3, :3], atol=5e-3
        )
