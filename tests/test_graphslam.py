"""LUM GraphSLAM tests: the numeric regression suite the reference
lacks (SURVEY §4) — known pose noise on a loop of scans must shrink."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import graphslam as gs
from tests.conftest import make_room_cloud


def test_build_proximity_graph():
    pos = np.array(
        [[0, 0, 0], [100, 0, 0], [200, 0, 0], [200, 100, 0], [5, 5, 0]],
        dtype=float,
    )
    links = gs.build_proximity_graph(pos, cldist2=50.0**2, loopsize=2)
    link_set = {tuple(l) for l in links.tolist()}
    # consecutive chain
    assert {(0, 1), (1, 2), (2, 3), (3, 4)} <= link_set
    # proximity loop 0-4 (|4-0| > 2, dist ~7)
    assert (0, 4) in link_set
    # no long-distance link 0-2
    assert (0, 2) not in link_set


def _ring_scans(rng, n=5, noise_t=3.0, noise_r=0.01):
    """Scans around a ring viewing one world cloud; ground truth poses
    on the ring, odometry-noised initial poses, scan 0 fixed."""
    world = make_room_cloud(rng, n=3000, size=800.0)
    scans, true_poses = [], []
    for k in range(n):
        ang = 0.25 * k
        pos = np.array([300 * np.cos(ang), 0.0, 300 * np.sin(ang)])
        theta = np.array([0.0, 0.1 * k, 0.0])
        T_true = np.asarray(math3d.euler_to_matrix4(pos, theta))
        true_poses.append(T_true)
        local = np.asarray(math3d.transform3(math3d.m4inv(T_true), world))
        if k == 0:
            T0 = T_true
        else:
            nt = rng.uniform(-noise_t, noise_t, 3)
            nr = rng.uniform(-noise_r, noise_r, 3)
            T0 = np.asarray(math3d.euler_to_matrix4(nt, nr)) @ T_true
        s = TPUScan.from_points(local, f"{k:03d}", pose=T0)
        s.set_reduction(15.0, 1)
        scans.append(s)
    return scans, true_poses


def _pose_err(scans, true_poses):
    return np.mean(
        [
            np.linalg.norm(s.transMat[:3, 3] - T[:3, 3])
            for s, T in zip(scans, true_poses)
        ]
    )


def test_lum_reduces_pose_error(rng):
    scans, true_poses = _ring_scans(rng)
    before = _pose_err(scans, true_poses)
    links = gs.build_proximity_graph(
        np.stack([s.rPos for s in scans]), cldist2=1e9, loopsize=0
    )
    ret = gs.do_graph_slam(
        scans, links, gs.LumParams(max_dist_match2=2500.0, iterations=25, epsilon=0.01)
    )
    after = _pose_err(scans, true_poses)
    assert after < before * 0.5, (before, after)
    assert ret < 1.0


def test_lum_identity_is_stable(rng):
    """Perfect poses: LUM must not move them."""
    scans, true_poses = _ring_scans(rng, noise_t=0.0, noise_r=0.0)
    links = gs.build_proximity_graph(
        np.stack([s.rPos for s in scans]), cldist2=1e9, loopsize=0
    )
    gs.do_graph_slam(
        scans, links, gs.LumParams(max_dist_match2=2500.0, iterations=3, epsilon=1e-6)
    )
    assert _pose_err(scans, true_poses) < 0.5


def test_link_covariance_identity_pair(rng):
    """Same cloud twice: pose difference estimate D ~ 0 and the
    identical-cloud guard (ss < 1e-13 -> C = 0) triggers."""
    cloud = make_room_cloud(rng, n=1000)
    k = len(cloud)
    pts = np.zeros((2, 1024, 3), np.float32)
    msk = np.zeros((2, 1024), bool)
    pts[0, :k] = cloud
    pts[1, :k] = cloud
    msk[:, :k] = True
    links = np.array([[0, 1]], np.int32)
    C, CD, m = gs.link_covariances(
        jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(links), jnp.float32(2500.0)
    )
    assert float(m[0]) == float(k)
    np.testing.assert_allclose(np.asarray(C[0]), 0.0, atol=1e-5)


def test_frames_tagged_lum(rng):
    scans, _ = _ring_scans(rng, n=3)
    links = gs.build_proximity_graph(
        np.stack([s.rPos for s in scans]), cldist2=1e9, loopsize=0
    )
    gs.do_graph_slam(
        scans, links, gs.LumParams(max_dist_match2=2500.0, iterations=2, epsilon=1e-9)
    )
    from tpu3dtk.io.frames import AlgoType

    assert scans[1].frames[-1][1] == int(AlgoType.LUM)
    assert len({len(s.frames) for s in scans}) == 1


def test_read_net_graph(tmp_path):
    p = tmp_path / "g.net"
    p.write_text("4\n3\n0 1\n1 2\n3 0\n")
    links = gs.read_net_graph(str(p))
    np.testing.assert_array_equal(links, [[0, 1], [1, 2], [3, 0]])
    bad = tmp_path / "bad.net"
    bad.write_text("2\n1\n0 5\n")
    with pytest.raises(ValueError):
        gs.read_net_graph(str(bad))


def test_link_covariances_grid_matches_brute(rng):
    """Hashed-cell-list LUM covariances equal the brute path."""
    import jax.numpy as jnp
    import numpy as np

    from tests.conftest import make_room_cloud
    from tpu3dtk.models import graphslam as gs
    from tpu3dtk.ops import nn as nn_ops

    S, N = 4, 2400
    pts = np.zeros((S, N, 3), np.float32)
    masks = np.zeros((S, N), bool)
    for i in range(S):
        c = make_room_cloud(rng, n=N, size=700.0)
        c += np.array([i * 5.0, 0, 0])
        n = N - i * 100  # ragged
        pts[i, :n] = c[:n]
        masks[i, :n] = True
    links = np.array([[0, 1], [1, 2], [2, 3], [0, 3]], np.int32)
    md2 = jnp.float32(2500.0)
    # f64 oracle: exact NN pairs per link via scipy cKDTree
    from scipy.spatial import cKDTree

    H = cap = 0
    for i in range(S):
        Hs, bc = nn_ops.cell_hash_spec(pts[i][masks[i]], masks[i][masks[i]], 50.0)
        H, cap = max(H, Hs), max(cap, bc)
    C1, CD1, m1, overflow = gs.link_covariances_grid(
        jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(links), md2,
        n_buckets=H, bucket_cap=cap,
    )
    assert not bool(overflow)
    # grid NN idx/found equal the exact oracle on every link
    grids = None
    for (i, j) in links:
        mi, mj = masks[i], masks[j]
        tree = cKDTree(pts[i][mi].astype(np.float64))
        d, k = tree.query(pts[j].astype(np.float64))
        found0 = mj & (d**2 < 2500.0)
        origin = pts[i][mi].min(axis=0)
        g = nn_ops.build_cell_hash(
            jnp.asarray(pts[i]), jnp.asarray(mi), jnp.asarray(origin),
            jnp.float32(50.0), H,
        )
        idx1, d21, found1 = nn_ops.nn_cell_hash(
            jnp.asarray(pts[j]), jnp.asarray(mj), g, md2, cap
        )
        idx1, found1 = np.asarray(idx1), np.asarray(found1)
        assert (found1 == found0).all()
        # map oracle index (within masked subset) back to padded index
        midx = np.flatnonzero(mi)
        sel = found0
        assert (idx1[sel] == midx[np.clip(k, 0, len(midx) - 1)][sel]).all()
    # pair counts match the oracle
    m_oracle = []
    for (i, j) in links:
        tree = cKDTree(pts[i][masks[i]].astype(np.float64))
        d, k = tree.query(pts[j][masks[j]].astype(np.float64))
        m_oracle.append((d**2 < 2500.0).sum())
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m_oracle))


def test_link_covariances_grid_overflow_flag(rng):
    """A pathological cluster overflows bucket_cap and raises the flag."""
    import jax.numpy as jnp
    import numpy as np

    from tpu3dtk.models import graphslam as gs

    S, N = 2, 1000
    pts = np.asarray(rng.normal(0, 0.5, (S, N, 3)), np.float32)  # one cell
    masks = np.ones((S, N), bool)
    links = np.array([[0, 1]], np.int32)
    _, _, _, overflow = gs.link_covariances_grid(
        jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(links),
        jnp.float32(2500.0), n_buckets=1024, bucket_cap=8,
    )
    assert bool(overflow)
