"""NN kernel tests: equivalence with numpy brute force and the
reference's kd boundary semantics (testing/kdtree/kdtree.cc:20-60:
strict exclusion at exactly maxdist^2; nearest of several)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu3dtk.ops import nn


def _np_nn(q, m, max_d2):
    d2 = ((q[:, None, :] - m[None]) ** 2).sum(-1)
    idx = d2.argmin(1)
    best = d2[np.arange(len(q)), idx]
    return idx, best, best < max_d2


def test_brute_matches_numpy(rng):
    q = rng.uniform(-100, 100, (257, 3)).astype(np.float32)
    m = rng.uniform(-100, 100, (499, 3)).astype(np.float32)
    qm = np.ones(len(q), bool)
    mm = np.ones(len(m), bool)
    idx, d2, found = nn.nn_brute(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(m), jnp.asarray(mm), 400.0)
    ridx, rd2, rfound = _np_nn(q, m, 400.0)
    np.testing.assert_array_equal(np.asarray(found), rfound)
    np.testing.assert_allclose(np.asarray(d2), rd2, rtol=1e-4, atol=1e-2)
    # matched indices must point at equally-near points (ties allowed)
    np.testing.assert_allclose(
        np.linalg.norm(m[np.asarray(idx)] - q, axis=1)[rfound],
        np.sqrt(rd2)[rfound],
        rtol=1e-4, atol=1e-2,
    )


def test_boundary_exclusion():
    """Point exactly at distance maxdist must NOT match (kdtree.cc:20-27)."""
    q = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    m = jnp.asarray([[10.0, 0.0, 0.0]], jnp.float32)
    one = jnp.ones(1, bool)
    _, _, found = nn.nn_brute(q, one, m, one, 100.0)
    assert not bool(found[0])
    _, _, found = nn.nn_brute(q, one, m, one, 100.0001)
    assert bool(found[0])


def test_nearest_of_several():
    """kdtree.cc:29-45: returns the true nearest among candidates."""
    q = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    m = jnp.asarray(
        [[5.0, 0, 0], [-3.0, 0, 0], [0, 4.0, 0], [0, 0, -2.0]], jnp.float32
    )
    one = jnp.ones(1, bool)
    idx, d2, found = nn.nn_brute(q, one, m, jnp.ones(4, bool), 1e9)
    assert bool(found[0])
    assert int(idx[0]) == 3
    np.testing.assert_allclose(float(d2[0]), 4.0, rtol=1e-6)


def test_masked_model_points_ignored():
    q = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    m = jnp.asarray([[1.0, 0, 0], [50.0, 0, 0]], jnp.float32)
    mm = jnp.asarray([False, True])
    idx, d2, found = nn.nn_brute(q, jnp.ones(1, bool), m, mm, 1e9)
    assert int(idx[0]) == 1


def test_brute_large_extent_precision(rng):
    """Large coordinate extents must not break the accept test (f32
    matmul-expansion cancellation regression)."""
    M = 5000
    m = rng.uniform(0, 4000, (M, 3)).astype(np.float32)
    q = (m + rng.normal(0, 5, (M, 3))).astype(np.float32)
    mask = jnp.ones(M, bool)
    idx, d2, found = nn.nn_brute(
        jnp.asarray(q), mask, jnp.asarray(m), mask, 625.0
    )
    ridx, rd2, rfound = _np_nn(q, m, 625.0)
    assert (np.asarray(found) == rfound).mean() > 0.999
    sel = np.asarray(found) & rfound
    np.testing.assert_allclose(np.asarray(d2)[sel], rd2[sel], rtol=1e-3, atol=0.5)


def test_grid_nn_matches_brute(rng):
    m = rng.uniform(0, 200, (2000, 3)).astype(np.float32)
    q = rng.uniform(0, 200, (513, 3)).astype(np.float32)
    max_d = 15.0
    cell = max_d
    origin = jnp.zeros(3, jnp.float32)
    dims = (14, 14, 14)  # ceil(200/15)
    g = nn.build_grid(jnp.asarray(m), jnp.ones(len(m), bool), origin, cell, dims)
    occ = int(jnp.max(jnp.diff(g.cell_start)))
    idx, d2, found = nn.nn_grid(
        jnp.asarray(q), jnp.ones(len(q), bool), g, max_d**2, dims, bucket_cap=max(occ, 1)
    )
    ridx, rd2, rfound = _np_nn(q, m, max_d**2)
    np.testing.assert_array_equal(np.asarray(found), rfound)
    np.testing.assert_allclose(np.asarray(d2)[rfound], rd2[rfound], rtol=1e-4, atol=1e-2)
    # matched model point identical
    np.testing.assert_array_equal(np.asarray(idx)[rfound], ridx[rfound])


# ---------------------------------------------------------------------------
# Hashed cell list (production NN for the hot loops)
# ---------------------------------------------------------------------------


def _cell_hash_setup(model, mmask, query, qmask, max_dist):
    import jax.numpy as jnp

    from tpu3dtk.ops import nn as nn_ops

    H, cap = nn_ops.cell_hash_spec(model, mmask, max_dist)
    origin = model[mmask].min(axis=0)
    grid = nn_ops.build_cell_hash(
        jnp.asarray(model), jnp.asarray(mmask), jnp.asarray(origin),
        jnp.float32(max_dist), H,
    )
    return nn_ops.nn_cell_hash(
        jnp.asarray(query), jnp.asarray(qmask), grid,
        jnp.float32(max_dist**2), cap,
    )


def test_cell_hash_matches_brute_adversarial(rng):
    """Exactness vs brute at adversarial density: a tight Gaussian
    cluster (hundreds of points per cell), uniform background, masked
    points, and queries far outside the model bbox."""
    import numpy as np

    from tpu3dtk.ops import nn as nn_ops

    model = np.concatenate(
        [
            rng.uniform(-500, 500, (2000, 3)),
            rng.normal(0, 2.0, (1500, 3)),  # dense cluster
            rng.uniform(-500, 500, (500, 3)),
        ]
    ).astype(np.float32)
    mmask = rng.random(len(model)) > 0.15
    query = np.concatenate(
        [
            rng.uniform(-700, 700, (1000, 3)),  # incl. outside bbox
            rng.normal(0, 3.0, (1000, 3)),
        ]
    ).astype(np.float32)
    qmask = rng.random(len(query)) > 0.05
    import jax.numpy as jnp

    i1, d1, f1 = map(np.asarray, _cell_hash_setup(model, mmask, query, qmask, 25.0))
    i0, d0, f0 = map(
        np.asarray,
        nn_ops.nn_brute(
            jnp.asarray(query), jnp.asarray(qmask), jnp.asarray(model),
            jnp.asarray(mmask), jnp.float32(625.0),
        ),
    )
    assert (f1 == f0).all()
    assert f0.sum() > 100  # non-trivial workload
    np.testing.assert_allclose(d1[f0], d0[f0], rtol=1e-5)
    assert (i1[f0] == i0[f0]).all()


def test_cell_hash_strict_boundary(rng):
    """Matches exactly AT max_dist are rejected (strict <), the kd-tree
    boundary semantics of ref testing/kdtree/kdtree.cc:20-27."""
    import numpy as np

    model = np.array([[10.0, 0.0, 0.0], [200.0, 0.0, 0.0]], np.float32)
    query = np.array([[0.0, 0.0, 0.0]], np.float32)
    # max_dist exactly 10: d2 == max_dist2 -> rejected
    i, d, f = _cell_hash_setup(
        model, np.ones(2, bool), query, np.ones(1, bool), 10.0
    )
    assert not bool(np.asarray(f)[0])
    # slightly larger: accepted
    i, d, f = _cell_hash_setup(
        model, np.ones(2, bool), query, np.ones(1, bool), 10.001
    )
    assert bool(np.asarray(f)[0])
    assert int(np.asarray(i)[0]) == 0


def test_cell_hash_occupancy_check(rng):
    """Device-side max-occupancy matches the host spec sizing."""
    import jax.numpy as jnp
    import numpy as np

    from tpu3dtk.ops import nn as nn_ops

    pts = rng.normal(0, 1.5, (3000, 3)).astype(np.float32)
    mask = np.ones(3000, bool)
    H, cap = nn_ops.cell_hash_spec(pts, mask, 25.0)
    grid = nn_ops.build_cell_hash(
        jnp.asarray(pts), jnp.asarray(mask),
        jnp.asarray(pts.min(axis=0)), jnp.float32(25.0), H,
    )
    occ = int(nn_ops.cell_hash_max_occupancy(grid))
    assert occ <= cap
    assert cap < occ + 16  # spec is tight (rounded to multiple of 8)


def test_brute_line_large_extent_precision(rng):
    """Normal-shoot NN on a large-extent cloud (bremen-scale offsets):
    the centered expansion + exact winner recompute must rank correctly
    where the naive |q|²+|m|²−2q·m form loses ~eps·|coord|²."""
    import jax.numpy as jnp
    import numpy as np

    from tpu3dtk.ops import nn as nn_ops

    off = np.array([50000.0, -30000.0, 80000.0], np.float32)
    model = (rng.normal(0, 10, (500, 3)) + off).astype(np.float32)
    query = (model[:100] + rng.normal(0, 1, (100, 3))).astype(np.float32)
    qdir = rng.normal(0, 1, (100, 3))
    qdir = (qdir / np.linalg.norm(qdir, axis=1, keepdims=True)).astype(
        np.float32
    )
    idx, d2, found = nn_ops.nn_brute_line(
        jnp.asarray(query), jnp.asarray(qdir), jnp.ones(100, bool),
        jnp.asarray(model), jnp.ones(500, bool), jnp.float32(625.0),
    )
    # f64 oracle
    q64, m64, dir64 = query.astype(np.float64), model.astype(np.float64), qdir.astype(np.float64)
    diff = m64[None, :, :] - q64[:, None, :]
    proj = np.einsum("qmk,qk->qm", diff, dir64)
    d2_all = np.sum(diff * diff, axis=-1) - proj * proj
    want = d2_all.argmin(axis=1)
    got = np.asarray(idx)
    # allow ties within float noise
    assert np.all(
        np.abs(d2_all[np.arange(100), got] - d2_all[np.arange(100), want])
        < 1e-3
    )
    assert np.all(np.asarray(d2) >= -1e-3)
