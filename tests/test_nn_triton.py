"""Fused Triton brute NN kernel (ops.nn_triton) in the Pallas interpreter:
the same contract as ops.nn.nn_brute, checked against a numpy f64
oracle.  On a GPU the same kernel compiles through Triton
(tests/test_gpu_accuracy.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu3dtk.ops import nn as nn_ops
from tpu3dtk.ops.nn_triton import _plan, nn_brute_triton

nn_interp = functools.partial(nn_brute_triton, interpret=True)


def _oracle(q, m, mmask, max_dist2):
    mv = np.where(mmask[:, None], m.astype(np.float64), np.inf)
    d2 = ((q.astype(np.float64)[:, None, :] - mv[None]) ** 2).sum(-1)
    idx = d2.argmin(1)
    best = d2[np.arange(len(q)), idx]
    return idx, best, best < max_dist2


def _cloud(rng, Q, M, extent, noise=5.0):
    m = rng.uniform(-extent, extent, (M, 3)).astype(np.float32)
    q = (m[rng.integers(0, M, Q)] + rng.normal(0, noise, (Q, 3))).astype(
        np.float32
    )
    return q, m


@pytest.mark.parametrize(
    "Q,M,extent,masked",
    [
        (1, 1, 100.0, False),
        (37, 129, 500.0, False),  # ragged: neither a multiple of a tile
        (300, 1000, 2000.0, True),
        (513, 2049, 800.0, True),
        (200, 700, 3.0e5, False),  # km extents: direct differences
    ],
)
def test_matches_oracle(rng, Q, M, extent, masked):
    q, m = _cloud(rng, Q, M, extent)
    mmask = rng.uniform(size=M) > 0.3 if masked else np.ones(M, bool)
    mmask[0] = True
    qmask = np.ones(Q, bool)
    max_dist2 = 625.0
    idx, d2, found = nn_interp(
        jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(m),
        jnp.asarray(mmask), jnp.float32(max_dist2),
    )
    ridx, rd2, rfound = _oracle(q, m, mmask, max_dist2)
    idx, d2, found = map(np.asarray, (idx, d2, found))
    np.testing.assert_array_equal(found, rfound)
    assert mmask[idx[found]].all()
    # exact recompute of the winner: f32 d2 of the oracle's minimum
    np.testing.assert_allclose(d2[found], rd2[found], rtol=1e-5, atol=1e-3)
    assert (idx[found] == ridx[found]).mean() > 0.99


def test_all_masked_model_finds_nothing(rng):
    q, m = _cloud(rng, 50, 200, 100.0)
    idx, d2, found = nn_interp(
        jnp.asarray(q), jnp.ones(50, bool), jnp.asarray(m),
        jnp.zeros(200, bool), jnp.float32(1e12),
    )
    assert not np.asarray(found).any()
    assert (np.asarray(idx) >= 0).all() and (np.asarray(idx) < 200).all()


def test_strict_boundary_and_query_mask():
    """Reference kd-tree boundary semantics (testing/kdtree/kdtree.cc):
    a neighbour at exactly max_dist is rejected; masked queries never
    match."""
    m = jnp.asarray([[10.0, 0.0, 0.0]], jnp.float32)
    q = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    one = jnp.ones(1, bool)
    qm = jnp.asarray([True, False])
    _, _, found = nn_interp(q, qm, m, one, jnp.float32(100.0))
    assert not np.asarray(found).any()
    _, _, found = nn_interp(q, qm, m, one, jnp.float32(100.01))
    np.testing.assert_array_equal(np.asarray(found), [True, False])


def test_under_vmap(rng):
    """Batched link NN (graphslam-style vmap over scan pairs)."""
    B, Q, M = 3, 64, 300
    qs, ms = zip(*[_cloud(rng, Q, M, 400.0) for _ in range(B)])
    qs, ms = np.stack(qs), np.stack(ms)
    f = jax.vmap(
        lambda q, m: nn_interp(
            q, jnp.ones(Q, bool), m, jnp.ones(M, bool), jnp.float32(625.0)
        )
    )
    idx, d2, found = f(jnp.asarray(qs), jnp.asarray(ms))
    for b in range(B):
        ridx, rd2, rfound = _oracle(qs[b], ms[b], np.ones(M, bool), 625.0)
        np.testing.assert_array_equal(np.asarray(found[b]), rfound)
        np.testing.assert_allclose(
            np.asarray(d2[b])[rfound], rd2[rfound], rtol=1e-5, atol=1e-3
        )


def test_inside_fori_loop_matches_xla_brute(rng):
    """The ICP shape: NN inside a jitted fori_loop that moves the
    queries every iteration, against ops.nn.nn_brute."""
    q, m = _cloud(rng, 256, 1024, 600.0)
    qm, mm = jnp.ones(256, bool), jnp.ones(1024, bool)

    def run(nn):
        def body(i, acc):
            qi = jnp.asarray(q) + i.astype(jnp.float32) * 0.5
            _, d2, found = nn(qi, qm, jnp.asarray(m), mm, jnp.float32(625.0))
            return acc + jnp.sum(jnp.where(found, d2, 0.0))

        return jax.jit(
            lambda: jax.lax.fori_loop(0, 3, body, jnp.float32(0.0))
        )()

    np.testing.assert_allclose(
        float(run(nn_interp)), float(run(nn_ops.nn_brute)), rtol=1e-5
    )


@pytest.mark.parametrize(
    "Q,M,want",
    [
        # (BQ, BM, Qp, splits, tiles per split)
        (16384, 16384, (64, 64, 16384, 4, 64)),
        (100, 37, (64, 64, 128, 1, 1)),
        (5, 3, (16, 16, 16, 1, 1)),
        (262144, 262144, (64, 64, 262144, 1, 4096)),
    ],
)
def test_plan_tiles_and_splits(Q, M, want):
    """Power-of-two tiles; model splits until 16k queries give >= 1024
    programs while each split keeps >= 8 model tiles."""
    assert _plan(Q, M, 64, 64, 1024) == want
