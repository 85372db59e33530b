"""Trajectory curve fusion — the JAX-native ``curvefusion`` module
(ref src/curvefusion/: curves.cc pairs a laser/odometry trajectory with
a GPS/ground-truth trajectory per timestamp, fusion.cc aligns and
blends them into one consistent curve via per-segment Eigen SVD
alignments).

Batched design: timestamp association is a vectorized interval lookup;
per-segment rigid alignments run as ONE batched Horn solve over all
sliding windows (the minimizer pair-statistics kernel vmapped over
segments), and the fused curve blends the segment-aligned positions
with smooth weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FusionParams", "associate_by_time", "fuse_trajectories"]


@dataclasses.dataclass
class FusionParams:
    window: int = 8        # poses per alignment segment
    stride: int = 4        # segment stride
    blend: float = 0.5     # 0 = keep curve A, 1 = snap to curve B


def associate_by_time(t_a, t_b):
    """Index into ``t_b`` nearest each ``t_a`` (the per-timestamp curve
    pairing of curves.cc).  Both must be sorted ascending."""
    t_a = np.asarray(t_a, np.float64)
    t_b = np.asarray(t_b, np.float64)
    pos = np.searchsorted(t_b, t_a)
    lo = np.clip(pos - 1, 0, len(t_b) - 1)
    hi = np.clip(pos, 0, len(t_b) - 1)
    pick_hi = np.abs(t_b[hi] - t_a) < np.abs(t_b[lo] - t_a)
    return np.where(pick_hi, hi, lo)


def _segment_aligns(pa, pb, window, stride):
    """Batched rigid alignments taking curve-A windows onto curve B
    (one vmapped Horn solve — fusion.cc does per-segment Eigen SVD)."""
    import jax
    import jax.numpy as jnp

    from . import minimizers as mz

    N = len(pa)
    starts = np.arange(0, max(N - window + 1, 1), stride)
    idx = np.minimum(starts[:, None] + np.arange(window)[None, :], N - 1)
    A = jnp.asarray(pa[idx], jnp.float32)  # [S, W, 3]
    B = jnp.asarray(pb[idx], jnp.float32)

    def one(a, b):
        stats = mz.pair_stats(b, a, jnp.ones(a.shape[0], bool))
        align, err = mz.MINIMIZERS["quat"](stats)
        return align, err

    aligns, errs = jax.vmap(one)(A, B)
    return starts, np.asarray(aligns, np.float64), np.asarray(errs)


def fuse_trajectories(
    t_a, pos_a, t_b, pos_b, params: FusionParams | None = None
):
    """Fuse trajectory A (dense, drifting — laser odometry) with
    trajectory B (sparse/noisy but globally correct — GPS/ground
    truth).  Returns (fused [N,3] at A's timestamps, info dict).

    Pipeline (fusion.cc): associate by time → per-window rigid
    alignments of A onto B → blend each A position between its raw and
    segment-aligned location with distance-weighted smooth weights.
    """
    params = params or FusionParams()
    pos_a = np.asarray(pos_a, np.float64)
    pos_b = np.asarray(pos_b, np.float64)
    j = associate_by_time(t_a, t_b)
    pb = pos_b[j]
    starts, aligns, errs = _segment_aligns(
        pos_a, pb, params.window, params.stride
    )
    N = len(pos_a)
    acc = np.zeros((N, 3))
    wacc = np.zeros(N)
    centers = starts + params.window / 2.0
    for s, T in zip(starts, aligns):
        sl = slice(s, min(s + params.window, N))
        k = np.arange(sl.start, sl.stop)
        # triangular weight toward the segment center
        w = 1.0 - np.abs(k - (s + params.window / 2.0)) / params.window
        w = np.maximum(w, 1e-3)
        moved = pos_a[sl] @ T[:3, :3].T + T[:3, 3]
        acc[sl] += w[:, None] * moved
        wacc[sl] += w
    aligned = np.where(
        wacc[:, None] > 0, acc / np.maximum(wacc, 1e-12)[:, None], pos_a
    )
    fused = (1.0 - params.blend) * aligned + params.blend * pb
    rmse_before = float(np.sqrt(((pos_a - pb) ** 2).sum(1).mean()))
    rmse_after = float(np.sqrt(((fused - pb) ** 2).sum(1).mean()))
    return fused, {
        "segments": len(starts),
        "rmse_before": rmse_before,
        "rmse_after": rmse_after,
        "segment_errors": errs,
    }
