"""Reduced-precision ICP — the JAX-native ``sc_fixed`` module and
``icpFixpoint`` driver (ref src/sc_fixed/sc_ICP.cc, sc_fixed_math.h,
src/slam6d/icpFixpoint.cc): the reference validates ICP in fixed-point
arithmetic for embedded/FPGA targets, with a 10^-exp epsilon
termination (icpFixpoint.cc:142 epsilonICPexp).

On an accelerator the native reduced-precision datapath is bfloat16 —
the analog question ("how much cheaper can the arithmetic get before
registration breaks?") maps to: coordinates quantized to bf16, the NN
ranking matmul in a SINGLE bf16 pass (the exact mode the full-precision
pipeline must avoid, ops.nn._pairwise_d2), pair statistics accumulated
in f32.  ``compare_fixed_float`` quantifies the pose error against the
exact-f32 pipeline, the role of the reference's fixed-vs-double
comparison harness.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math3d
from . import minimizers as mz

__all__ = ["FixedIcpResult", "icp_pair_fixed", "compare_fixed_float"]


class FixedIcpResult(NamedTuple):
    T: jnp.ndarray
    error: jnp.ndarray
    iterations: jnp.ndarray
    n_pairs: jnp.ndarray


def _nn_bf16(query, qmask, model_bf16, mmask, center, max_dist2):
    """Single-pass bf16 NN ranking: the quantized datapath under test.
    Winner distances are recomputed in f32 for the accept gate (the
    reference's fixed-point compare also widens for the threshold)."""
    q = (query - center).astype(jnp.bfloat16)
    cross = jnp.dot(
        q, model_bf16.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    m2 = jnp.sum(
        model_bf16.astype(jnp.float32) ** 2, axis=1, keepdims=True
    ).T
    score = m2 - 2.0 * cross
    score = jnp.where(mmask[None, :], score, jnp.float32(3.4e38))
    idx = jnp.argmin(score, axis=1).astype(jnp.int32)
    model_f32 = model_bf16.astype(jnp.float32) + center
    diff = query - model_f32[idx]
    d2 = jnp.sum(diff * diff, axis=1)
    d2 = jnp.where(mmask[idx], d2, jnp.float32(3.4e38))
    found = qmask & (d2 < max_dist2)
    return idx, found, model_f32


@functools.partial(
    jax.jit, static_argnames=("max_iterations", "eps_exp", "minimizer")
)
def icp_pair_fixed(
    model, mmask, target_local, tmask, T0, max_dist_match2,
    *,
    max_iterations: int = 50,
    eps_exp: int = 3,
    minimizer: str = "quat",
):
    """ICP with the quantized bf16 NN datapath and the fixed-point
    10^-eps_exp termination criterion (icpFixpoint.cc).  Same contract
    as models.icp.icp_pair otherwise."""
    model = jnp.asarray(model, jnp.float32)
    target_local = jnp.asarray(target_local, jnp.float32)
    T0 = jnp.asarray(T0, jnp.float32)
    eps = jnp.float32(10.0 ** (-eps_exp))
    md2 = jnp.float32(max_dist_match2)
    center = jnp.sum(
        jnp.where(mmask[:, None], model, 0.0), axis=0
    ) / jnp.maximum(jnp.sum(mmask), 1)
    model_bf16 = (model - center).astype(jnp.bfloat16)
    align_fn = mz.MINIMIZERS[minimizer]

    def cond(carry):
        T, ret, prev, it, done, npairs = carry
        return (~done) & (it < max_iterations)

    def body(carry):
        T, ret, prev, it, _, _ = carry
        tgt_g = math3d.transform3(T, target_local, xp=jnp).astype(
            jnp.float32
        )
        idx, found, model_f32 = _nn_bf16(
            tgt_g, tmask, model_bf16, mmask, center, md2
        )
        stats = mz.pair_stats(model_f32[idx], tgt_g, found)
        enough = stats.n > 3
        align, err = align_fn(stats)
        align = jnp.where(enough, align, jnp.eye(4, dtype=jnp.float32))
        T_new = align @ T
        ret_new = jnp.where(enough, err, ret)
        done = (jnp.abs(ret_new - prev) < eps) | ~enough
        return T_new, ret_new, ret_new, it + 1, done, stats.n

    init = (
        T0,
        jnp.float64(0.0),  # err in f64 (pair_stats' convergence island)
        jnp.float64(jnp.inf),
        jnp.int32(0),
        jnp.bool_(False), jnp.float32(0.0),
    )
    T, ret, prev, it, done, npairs = jax.lax.while_loop(cond, body, init)
    return FixedIcpResult(T=T, error=ret, iterations=it, n_pairs=npairs)


def compare_fixed_float(
    model, target_local, T0, max_dist_match2, **kw
) -> dict:
    """Run the quantized and the exact pipeline on the same pair and
    report the pose disagreement (the icpFixpoint fixed-vs-double
    harness role).  Returns dict with both poses and deltas."""
    from .icp import icp_pair

    model = np.asarray(model, np.float32)
    target = np.asarray(target_local, np.float32)
    mmask = jnp.ones(len(model), bool)
    tmask = jnp.ones(len(target), bool)
    rf = icp_pair_fixed(
        jnp.asarray(model), mmask, jnp.asarray(target), tmask,
        jnp.asarray(T0, jnp.float32), max_dist_match2, **kw,
    )
    rx = icp_pair(
        jnp.asarray(model), mmask, jnp.asarray(target), tmask,
        jnp.asarray(T0, jnp.float32),
        max_dist_match2=max_dist_match2, epsilon=1e-7,
    )
    Tf = np.asarray(rf.T, np.float64)
    Tx = np.asarray(rx.T, np.float64)
    dt = float(np.linalg.norm(Tf[:3, 3] - Tx[:3, 3]))
    dr = float(np.linalg.norm(Tf[:3, :3] - Tx[:3, :3]))
    return {
        "T_fixed": Tf,
        "T_float": Tx,
        "delta_translation_cm": dt,
        "delta_rotation_fro": dr,
        "iterations_fixed": int(rf.iterations),
        "iterations_float": int(rx.iterations),
    }
