"""Fused brute-force NN kernel for NVIDIA GPUs (Pallas, Triton route).

Same contract as :func:`tpu3dtk.ops.nn.nn_brute` — exact NN of each
query among the masked model points, strict ``d2 < max_dist2``, the
winner's distance recomputed by direct subtraction — without ever
writing the [Q, M] distance matrix to device memory.

Design:

- one program per (query tile, model split); a ``fori_loop`` walks the
  split's model tiles, so there is no cross-program state;
- d² = Σ(q − m)² on CUDA cores.  The contraction depth is 3, so the
  tensor cores have nothing to do, and TF32 would break exact ranking;
- the running (min, tile) pair is kept per element of the
  [BQ, BM] tile, in registers; one reduction per program at the end
  turns it into (min, argmin);
- masked and padded model points are excluded through the model mask;
- the splits are a second grid axis, so a 16k-query cloud still fills
  every SM; a small XLA min over the splits finishes the reduction.

Work is Q·M·(3 sub + 3 mul/fma + compare + 2 select), compute-bound.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["nn_brute_triton"]

_BIG = 3.4e38
# query and model tile (points), warps per program, and the program
# count the model splits aim for (a few per SM of an H100's 132)
_BQ = 64
_BM = 64
_NUM_WARPS = 4
_MIN_PROGRAMS = 1024


def _nn_kernel(qx_ref, qy_ref, qz_ref, mx_ref, my_ref, mz_ref, mv_ref,
               d2_ref, idx_ref, *, BQ: int, BM: int, n_tiles: int):
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    qz = qz_ref[...][:, None]
    split = pl.program_id(1)

    def body(k, carry):
        best, best_k = carry
        sl = pl.ds(k * BM, BM)
        dx = qx - mx_ref[sl][None, :]
        dy = qy - my_ref[sl][None, :]
        dz = qz - mz_ref[sl][None, :]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = jnp.where(mv_ref[sl][None, :] != 0, d2, jnp.float32(_BIG))
        better = d2 < best
        return (
            jnp.where(better, d2, best),
            jnp.where(better, k, best_k),
        )

    init = (
        jnp.full((BQ, BM), _BIG, jnp.float32),
        jnp.zeros((BQ, BM), jnp.int32),
    )
    best, best_k = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(n_tiles), body, init
    )
    dmin = jnp.min(best, axis=1)
    col = jax.lax.broadcasted_iota(jnp.int32, (BQ, BM), 1)
    # lowest model index among the lanes holding the minimum
    pos = jnp.where(
        best == dmin[:, None], best_k * BM + col, jnp.int32(2**31 - 1)
    )
    d2_ref[...] = dmin
    idx_ref[...] = jnp.min(pos, axis=1) + split * jnp.int32(n_tiles * BM)


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _plan(Q: int, M: int, BQ: int, BM: int, min_programs: int):
    """Static padding and split count: power-of-two tiles, and enough
    model splits that (query tiles x splits) reaches ``min_programs``
    while every split keeps at least 8 model tiles."""
    BQ = min(BQ, _pow2_at_least(Q, 16))
    BM = min(BM, _pow2_at_least(M, 16))
    Qp = -(-Q // BQ) * BQ
    m_tiles = -(-M // BM)
    splits = 1
    while (Qp // BQ) * splits < min_programs and m_tiles // (2 * splits) >= 8:
        splits *= 2
    n_tiles = -(-m_tiles // splits)
    return BQ, BM, Qp, splits, n_tiles


@functools.partial(jax.jit, static_argnames=("interpret",))
def nn_brute_triton(query, qmask, model, mmask, max_dist2, *,
                    interpret: bool = False):
    """NN with the contract of ops.nn.nn_brute through the fused kernel.

    query [Q,3], model [M,3] f32; masks bool.  Returns (idx [Q] int32,
    d2 [Q] f32, found [Q] bool).  Traceable: safe inside jit,
    while_loop/fori_loop, vmap and shard_map.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    Q, M = query.shape[0], model.shape[0]
    BQ, BM, Qp, splits, n_tiles = _plan(Q, M, _BQ, _BM, _MIN_PROGRAMS)
    Mp = splits * n_tiles * BM
    q = jnp.pad(query.astype(jnp.float32), ((0, Qp - Q), (0, 0)))
    m = jnp.pad(model.astype(jnp.float32), ((0, Mp - M), (0, 0)))
    mv = jnp.pad(mmask, (0, Mp - M)).astype(jnp.int32)
    Ms = n_tiles * BM
    qspec = pl.BlockSpec((BQ,), lambda i, j: (i,))
    mspec = pl.BlockSpec((Ms,), lambda i, j: (j,))
    ospec = pl.BlockSpec((None, BQ), lambda i, j: (j, i))
    d2s, idxs = pl.pallas_call(
        functools.partial(_nn_kernel, BQ=BQ, BM=BM, n_tiles=n_tiles),
        grid=(Qp // BQ, splits),
        in_specs=[qspec] * 3 + [mspec] * 4,
        out_specs=[ospec, ospec],
        out_shape=[
            jax.ShapeDtypeStruct((splits, Qp), jnp.float32),
            jax.ShapeDtypeStruct((splits, Qp), jnp.int32),
        ],
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS, num_stages=2),
        interpret=interpret,
        name="nn_brute_triton",
    )(q[:, 0], q[:, 1], q[:, 2], m[:, 0], m[:, 1], m[:, 2], mv)
    s = jnp.argmin(d2s, axis=0)
    idx = jnp.take_along_axis(idxs, s[None, :], axis=0)[0, :Q]
    idx = jnp.clip(idx, 0, M - 1)
    # exact recompute of the winner (same as nn_brute)
    diff = query - model[idx]
    best = jnp.sum(diff * diff, axis=1)
    best = jnp.where(mmask[idx], best, jnp.float32(_BIG))
    found = qmask & (best < max_dist2)
    return idx, best, found
