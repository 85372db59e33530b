"""CPU f64 reference-equivalent of the FULL GraphPipeline workload
(sequential ICP + proximity loop detection + ELCH slerp closure + LUM),
used by measure_reference.py to produce the hannover-scale baseline
denominator.

The reference slam6D binary is unbuildable in this image (no Boost /
SuiteSparse, zero egress), so this replicates its matchGraph6Dautomatic
driver (src/slam6d/slam6D.cc:387-548) with the same CPU-idiomatic
kernels the reference uses: scipy cKDTree NN with parallel queries (the
kd.cc role, OpenMP-equivalent), f64 Horn quaternion ICP (icp6D.cc), f64
link covariances + dense solve for LUM (lum6Deuler.cc), Dijkstra
graph_balancer + slerp distribution for ELCH (elch6Dslerp.cc).  The
schedule (when loops close, which LUM passes run) matches
tpu3dtk.models.graph_pipeline.GraphPipeline so both sides execute the
same amount of work.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_golden import lum_f64, lum_link_f64  # noqa: E402
from measure_reference import cpu_icp_match  # noqa: E402

from tpu3dtk.core import math3d  # noqa: E402
from tpu3dtk.models.elch import (  # noqa: E402  (pure-numpy helpers)
    _inv_diag_weights,
    _slerp,
    graph_balancer,
)
from tpu3dtk.models.graphslam import build_proximity_graph  # noqa: E402


def _window_global(locals_, mats, lo, hi):
    n = len(mats)
    chunks = [
        locals_[i] @ mats[i][:3, :3].T + mats[i][:3, 3]
        for i in range(max(0, lo), min(n, hi + 1))
    ]
    return np.concatenate(chunks, axis=0)


def _close_loop_slerp(locals_, mats, first, last, edges, max_dist2,
                      icp_iters, upto=None):
    """CPU mirror of models.elch.close_loop (elch6Dslerp.cc:93-190);
    distribution is limited to the prefix [1, upto] like the JAX
    driver's scans[:upto+1] slice."""
    n = (upto + 1) if upto is not None else len(mats)
    pts_g = [l @ M[:3, :3].T + M[:3, 3] for l, M in zip(locals_, mats)]
    C = np.stack(
        [lum_link_f64(pts_g[a], pts_g[b], max_dist2)[0] for a, b in edges]
    )
    wd = _inv_diag_weights(C, 6)
    wtrans = wd[:, :3]
    wrot = wd[:, 3:].sum(axis=1)
    weights = [
        graph_balancer(edges, wtrans[:, k], first, last, n) for k in range(3)
    ] + [graph_balancer(edges, wrot, first, last, n)]

    end_lo, end_hi = last - 2, last
    Pl0 = mats[last].copy()
    Pf0 = mats[first].copy()
    model = _window_global(locals_, mats, first - 2, first + 2)
    target = _window_global(locals_, mats, last - 2, last)
    align = cpu_icp_match(model, target, np.eye(4), max_dist2,
                          icp_iters, 1e-7)
    u, _, vt = np.linalg.svd(align[:3, :3])
    align[:3, :3] = u @ vt
    Pp0 = align @ Pl0

    Pf0_inv = np.asarray(math3d.m4inv(Pf0))
    tmp1 = Pf0_inv @ Pl0
    deltaf = Pf0_inv @ Pp0 @ np.asarray(math3d.m4inv(tmp1))
    deltaQ = np.asarray(math3d.matrix4_to_quat(deltaf))
    deltaT = deltaf[:3, 3]
    idQ = np.array([1.0, 0, 0, 0])
    rPos0 = deltaT * np.array([weights[0][0], weights[1][0], weights[2][0]])
    q0 = _slerp(idQ, deltaQ, weights[3][0])
    tmp1 = np.asarray(math3d.quat_to_matrix4(q0, rPos0))
    delta0 = Pf0 @ np.asarray(math3d.m4inv(tmp1))

    for i in range(1, n):
        if end_lo <= i <= end_hi:
            Ti = delta0 @ Pf0_inv @ align
        else:
            rPos = deltaT * np.array(
                [weights[0][i], weights[1][i], weights[2][i]]
            )
            qi = _slerp(idQ, deltaQ, weights[3][i])
            frac = np.asarray(math3d.quat_to_matrix4(qi, rPos))
            Ti = delta0 @ frac @ Pf0_inv
        mats[i] = Ti @ mats[i]


def run_cpu_pipeline(
    locals_,
    odo_mats,
    *,
    icp_max_dist2=2500.0,
    icp_iterations=50,
    lum_max_dist2=2500.0,
    lum_iterations=10,
    lum_epsilon=0.1,
    cldist=700.0,
    loopsize=10,
    closure_lum_iterations=None,
):
    """Same schedule as GraphPipeline.run (elch=True, slerp, -G 1);
    closure_lum_iterations mirrors GraphPipeline's per-closure LUM
    budget (reference: doGraphSlam6D(gr, allScans, 1), slam6D.cc:508)."""
    n = len(locals_)
    mats = [m.copy() for m in odo_mats]
    org = [m.copy() for m in odo_mats]
    cld2 = cldist**2
    edges = []
    loop_state = 0
    min_dist = -1.0
    first = last = 0

    def relax(upto, iters=None):
        sub = list(range(upto + 1))
        positions = np.stack([mats[i][:3, 3] for i in sub])
        links = build_proximity_graph(positions, cld2, loopsize)
        new = lum_f64(
            [locals_[i] for i in sub], [mats[i] for i in sub],
            [tuple(l) for l in links], lum_max_dist2,
            iters=(lum_iterations if iters is None else iters),
            eps=lum_epsilon,
        )
        for i, M in zip(sub, new):
            mats[i] = M

    for i in range(1, n):
        edges.append((i - 1, i))
        delta = mats[i - 1] @ np.asarray(math3d.m4inv(org[i - 1]))
        T0 = delta @ mats[i]
        model = locals_[i - 1] @ mats[i - 1][:3, :3].T + mats[i - 1][:3, 3]
        mats[i] = cpu_icp_match(
            model, locals_[i], T0, icp_max_dist2, icp_iterations, 1e-6
        )

        if loop_state == 1:
            loop_state = 2
        for j in range(0, i - loopsize):
            d = float(np.sum((mats[j][:3, 3] - mats[i][:3, 3]) ** 2))
            if d < cld2:
                loop_state = max(loop_state, 1)
                if min_dist < 0 or d < min_dist:
                    min_dist = d
                    first, last = j, i
        if loop_state == 2:
            loop_state = 0
            min_dist = -1.0
            _close_loop_slerp(
                locals_, mats, first, last,
                [e for e in edges if e[1] <= i],
                icp_max_dist2, icp_iterations, upto=i,
            )
            edges.append((first, last))
            relax(i, iters=closure_lum_iterations)

    if loop_state == 1:
        _close_loop_slerp(
            locals_, mats, first, last, edges, icp_max_dist2, icp_iterations
        )
        edges.append((first, last))
    relax(n - 1)
    return mats
