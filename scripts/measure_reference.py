"""Measure the CPU baseline for bench.py's vs_baseline ratio.

The reference binary (slam6D) cannot be built in this image (no Boost /
SuiteSparse packages, zero egress), so this script runs a faithful
CPU *reference-equivalent* of the full dat pipeline bench.py times:

- ICP: kd-tree NN (scipy cKDTree, C implementation, the same data
  structure as the reference's src/slam6d/kd.cc) with **parallel
  queries across all cores** (the reference's ICP is OpenMP-parallel,
  icp6D.cc:129-222, so a single-threaded denominator would overstate
  the speedup), double-precision Horn quaternion minimizer, identical
  iteration/convergence logic (icp6D.cc:104-285);
- LUM: f64 link covariances + dense solve (lum6Deuler.cc math, the
  -G 1 phase), same graph and iteration protocol as bench.py.

Writes BASELINE_MEASURED.json: {"dat_matching_ms": ..., "method": ...}.
Replace with real slam6D timings when a full build environment exists.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
from scipy.spatial import cKDTree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# CPU-only measurement: the stand-in must not share an accelerator
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cpu_icp_match(model, target_local, T0, max_dist2, max_iter, eps):
    """Reference ICP loop on CPU doubles: NN via kd-tree, Horn quat."""
    tree = cKDTree(model)
    T = T0.copy()
    ret = prev = prev2 = 0.0
    for it in range(max_iter):
        prev2, prev = prev, ret
        tgt = target_local @ T[:3, :3].T + T[:3, 3]
        d, idx = tree.query(tgt, workers=-1)
        sel = d * d < max_dist2
        m = model[idx[sel]]
        t = tgt[sel]
        n = len(m)
        if n <= 3:
            break
        cm = m.mean(0)
        cd = t.mean(0)
        S = (t - cd).T @ (m - cm) / n  # rows=data, cols=model
        tr = np.trace(S)
        A = np.array([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2], S[0, 1] - S[1, 0]])
        Q = np.empty((4, 4))
        Q[0, 0] = tr
        Q[0, 1:] = A
        Q[1:, 0] = A
        Q[1:, 1:] = S + S.T - np.eye(3) * tr
        w, v = np.linalg.eigh(Q)
        q = v[:, -1]
        qw, qx, qy, qz = q
        R = np.array(
            [
                [qw*qw+qx*qx-qy*qy-qz*qz, 2*(qx*qy-qw*qz), 2*(qx*qz+qw*qy)],
                [2*(qx*qy+qw*qz), qw*qw-qx*qx+qy*qy-qz*qz, 2*(qy*qz-qw*qx)],
                [2*(qx*qz-qw*qy), 2*(qy*qz+qw*qx), qw*qw-qx*qx-qy*qy+qz*qz],
            ]
        )
        trans = cm - R @ cd
        align = np.eye(4)
        align[:3, :3] = R
        align[:3, 3] = trans
        T = align @ T
        ret = float(np.sqrt((d[sel] ** 2).mean()))
        if abs(ret - prev) < eps and abs(ret - prev2) < eps:
            break
    return T


def main():
    from tpu3dtk.core.scan import TPUScan
    from tpu3dtk.io.scandir import PointFilter, read_scan_dir
    from tpu3dtk.core import math3d

    dat = "/root/reference/dat"
    scans = []
    for raw in read_scan_dir(dat, format="uos", point_filter=PointFilter(range_max=500.0)):
        s = TPUScan.from_raw(raw)
        s.set_reduction(10.2, 1)
        scans.append(s)
    reduced = [np.asarray(s.reduced_local(), np.float64) for s in scans]
    mats = [s.transMat.copy() for s in scans]

    t0 = time.perf_counter()
    # same workload bench.py times: sequential metascan registration,
    # 50 iterations cap, eps 1e-7
    for i in range(1, len(scans)):
        delta = mats[i - 1] @ np.asarray(math3d.m4inv(scans[i - 1].transMatOrg))
        T0 = delta @ mats[i]
        model = np.concatenate(
            [
                r @ M[:3, :3].T + M[:3, 3]
                for r, M in zip(reduced[:i], mats[:i])
            ]
        )
        mats[i] = cpu_icp_match(model, reduced[i], T0, 625.0, 50, 1e-7)
    # LUM phase: same graph + protocol as bench.py's _run_dat_pipeline
    from make_golden import lum_f64

    links = [(i, i + 1) for i in range(len(scans) - 1)] + [(0, len(scans) - 1)]
    lum_f64(reduced, mats, links, 625.0, iters=50, eps=1e-5)
    dt_ms = (time.perf_counter() - t0) * 1000.0

    # hannover-scale: the full GraphPipeline-equivalent (ICP + ELCH +
    # LUM, scripts/cpu_pipeline.py) on the synthetic 100-scan circuit —
    # the same workload bench.py times on the accelerator
    from cpu_pipeline import run_cpu_pipeline
    from make_golden import synth_loop

    locals_, true_mats, odo_mats = synth_loop(n_scans=100)
    red = []
    for loc in locals_:
        s_ = TPUScan.from_points(loc, "x")
        s_.set_reduction(25.0, 1)
        red.append(np.asarray(s_.reduced_local(), np.float64))
    t0 = time.perf_counter()
    mats_h = run_cpu_pipeline(
        red, odo_mats,
        icp_max_dist2=2500.0, icp_iterations=50,
        lum_max_dist2=2500.0, lum_iterations=10, lum_epsilon=0.1,
        cldist=700.0, loopsize=10,
    )
    hannover_ms = (time.perf_counter() - t0) * 1000.0
    pos_est = np.stack([m[:3, 3] for m in mats_h])
    pos_true = np.stack([m[:3, 3] for m in true_mats])
    hannover_ate = float(np.sqrt(((pos_est - pos_true) ** 2).sum(1).mean()))

    out = {
        "dat_matching_ms": round(dt_ms, 1),
        "hannover_synth_ms": round(hannover_ms, 1),
        "hannover_synth_ate_rmse_cm": round(hannover_ate, 2),
        "method": (
            "cpu reference-equivalent: scipy cKDTree NN (parallel queries, "
            "all cores) + f64 Horn quat ICP + f64 LUM relaxation"
        ),
        "note": "reference slam6D not buildable in this image (no boost/suitesparse)",
    }
    _merge(out)


def _merge(update):
    """Merge results into BASELINE_MEASURED.json (workloads are measured
    separately — the 468/bremen runs take tens of minutes on 2 cores)."""
    path = os.path.join(REPO, "BASELINE_MEASURED.json")
    out = {}
    if os.path.exists(path):
        out = json.load(open(path))
    out.update(update)
    out["host"] = f"{os.cpu_count()}-core VM"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(update))


def measure_h468():
    """CPU denominator for bench.bench_hannover468 — identical
    schedule: 468-scan ring, -d 50 ICP (50 it, eps 1e-6), continuous
    slerp closures with 1-iteration per-closure LUM, final 10-iteration
    LUM (eps 0.1)."""
    from cpu_pipeline import run_cpu_pipeline
    from make_golden import synth_ring

    from tpu3dtk.core.scan import TPUScan

    locals_, true_mats, odo_mats = synth_ring(n_scans=468)
    red = []
    for loc in locals_:
        s_ = TPUScan.from_points(loc, "x")
        s_.set_reduction(10.0, 1)
        red.append(np.asarray(s_.reduced_local(), np.float64))
    t0 = time.perf_counter()
    mats = run_cpu_pipeline(
        red, odo_mats,
        icp_max_dist2=2500.0, icp_iterations=50,
        lum_max_dist2=2500.0, lum_iterations=10, lum_epsilon=0.1,
        cldist=300.0, loopsize=10, closure_lum_iterations=1,
    )
    ms = (time.perf_counter() - t0) * 1000.0
    pos_est = np.stack([m[:3, 3] for m in mats])
    pos_true = np.stack([m[:3, 3] for m in true_mats])
    ate = float(np.sqrt(((pos_est - pos_true) ** 2).sum(1).mean()))
    _merge({"h468_ms": round(ms, 1), "h468_ate_rmse_cm": round(ate, 2)})


def measure_bremen():
    """CPU denominator for bench.bench_bremen — identical schedule:
    13 scans reduced at 20 cm, sequential -d 150 ICP (50 it, eps 1e-6),
    LUM chain + closing link (5 it, eps 0.5)."""
    from make_golden import lum_f64, synth_city

    from tpu3dtk.core import math3d
    from tpu3dtk.core.scan import TPUScan

    locals_, true_mats, odo_mats = synth_city()
    red = []
    for loc in locals_:
        s_ = TPUScan.from_points(loc, "x")
        s_.set_reduction(20.0, 1)
        red.append(np.asarray(s_.reduced_local(), np.float64))
    mats = [m.copy() for m in odo_mats]
    t0 = time.perf_counter()
    for i in range(1, len(red)):
        delta = mats[i - 1] @ np.asarray(math3d.m4inv(odo_mats[i - 1]))
        T0 = delta @ mats[i]
        model = red[i - 1] @ mats[i - 1][:3, :3].T + mats[i - 1][:3, 3]
        mats[i] = cpu_icp_match(model, red[i], T0, 150.0**2, 50, 1e-4)
    links = [(i, i + 1) for i in range(len(red) - 1)] + [(0, len(red) - 1)]
    mats = lum_f64(red, mats, links, 150.0**2, iters=5, eps=0.5)
    ms = (time.perf_counter() - t0) * 1000.0
    pos_est = np.stack([m[:3, 3] for m in mats])
    pos_true = np.stack([m[:3, 3] for m in true_mats])
    ate = float(np.sqrt(((pos_est - pos_true) ** 2).sum(1).mean()))
    _merge({"bremen_ms": round(ms, 1), "bremen_ate_rmse_cm": round(ate, 2)})


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "base"
    if which == "base":
        main()
    elif which == "h468":
        measure_h468()
    elif which == "bremen":
        measure_bremen()
    else:
        raise SystemExit(f"unknown workload {which}")
