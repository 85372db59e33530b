"""Benchmark driver for one NVIDIA GPU — prints ONE JSON line last.

Cells (``--cells a,b,...``; default: all):

- ``icp16k``: full ICP iterations (transform + NN + stats + quat solve)
  at 16k model x 16k target points inside one jitted ``fori_loop``, for
  each brute NN engine the GPU can run (XLA ``nn_brute`` and the fused
  Triton kernel ``nn_brute_triton``).
- ``nn256k``: the XLA hashed cell list at 256k model x 256k queries (a
  50 m hall, max_dist 25): build once, then queries.
- ``crossover``: in-loop ICP iteration time of each brute engine and of
  the hashed cell list at model windows of 16k..512k points (city-scan
  density: 20 cm voxels), the data behind ``ops.nn.GRID_MIN_POINTS``.
- ``dat``: 3DTK's bundled dat/ sequence (metascan ICP + LUM), from the
  directory ``--dat`` names, with its ATE against tests/golden/dat.
- ``circuit``: the synthetic 100-scan GraphPipeline circuit.
- ``h468``: 468 scans x 16k points with continuous loop closures
  (hannover2's -L 4 schedule), end to end once per brute engine.
- ``bremen``: 13 city scans of 1M raw points (20 cm reduction, -d 150).

Every timing ends in ``jax.block_until_ready`` or a host fetch; compile
time is excluded by a warm-up run at the same shapes.  The run fails
when JAX finds no GPU.  The first output line names the card and its
power limit; the last is ``{"device": ..., "cells": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DAT = os.path.join(REPO, "tests", "golden", "dat")
sys.path.insert(0, os.path.join(REPO, "scripts"))

BRUTE_ENGINES = ("xla", "triton")


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device this run measures; raises when it is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devs[0].platform} devices only"
        )
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def brute_fn(engine: str):
    from tpu3dtk.ops import nn as nn_ops
    from tpu3dtk.ops.nn_triton import nn_brute_triton

    return {"xla": nn_ops.nn_brute, "triton": nn_brute_triton}[engine]


@contextlib.contextmanager
def brute_engine(engine: str):
    """Route every ``nn_brute_auto`` call of the pipeline through one
    brute engine (for end-to-end engine comparisons).  Compiled programs
    are dropped on entry and exit so no trace of the other engine is
    reused."""
    import jax

    from tpu3dtk.ops import nn as nn_ops

    saved = nn_ops.nn_brute_auto
    fn = brute_fn(engine)
    nn_ops.nn_brute_auto = lambda q, qm, m, mm, d2: fn(q, qm, m, mm, d2)
    jax.clear_caches()
    try:
        yield
    finally:
        nn_ops.nn_brute_auto = saved
        jax.clear_caches()


def _icp_iter_loop(nn, k: int):
    """Jitted ``k`` full ICP iterations with NN search ``nn``."""
    import jax
    import jax.numpy as jnp

    from tpu3dtk.core import math3d
    from tpu3dtk.models import minimizers as mz

    @jax.jit
    def run(model, mmask, tgt, tmask, T0, md2, grid):
        def body(i, T):
            tgt_g = math3d.transform3(T, tgt).astype(jnp.float32)
            idx, _, found = nn(tgt_g, tmask, model, mmask, md2, grid)
            stats = mz.pair_stats(model[idx], tgt_g, found)
            align, _ = mz.MINIMIZERS["quat"](stats)
            align = jnp.where(
                stats.n > 3, align, jnp.eye(4, dtype=jnp.float32)
            )
            return align @ T

        return jax.lax.fori_loop(0, k, body, T0)

    return run


def time_icp_iteration(engine, model, target, max_dist, k=20, reps=3):
    """Seconds per in-loop ICP iteration (min of ``reps``) for ``engine``
    in BRUTE_ENGINES or "hash"; returns (s_per_iter, compile_s)."""
    import jax
    import jax.numpy as jnp

    from tpu3dtk.models import icp as icp_mod
    from tpu3dtk.ops import nn as nn_ops

    md2 = jnp.float32(max_dist**2)
    mj = jnp.asarray(model, jnp.float32)
    tj = jnp.asarray(target, jnp.float32)
    mm = jnp.ones(len(model), bool)
    tm = jnp.ones(len(target), bool)
    grid = None
    if engine == "hash":
        n_buckets, bcap = nn_ops.cell_hash_spec(model, np.asarray(mm), max_dist)
        grid, _ = icp_mod.build_match_grid(mj, mm, md2, n_buckets=n_buckets)

        def nn(q, qm, m, mmk, d2, g):
            return nn_ops.nn_cell_hash(q, qm, g, d2, bcap)
    else:
        fn = brute_fn(engine)

        def nn(q, qm, m, mmk, d2, g):
            return fn(q, qm, m, mmk, d2)

    run = _icp_iter_loop(nn, k)
    T0 = jnp.eye(4, dtype=jnp.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(run(mj, mm, tj, tm, T0, md2, grid))
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(mj, mm, tj, tm, T0, md2, grid))
        ts.append((time.perf_counter() - t0) / k)
    return min(ts), compile_s


def bench_icp16k(M=16384, N=16384):
    rng = np.random.default_rng(0)
    model = rng.uniform(-800, 800, (M, 3)).astype(np.float32)
    target = (model[rng.permutation(N) % M]
              + rng.normal(0, 5, (N, 3))).astype(np.float32)
    out = {}
    for engine in BRUTE_ENGINES:
        s, c = time_icp_iteration(engine, model, target, 25.0, k=50, reps=5)
        out[f"icp16k_{engine}_ms_per_iter"] = s * 1e3
        out[f"icp16k_{engine}_compile_s"] = c
    return out


def bench_nn256k(M=262144, Q=262144, iters=5):
    """The hashed cell list at 256k x 256k (50 m hall, max_dist 25)."""
    import jax
    import jax.numpy as jnp

    from tpu3dtk.ops import nn as nn_ops

    rng = np.random.default_rng(1)
    model = rng.uniform(0, 5000, (M, 3)).astype(np.float32)
    query = (model[rng.permutation(Q) % M]
             + rng.normal(0, 5, (Q, 3))).astype(np.float32)
    max_dist = 25.0
    mj, qj = jnp.asarray(model), jnp.asarray(query)
    mask, qmask = jnp.ones(M, bool), jnp.ones(Q, bool)
    H, cap = nn_ops.cell_hash_spec(model, np.ones(M, bool), max_dist)
    origin = jnp.asarray(model.min(axis=0))
    cell = jnp.float32(max_dist)
    md2 = jnp.float32(max_dist**2)
    jax.block_until_ready(nn_ops.build_cell_hash(mj, mask, origin, cell, H))
    t0 = time.perf_counter()
    grid = jax.block_until_ready(
        nn_ops.build_cell_hash(mj, mask, origin, cell, H)
    )
    build_s = time.perf_counter() - t0
    jax.block_until_ready(nn_ops.nn_cell_hash(qj, qmask, grid, md2, cap))
    t0 = time.perf_counter()
    for _ in range(iters):
        o = nn_ops.nn_cell_hash(qj, qmask, grid, md2, cap)
    jax.block_until_ready(o)
    query_s = (time.perf_counter() - t0) / iters
    # byte bound: 27 * cap candidate rows of 3 f32 gathered per query
    cand_bytes = Q * 27 * cap * 12
    return {
        "nn256k_hash_build_ms": build_s * 1e3,
        "nn256k_hash_query_ms": query_s * 1e3,
        "nn256k_bucket_cap": cap,
        "nn256k_n_buckets": H,
        "nn256k_candidate_bytes": cand_bytes,
        "nn256k_candidate_gb_per_s": cand_bytes / query_s / 1e9,
    }


def crossover_windows(sizes, n_scans=8, voxel=20.0):
    """Model windows at city-scan density: the union of the first
    ``n_scans`` synth_city scans (global frame) reduced at ``voxel`` cm,
    and for each size W the W points nearest the first scanner."""
    from make_golden import synth_city

    from tpu3dtk.ops import reduction as red

    locals_, true_mats, _ = synth_city(n_scans=13)
    world = np.concatenate([
        loc @ T[:3, :3].T + T[:3, 3]
        for loc, T in zip(locals_[:n_scans], true_mats[:n_scans])
    ]).astype(np.float32)
    pts = np.asarray(red.reduce_scan(world, voxel, 1, seed=0), np.float32)
    order = np.argsort(np.linalg.norm(pts - true_mats[0][:3, 3], axis=1))
    return {W: pts[order[:W]] for W in sizes if W <= len(pts)}


def bench_crossover(sizes=(16384, 32768, 65536, 131072, 262144, 524288),
                    n_query=16384, radii=(150.0, 50.0)):
    rng = np.random.default_rng(3)
    out = {}
    for W, model in crossover_windows(sizes).items():
        target = (model[rng.choice(W, n_query, replace=W < n_query)]
                  + rng.normal(0, 5, (n_query, 3))).astype(np.float32)
        for engine in BRUTE_ENGINES:
            s, _ = time_icp_iteration(engine, model, target, radii[0])
            out[f"crossover_{W}_{engine}_ms_per_iter"] = s * 1e3
        for r in radii:
            from tpu3dtk.ops import nn as nn_ops

            _, cap = nn_ops.cell_hash_spec(model, np.ones(W, bool), r)
            s, _ = time_icp_iteration("hash", model, target, r)
            out[f"crossover_{W}_hash_r{int(r)}_ms_per_iter"] = s * 1e3
            out[f"crossover_{W}_hash_r{int(r)}_bucket_cap"] = cap
    return out


def _scans_from(locals_, mats, voxel):
    from tpu3dtk.core.scan import TPUScan

    scans = []
    for k, (loc, To) in enumerate(zip(locals_, mats)):
        s = TPUScan.from_points(loc, f"{k:03d}", To)
        s.set_reduction(voxel, 1)
        s.reduced_local()
        scans.append(s)
    return scans


def _copies(scans):
    """Fresh scans with the same reduced points (warm-up copies)."""
    from tpu3dtk.core.scan import TPUScan

    warm = []
    for s in scans:
        w = TPUScan.from_points(s.reduced_local(), s.identifier, s.transMatOrg)
        w._reduced_local = s.reduced_local()
        warm.append(w)
    return warm


def _ate_cm(scans, true_mats) -> float:
    est = np.stack([s.transMat[:3, 3] for s in scans])
    true = np.stack([m[:3, 3] for m in true_mats])
    return float(np.sqrt(((est - true) ** 2).sum(1).mean()))


def _timed(prefix, run, scans):
    """Warm-up on a same-shape copy, then the measured run with its
    named-phase breakdown (host clock around each phase)."""
    from tpu3dtk.utils.metrics import metrics

    run(_copies(scans))
    metrics.reset()
    t0 = time.perf_counter()
    run(scans)
    dt = time.perf_counter() - t0
    out = {f"{prefix}_wall_s": dt}
    out.update({
        f"{prefix}_{name}_s": m.total for name, m in metrics.timers.items()
    })
    return out


def bench_dat(dat_dir=None):
    if not dat_dir or not os.path.isdir(dat_dir):
        return {"dat": "not measured: no dat/ directory given (--dat)"}
    import tempfile

    from tpu3dtk.core.scan import TPUScan
    from tpu3dtk.io import frames as frames_io
    from tpu3dtk.io.converters import ate
    from tpu3dtk.io.scandir import PointFilter, read_scan_dir
    from tpu3dtk.models.graphslam import LumParams, do_graph_slam
    from tpu3dtk.models.icp import IcpParams
    from tpu3dtk.models.sequence import SequenceRegistration

    scans = []
    for raw in read_scan_dir(dat_dir, format="uos",
                             point_filter=PointFilter(range_max=500.0)):
        s = TPUScan.from_raw(raw)
        s.set_reduction(10.2, 1)
        s.reduced_local()
        scans.append(s)

    def run(scans):
        SequenceRegistration(
            params=IcpParams(max_dist_match2=625.0, max_iterations=50,
                             epsilon=1e-7),
            metascan=True,
        ).run(scans)
        links = np.array(
            [(i, i + 1) for i in range(len(scans) - 1)]
            + [(0, len(scans) - 1)], np.int32,
        )
        do_graph_slam(scans, links, LumParams(
            max_dist_match2=625.0, iterations=50, epsilon=1e-5))

    out = _timed("dat", run, scans)
    with tempfile.TemporaryDirectory() as td:
        for s in scans:
            frames_io.write_frames(
                frames_io.frames_path(td, s.identifier),
                np.stack([m for m, _ in s.frames]), [t for _, t in s.frames],
            )
        res = ate(td, GOLDEN_DAT, align=False)
    out["dat_ate_rmse_cm"] = res["rmse"]
    out["dat_ate_ok"] = bool(res["rmse"] < 5.0)
    return out


def _pipeline(**kw):
    from tpu3dtk.models.graph_pipeline import GraphPipeline
    from tpu3dtk.models.icp import IcpParams

    return GraphPipeline(
        icp_params=IcpParams(
            max_dist_match2=2500.0, max_iterations=50, epsilon=1e-6
        ),
        lum_max_dist2=2500.0, lum_iterations=10, lum_epsilon=0.1,
        elch=True, loopsize=10, **kw,
    )


def bench_circuit(n_scans=100):
    from make_golden import synth_loop

    locals_, true_mats, odo_mats = synth_loop(n_scans=n_scans)
    scans = _scans_from(locals_, odo_mats, 25.0)
    out = _timed(
        "circuit", lambda sc: _pipeline(cldist=700.0).run(sc), scans
    )
    out["circuit_ate_rmse_cm"] = _ate_cm(scans, true_mats)
    return out


# ATE gate of the h468 cell: the CPU stand-in's ATE on the same schedule
# (BASELINE_MEASURED.json h468_ate_rmse_cm = 18.22) x 1.5 + 2 cm
H468_ATE_GATE_CM = max(10.0, 1.5 * 18.22 + 2.0)


def h468_pipeline(**kw):
    """The h468 GraphPipeline: per-closure LUM runs 1 iteration like the
    reference (doGraphSlam6D(gr, allScans, 1), slam6D.cc:508); the full
    -I budget runs in the final relax."""
    return _pipeline(cldist=300.0, closure_lum_iterations=1, **kw)


def bench_h468(n_scans=468):
    from make_golden import synth_ring

    locals_, true_mats, odo_mats = synth_ring(n_scans=n_scans)
    scans = _scans_from(locals_, odo_mats, 10.0)
    out = {}
    for engine in BRUTE_ENGINES:
        run_scans = _copies(scans)
        with brute_engine(engine):
            out.update(_timed(
                f"h468_{engine}", lambda sc: h468_pipeline().run(sc),
                run_scans,
            ))
        err = _ate_cm(run_scans, true_mats)
        out[f"h468_{engine}_ate_rmse_cm"] = err
        out[f"h468_{engine}_ate_ok"] = bool(err < H468_ATE_GATE_CM)
    return out


# bremen gate: CPU stand-in ATE 50.07 cm x 1.3 + 5 cm
CITY_ATE_GATE_CM = max(30.0, 1.3 * 50.07 + 5.0)


def city_pipeline(scans):
    """Sequential ICP with -d 150 then LUM over the chain + closing link
    (the bremen_city workflow).  epsilon 1e-4: at 300k pairs one pair
    entering or leaving moves the RMS by ~4e-5."""
    from tpu3dtk.models.graphslam import LumParams, do_graph_slam
    from tpu3dtk.models.icp import IcpParams
    from tpu3dtk.models.sequence import SequenceRegistration

    SequenceRegistration(params=IcpParams(
        max_dist_match2=150.0**2, max_iterations=50, epsilon=1e-4,
    )).run(scans)
    links = np.array(
        [(i, i + 1) for i in range(len(scans) - 1)] + [(0, len(scans) - 1)],
        np.int32,
    )
    do_graph_slam(scans, links, LumParams(
        max_dist_match2=150.0**2, iterations=5, epsilon=0.5))


def bench_bremen(n_scans=13, n_pts=1_000_000):
    from make_golden import synth_city

    locals_, true_mats, odo_mats = synth_city(n_scans=n_scans, n_pts=n_pts)
    scans = _scans_from(locals_, odo_mats, 20.0)
    out = _timed("bremen", city_pipeline, scans)
    out["bremen_reduced_pts_per_scan"] = int(
        np.mean([len(s.reduced_local()) for s in scans])
    )
    err = _ate_cm(scans, true_mats)
    out["bremen_ate_rmse_cm"] = err
    out["bremen_ate_ok"] = bool(err < CITY_ATE_GATE_CM)
    return out


CELLS = {
    "icp16k": bench_icp16k,
    "nn256k": bench_nn256k,
    "crossover": bench_crossover,
    "dat": bench_dat,
    "circuit": bench_circuit,
    "h468": bench_h468,
    "bremen": bench_bremen,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=",".join(CELLS),
                   help="comma-separated subset of: " + ", ".join(CELLS))
    p.add_argument("--dat", default=None,
                   help="3DTK's dat/ scan directory for the dat cell")
    args = p.parse_args(argv)
    names = [c for c in args.cells.split(",") if c]
    unknown = set(names) - set(CELLS)
    if unknown:
        p.error(f"unknown cells: {sorted(unknown)}")
    import tpu3dtk  # noqa: F401  (x64 + matmul precision + compile cache)

    device = require_gpu()
    print(gpu_name_and_power(), flush=True)

    cells = {}
    for name in names:
        t0 = time.perf_counter()
        res = CELLS[name](args.dat) if name == "dat" else CELLS[name]()
        print(f"{name}: {time.perf_counter() - t0:.1f} s "
              f"{json.dumps(res)}", flush=True)
        cells.update(res)
    print(json.dumps({"device": device, "cells": cells}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
