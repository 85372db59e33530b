"""Smoke run of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py            # kernels, cli, h468, city (one card)
    python chip_smoke.py --four     # h468 sharded over 4 cards vs 1 card

Phases (each prints its wall time; compile time is reported beside it
as set-up):

- kernels: every NN engine the GPU path runs, compiled at 16384 x 16384
  (a +-800 cm room) and 262144 x 262144 (a 50 m hall), with its
  ``memory_analysis()``, checked against a scipy cKDTree f64 oracle.
- cli: ``tpuslam`` (cli.slam6d.main, in-process) with ELCH + LUM on a
  60-scan synthetic loop written as uos scans; ATE against the exact
  truth in tests/golden/loop60 below 10 cm.
- h468: GraphPipeline on 468 scans x 16384 points with continuous loop
  closures; ATE below bench.H468_ATE_GATE_CM.
- city: 1M-point city scans reduced at 20 cm, matched with -d 150 and
  relaxed by LUM; ATE below bench.CITY_ATE_GATE_CM.

Everything runs in this one process.  Without a GPU it exits non-zero
and prints no result.  The line before the last names the card and its
power limit; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_LOOP60 = os.path.join(REPO, "tests", "golden", "loop60")

# oracle comparison tolerances (cm²): f32 rounding of d² at match radii
# of at most 25 cm, and of the strict accept test at the boundary
D2_TOL = 1e-2
BOUNDARY_TOL = 1e-3
MIN_INDEX_AGREEMENT = 0.999

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s = [0.0]


def _on_event(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Wall time of one phase and the part of it spent compiling."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _compile_s[0]
        log(f"[{self.name}] start")
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        comp = _compile_s[0] - self.c0
        state = "FAILED" if exc[0] is not None else "ok"
        log(f"[{self.name}] {state}: wall {wall:.1f} s, of which compile "
            f"(set-up) {comp:.1f} s, run {wall - comp:.1f} s")
        return False


# ---------------------------------------------------------------------------
# NN engines against the f64 oracle
# ---------------------------------------------------------------------------


def oracle_nn(query, model):
    """Exact NN in f64 (scipy cKDTree): (index, squared distance)."""
    from scipy.spatial import cKDTree

    d, idx = cKDTree(model.astype(np.float64)).query(
        query.astype(np.float64), workers=-1
    )
    return idx, d * d


def check_nn(idx, found, query, model, max_dist2, oracle):
    """The oracle contract of an exact NN engine, within the match
    radius: the chosen neighbour's d² (recomputed in f64) is within
    D2_TOL of the true minimum (ties are legal), the index agrees on
    MIN_INDEX_AGREEMENT of the queries, and ``found`` equals the strict
    ``d² < max_dist2`` except within BOUNDARY_TOL of the boundary.
    Returns the measured figures; raises AssertionError on a breach."""
    o_idx, o_d2 = oracle
    idx = np.asarray(idx)
    found = np.asarray(found)
    diff = query.astype(np.float64) - model.astype(np.float64)[idx]
    d2 = (diff * diff).sum(1)
    inside = o_d2 < max_dist2 - BOUNDARY_TOL
    gap = float((d2[inside] - o_d2[inside]).max(initial=0.0))
    agree = float((idx[inside] == o_idx[inside]).mean()) if inside.any() else 1.0
    want = o_d2 < max_dist2
    edge = np.abs(o_d2 - max_dist2) <= BOUNDARY_TOL
    bad_found = int(((found != want) & ~edge).sum())
    res = dict(max_d2_gap=gap, index_agreement=agree,
               found_mismatch=bad_found, in_radius=int(inside.sum()))
    assert gap <= D2_TOL, res
    assert agree >= MIN_INDEX_AGREEMENT, res
    assert bad_found == 0, res
    return res


def gpu_nn_engines(model, max_dist):
    """(name, jitted fn, args builder) for every NN engine the GPU path
    runs: the fused Triton brute kernel, XLA ``nn_brute`` (collision
    queries, scan conversion and the graphslam variants call it
    directly) and the XLA hashed cell list."""
    import jax
    import jax.numpy as jnp

    from tpu3dtk.ops import nn as nn_ops
    from tpu3dtk.ops.nn_triton import nn_brute_triton

    M = len(model)
    mj = jnp.asarray(model)
    mm = jnp.ones(M, bool)
    md2 = jnp.float32(max_dist**2)

    def brute_args(qj, qm):
        return (qj, qm, mj, mm, md2)

    H, cap = nn_ops.cell_hash_spec(model, np.ones(M, bool), max_dist)
    grid = nn_ops.build_cell_hash(
        mj, mm, jnp.asarray(model.min(axis=0)), jnp.float32(max_dist), H
    )

    def hash_fn(q, qm, g, d2):
        return nn_ops.nn_cell_hash(q, qm, g, d2, cap)

    return [
        ("triton_brute", jax.jit(nn_brute_triton), brute_args),
        ("xla_brute", jax.jit(nn_ops.nn_brute), brute_args),
        ("cell_hash", jax.jit(hash_fn),
         lambda qj, qm: (qj, qm, grid, md2)),
    ]


def room_and_hall():
    """The two kernel test clouds: (label, model, query, max_dist)."""
    rng = np.random.default_rng(7)
    out = []
    for label, n, lo, hi in (("room16k", 16384, -800.0, 800.0),
                             ("hall256k", 262144, 0.0, 5000.0)):
        model = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        query = (model[rng.permutation(n)]
                 + rng.normal(0, 5, (n, 3))).astype(np.float32)
        out.append((label, model, query, 25.0))
    return out


def phase_kernels():
    import jax
    import jax.numpy as jnp

    log("precision: f32 coordinates; the Triton kernel and XLA nn_brute "
        "rank by direct differences sum((q-m)^2); the hashed cell list "
        "computes them on gathered candidates")
    for label, model, query, max_dist in room_and_hall():
        oracle = oracle_nn(query, model)
        qj = jnp.asarray(query)
        qm = jnp.ones(len(query), bool)
        for name, fn, make_args in gpu_nn_engines(model, max_dist):
            args = make_args(qj, qm)
            compiled = fn.lower(*args).compile()
            ma = compiled.memory_analysis()
            log(f"  {label} {name}: memory_analysis "
                f"args={ma.argument_size_in_bytes} "
                f"out={ma.output_size_in_bytes} "
                f"temp={ma.temp_size_in_bytes}")
            idx, _, found = jax.block_until_ready(compiled(*args))
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*args))
            dt = time.perf_counter() - t0
            res = check_nn(idx, found, query, model, max_dist**2, oracle)
            log(f"  {label} {name}: {dt * 1e3:.3f} ms per call, {res}")


# ---------------------------------------------------------------------------
# end-to-end phases
# ---------------------------------------------------------------------------


def phase_cli():
    from make_golden import synth_loop

    from tpu3dtk.cli.slam6d import main as tpuslam
    from tpu3dtk.core import math3d
    from tpu3dtk.io import writer
    from tpu3dtk.io.converters import ate

    locals_, _, odo_mats = synth_loop(n_scans=60, seed=7, n_pts=6000)
    with tempfile.TemporaryDirectory() as td:
        scan_dir = os.path.join(td, "scans")
        out_dir = os.path.join(td, "frames")
        os.makedirs(scan_dir)
        os.makedirs(out_dir)
        for k, (loc, To) in enumerate(zip(locals_, odo_mats)):
            writer.write_uos(os.path.join(scan_dir, f"scan{k:03d}.3d"), loc)
            theta, pos = math3d.matrix4_to_euler(To, xp=np)
            writer.write_pose(
                os.path.join(scan_dir, f"scan{k:03d}.pose"), pos, theta
            )
        # the GraphPipeline settings of tests/test_ate.py::test_ate_loop60
        rc = tpuslam([
            scan_dir, "-r", "25", "-O", "1", "-d", "50", "-i", "50",
            "--epsICP", "1e-6", "-G", "1", "-D", "50", "-I", "20",
            "--epsSLAM", "0.05", "-L", "4", "--cldist", "700",
            "--loopsize", "10", "--frames-out", out_dir, "-q",
        ])
        assert rc == 0, f"tpuslam returned {rc}"
        res = ate(out_dir, GOLDEN_LOOP60, align=True)
    log(f"  cli loop60 ATE rmse {res['rmse']:.3f} cm (gate 10 cm)")
    assert res["rmse"] < 10.0, res


def _h468_scans():
    import bench
    from make_golden import synth_ring

    locals_, true_mats, odo_mats = synth_ring(n_scans=468)
    return bench._scans_from(locals_, odo_mats, 10.0), true_mats


def phase_h468():
    import bench

    scans, true_mats = _h468_scans()
    t0 = time.perf_counter()
    bench.h468_pipeline().run(scans)
    err = bench._ate_cm(scans, true_mats)
    log(f"  h468: pipeline {time.perf_counter() - t0:.1f} s, ATE rmse "
        f"{err:.3f} cm (gate {bench.H468_ATE_GATE_CM:.2f} cm)")
    assert err < bench.H468_ATE_GATE_CM, err


def phase_city():
    import bench
    from make_golden import synth_city

    locals_, true_mats, odo_mats = synth_city(n_scans=13)
    scans = bench._scans_from(locals_, odo_mats, 20.0)
    t0 = time.perf_counter()
    bench.city_pipeline(scans)
    err = bench._ate_cm(scans, true_mats)
    n_red = int(np.mean([len(s.reduced_local()) for s in scans]))
    log(f"  city: {len(scans)} scans, {n_red} reduced points per scan, "
        f"pipeline {time.perf_counter() - t0:.1f} s, ATE rmse {err:.3f} cm "
        f"(gate {bench.CITY_ATE_GATE_CM:.2f} cm)")
    assert err < bench.CITY_ATE_GATE_CM, err


def phase_four():
    """h468 with mesh="auto" (ICP pair statistics and LUM links sharded
    over all 4 cards) against the same run on one card.
    Under a mesh the pipeline matches scan by scan from the host, so the
    one-card run takes that driver path too (device_segments=False):
    the two runs differ only in the sharding."""
    import jax

    import bench

    n = len(jax.devices())
    assert n == 4, f"--four needs 4 devices, JAX found {n}"
    scans, true_mats = _h468_scans()
    runs = {}
    for label, mesh in (("4 cards", "auto"), ("1 card", None)):
        run_scans = bench._copies(scans)
        t0 = time.perf_counter()
        bench.h468_pipeline(
            seq_mesh=mesh, lum_mesh=mesh, device_segments=False
        ).run(run_scans)
        err = bench._ate_cm(run_scans, true_mats)
        log(f"  h468 on {label}: {time.perf_counter() - t0:.1f} s, ATE "
            f"rmse {err:.3f} cm (gate {bench.H468_ATE_GATE_CM:.2f} cm)")
        assert err < bench.H468_ATE_GATE_CM, (label, err)
        runs[label] = np.stack([s.transMat[:3, 3] for s in run_scans])
    dev = np.linalg.norm(runs["4 cards"] - runs["1 card"], axis=1)
    log(f"  4-card vs 1-card final positions: max {dev.max():.4f} cm, "
        f"mean {dev.mean():.4f} cm (limit 1 cm)")
    assert dev.max() < 1.0, dev.max()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="SLAM main-path smoke run")
    p.add_argument("--four", action="store_true",
                   help="only the 4-card sharded h468 run and its 1-card "
                   "comparison")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import jax

    import bench
    import tpu3dtk  # noqa: F401  (x64, matmul precision, compile cache)

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform} devices only",
              file=sys.stderr)
        return 1
    jax.monitoring.register_event_duration_secs_listener(_on_event)
    card = bench.gpu_name_and_power()
    log(f"card: {card}; JAX {jax.__version__}, {len(devs)} x "
        f"{devs[0].device_kind}")

    phases = {"four": phase_four} if args.four else {
        "kernels": phase_kernels,
        "cli": phase_cli,
        "h468": phase_h468,
        "city": phase_city,
    }
    for name, run in phases.items():
        with Phase(name):
            run()
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
