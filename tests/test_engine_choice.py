"""Which NN engine the drivers run.

One constant, ops.nn.GRID_MIN_POINTS (the crossover measured on the
GPU), sends model windows at or above it to the hashed cell list; that
route must give the brute engine's results."""

import os
import re

import numpy as np
import pytest

from tpu3dtk.core import math3d
from tpu3dtk.core.scan import TPUScan
from tpu3dtk.models import graph_pipeline as gp
from tpu3dtk.models import graphslam as gs
from tpu3dtk.models.icp import IcpParams
from tpu3dtk.models.sequence import SequenceRegistration
from tpu3dtk.ops import nn as nn_ops
from tests.conftest import make_room_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scans(rng, n_scans=3, n=3000, size=600.0, drift=4.0):
    world = make_room_cloud(rng, n=n, size=size)
    scans = []
    for k in range(n_scans):
        T = np.asarray(math3d.euler_to_matrix4(
            [8.0 * k, 0.0, 4.0 * k], [0.0, 0.01 * k, 0.0]
        ))
        local = np.asarray(math3d.transform3(math3d.m4inv(T), world))
        noise = np.asarray(math3d.euler_to_matrix4(
            rng.uniform(-drift, drift, 3), rng.uniform(-0.01, 0.01, 3)
        ))
        s = TPUScan.from_points(local, f"{k:03d}", T if k == 0 else noise @ T)
        s.set_reduction(10.0, 1)
        scans.append(s)
    return scans


def _copy(scans):
    out = []
    for s in scans:
        c = TPUScan.from_points(s.reduced_local(), s.identifier, s.transMatOrg)
        c._reduced_local = s.reduced_local()
        out.append(c)
    return out


@pytest.mark.parametrize("metascan", [False, True], ids=["window1", "metascan"])
def test_sequence_hash_route_equals_brute(rng, monkeypatch, metascan):
    """A model window at the crossover goes to nn_cell_hash, and the
    registered poses equal the brute engine's."""
    scans = _scans(rng)
    params = IcpParams(max_dist_match2=625.0, max_iterations=40, epsilon=1e-7)
    # the brute reference on the same per-match path (run() would take
    # the fused on-device sequence loop, with its own f32 pose rounding)
    brute = _copy(scans)
    ref = SequenceRegistration(
        params=params, metascan=metascan, nns="brute", mesh=None
    )
    for i in range(1, len(brute)):
        ref.run_single(brute, i)
    monkeypatch.setattr(nn_ops, "GRID_MIN_POINTS", 512)
    reg = SequenceRegistration(params=params, metascan=metascan, mesh=None)
    reg.run(scans)
    assert reg._prep["grid_buckets"] > 0  # the hashed cell list ran
    # the hash may pair exact ties differently; ICP stops once a step
    # moves less than 100 um (models.icp pose-fixpoint test), so poses
    # agree to that scale
    for a, b in zip(scans, brute):
        np.testing.assert_allclose(a.transMat[:3, 3], b.transMat[:3, 3],
                                   atol=2e-2)
        np.testing.assert_allclose(a.transMat[:3, :3], b.transMat[:3, :3],
                                   atol=1e-4)


def test_lum_hash_large_cap_equals_brute(rng):
    """LUM link covariances on the hash path, with buckets holding
    hundreds of points (a small room matched at 1 m), relax to the brute
    poses."""
    scans = _scans(rng, n_scans=3, n=6000, size=200.0, drift=3.0)
    links = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    H, cap = gs.local_grid_spec(scans, 100.0, grid_max_cap=10_000)
    assert cap >= 128, cap
    out = {}
    for nns in ("grid", "brute"):
        run = _copy(scans)
        gs.do_graph_slam(run, links, gs.LumParams(
            max_dist_match2=1e4, iterations=5, epsilon=1e-6, nns=nns,
            grid_max_cap=10_000, mesh=None,
        ))
        out[nns] = np.stack([s.transMat for s in run])
    np.testing.assert_allclose(out["grid"], out["brute"], atol=1e-3)


@pytest.mark.parametrize("consumer", ["sequence", "lum", "pipeline"])
def test_crossover_constant_is_read(rng, monkeypatch, consumer):
    """Every driver takes its brute/hash threshold from the one
    constant: a window of 2k-3k points routes to the hash when the
    constant is below it, and stays brute when it is above."""
    scans = _scans(rng, n_scans=2, n=2400)
    for threshold, want_grid in ((1024, True), (1 << 30, False)):
        monkeypatch.setattr(nn_ops, "GRID_MIN_POINTS", threshold)
        if consumer == "sequence":
            prep = SequenceRegistration(mesh=None)._prepare(scans)
            assert prep["grid_min"] == threshold
            got = bool(prep["grid_buckets"]) and prep["cap"] >= threshold
        elif consumer == "lum":
            got = max(len(s.reduced_local()) for s in scans) >= gs._grid_min(
                gs.LumParams()
            )
        else:
            pipe = gp.GraphPipeline()
            pipe._prepare_statics(scans)
            got = bool(pipe._grid_specs)
        assert got == want_grid, (consumer, threshold)


def test_no_other_engine_threshold_in_the_drivers():
    """No backend-keyed branch or literal threshold beside the constant."""
    pat = re.compile(r"default_backend\(\)\s*==|\b131072\b|\b2_000_000\b")
    hits = []
    for sub in ("models", "parallel"):
        d = os.path.join(REPO, "tpu3dtk", sub)
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".py"):
                with open(os.path.join(d, fn)) as f:
                    hits += [f"{fn}: {ln.strip()}" for ln in f if pat.search(ln)]
    assert not hits, hits
