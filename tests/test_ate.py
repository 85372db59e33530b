"""Accuracy oracle tests (BASELINE.md step 2).

The golden trajectories in tests/golden/ were produced by
scripts/make_golden.py — an independent f64 CPU implementation of the
reference pipeline (scipy cKDTree NN + Horn quaternion ICP + f64 LUM,
the math of src/slam6d/icp6D.cc:104-285 and src/slam6d/lum6Deuler.cc),
run to tight convergence.  These tests run the JAX pipeline on the same
inputs and assert the absolute trajectory error (the metric of
src/slam6d/match_with_ground_truth.cc) stays within bounds.
"""

import os

import numpy as np
import pytest

from tpu3dtk.core.scan import TPUScan
from tpu3dtk.io.converters import ate
from tpu3dtk.io.scandir import PointFilter, read_scan_dir
from tpu3dtk.models.graphslam import LumParams, do_graph_slam
from tpu3dtk.models.icp import IcpParams
from tpu3dtk.models.sequence import SequenceRegistration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def run_dat_pipeline(dat_dir, out_dir):
    """The golden-dat workload: metascan ICP + LUM over the 3-scan
    bundled sequence (mirrors scripts/make_golden.py golden_dat)."""
    scans = []
    for raw in read_scan_dir(
        dat_dir, format="uos", point_filter=PointFilter(range_max=500.0)
    ):
        s = TPUScan.from_raw(raw)
        s.set_reduction(10.2, 1)
        scans.append(s)
    reg = SequenceRegistration(
        params=IcpParams(max_dist_match2=625.0, max_iterations=50, epsilon=1e-7),
        metascan=True,
    )
    reg.run(scans)
    links = np.array(
        [(i, i + 1) for i in range(len(scans) - 1)] + [(0, len(scans) - 1)],
        np.int32,
    )
    do_graph_slam(
        scans,
        links,
        LumParams(max_dist_match2=625.0, iterations=50, epsilon=1e-5),
    )
    write_all_frames(scans, out_dir)
    return scans


def write_all_frames(scans, out_dir):
    from tpu3dtk.io import frames as frames_io

    os.makedirs(out_dir, exist_ok=True)
    for s in scans:
        mats = np.stack([m for m, _ in s.frames]) if s.frames else s.transMat[None]
        types = [t for _, t in s.frames] or [2]
        frames_io.write_frames(
            frames_io.frames_path(out_dir, s.identifier), mats, types
        )


@pytest.mark.skipif(
    not os.path.isdir(os.path.join(GOLDEN, "dat")), reason="golden dat missing"
)
def test_ate_dat(dat_dir, tmp_path):
    out = str(tmp_path / "frames")
    run_dat_pipeline(dat_dir, out)
    res = ate(out, os.path.join(GOLDEN, "dat"), align=False)
    # f32 JAX pipeline vs f64 oracle on a ~3 m trajectory: poses must
    # agree to a few cm (the oracle itself is converged to < 1 mm).
    assert res["rmse"] < 5.0, res
    assert res["max"] < 8.0, res


@pytest.mark.slow
@pytest.mark.skipif(
    not os.path.isdir(os.path.join(GOLDEN, "loop60")),
    reason="golden loop60 missing",
)
def test_ate_loop60(tmp_path):
    """Synthetic 60-scan loop with EXACT ground truth: the full
    GraphPipeline (ICP + ELCH + LUM) must pull the drifted odometry back
    onto the true circuit."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from make_golden import synth_loop

    from tpu3dtk.models.graph_pipeline import GraphPipeline

    locals_, true_mats, odo_mats = synth_loop()
    scans = []
    for k, (loc, To) in enumerate(zip(locals_, odo_mats)):
        s = TPUScan.from_points(loc, f"{k:03d}", To)
        s.set_reduction(25.0, 1)
        scans.append(s)
    pipe = GraphPipeline(
        icp_params=IcpParams(
            max_dist_match2=2500.0, max_iterations=50, epsilon=1e-6
        ),
        lum_max_dist2=2500.0,
        lum_iterations=20,
        lum_epsilon=0.05,
        elch=True,
        cldist=700.0,
        loopsize=10,
    )
    pipe.run(scans)
    out = str(tmp_path / "frames")
    write_all_frames(scans, out)
    res = ate(out, os.path.join(GOLDEN, "loop60"), align=True)
    # odometry drift alone is tens of cm RMSE; the pipeline must land
    # within a few cm of ground truth.
    assert res["rmse"] < 10.0, res
