"""Multi-host execution test: a REAL 2-process jax.distributed
job on localhost (the skeleton must be exercised, not just
importable).

Each process simulates one host with 2 virtual CPU devices; the
link-sharded LUM relaxation runs on the (2 hosts x 2 devices) mesh with
its G/B psum crossing the process boundary.  The result must match a
single-process run of the same problem.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "helpers", "dist_lum_worker.py")


def _launch(pid: int, nproc: int, port: int, out: str):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(
        JAX_COORDINATOR=f"localhost:{port}",
        NPROC=str(nproc),
        PROC_ID=str(pid),
        JAX_PLATFORMS="cpu",
        JAX_ENABLE_COMPILATION_CACHE="false",
        PYTHONPATH=REPO,
    )
    return subprocess.Popen(
        [sys.executable, WORKER, out],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        cwd=REPO,
    )


@pytest.mark.slow
def test_two_process_lum(tmp_path):
    out = str(tmp_path / "dist_result.npz")
    port = 29517
    procs = [_launch(pid, 2, port, out) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=600)
            logs.append(stdout.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert os.path.exists(out), logs[0][-3000:]
    res = np.load(out)
    assert int(res["n_proc"]) == 2
    assert bool(res["was_dist"])
    # one mesh row per host; per-host device count is platform-dependent
    shape = tuple(int(x) for x in res["mesh_shape"])
    assert shape[0] == 2 and shape[1] >= 1

    # single-process reference of the identical problem
    sys.path.insert(0, os.path.join(REPO, "tests", "helpers"))
    from dist_lum_worker import build_problem

    import jax.numpy as jnp

    from tpu3dtk.models.lum_device import lum_run

    locals_, masks, links, pos0, theta0 = build_problem()
    pos_ref, theta_ref, hist, it, ret = lum_run(
        jnp.asarray(locals_), jnp.asarray(masks),
        jnp.asarray(links), jnp.asarray(np.ones(len(links), bool)),
        jnp.asarray(pos0), jnp.asarray(theta0),
        jnp.int32(len(locals_)), jnp.float32(625.0), jnp.float32(1e-4),
        iterations=5,
    )
    np.testing.assert_allclose(res["pos"], np.asarray(pos_ref), atol=1e-3)
    np.testing.assert_allclose(res["theta"], np.asarray(theta_ref), atol=1e-5)


@pytest.mark.slow
def test_two_process_slam6d_cli(tmp_path, dat_dir):
    """End-to-end ``tpuslam --distributed`` on 2 localhost processes:
    host-sharded ingest + replicated matching + host-sharded LUM must
    reproduce the single-process poses."""
    port = 29519

    def run_cli(extra_env, out_dir, distributed):
        os.makedirs(out_dir, exist_ok=True)
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update(
            JAX_PLATFORMS="cpu",
            JAX_ENABLE_COMPILATION_CACHE="false",
            PYTHONPATH=REPO,
            **extra_env,
        )
        cmd = [
            sys.executable, "-m", "tpu3dtk.cli.slam6d",
            "-m", "2500", "-r", "15", "-d", "25", "-i", "20",
            "-G", "1", "-I", "5", "-q",
            "--frames-out", out_dir,
        ]
        if distributed:
            cmd.insert(3, "--distributed")
        cmd.append(dat_dir)
        return subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=REPO,
        )

    out_d = str(tmp_path / "dist")
    procs = [
        run_cli(
            dict(
                JAX_COORDINATOR=f"localhost:{port}",
                NPROC="2",
                PROC_ID=str(pid),
            ),
            out_d,
            distributed=True,
        )
        for pid in range(2)
    ]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=900)
            logs.append(stdout.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed CLI timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    out_s = str(tmp_path / "single")
    p = run_cli({}, out_s, distributed=False)
    stdout, _ = p.communicate(timeout=900)
    assert p.returncode == 0, stdout.decode(errors="replace")[-3000:]

    from tpu3dtk.io import frames as frames_io

    for ident in ("000", "001", "002"):
        fd = frames_io.final_pose(os.path.join(out_d, f"scan{ident}.frames"))
        fs = frames_io.final_pose(os.path.join(out_s, f"scan{ident}.frames"))
        np.testing.assert_allclose(fd, fs, atol=1e-2)
