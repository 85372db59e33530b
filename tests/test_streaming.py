"""Out-of-core streaming registration: resident scan bytes stay bounded
by the cache budget while the trajectory stays correct (the scanserver
capability, README.scanserver.md + cacheManager.cc:79-113)."""

import gc
import weakref

import numpy as np
import pytest

from tests.conftest import make_room_cloud


@pytest.fixture()
def scan_dir(tmp_path, rng):
    """24 scans of a room, each ~0.9 MB on disk, walking diagonally."""
    n = 20000
    room = make_room_cloud(rng, n=n, size=1200.0)
    for k in range(24):
        off = np.array([k * 10.0, 0.0, k * 6.0])
        local = room - off + rng.normal(0, 0.5, room.shape)
        np.savetxt(tmp_path / f"scan{k:03d}.3d", local, fmt="%.1f")
        drift = rng.normal(0, 1.0, 3)
        (tmp_path / f"scan{k:03d}.pose").write_text(
            f"{off[0]+drift[0]} {off[1]+drift[1]} {off[2]+drift[2]}\n0 0 0\n"
        )
    return tmp_path, room


def test_streaming_bounded_memory_and_trajectory(scan_dir):
    import tpu3dtk.io.cache as cache_mod
    from tpu3dtk.io.cache import ScanCache
    from tpu3dtk.models.icp import IcpParams
    from tpu3dtk.models.streaming import register_streaming

    tmp_path, room = scan_dir
    # a budget much smaller than the sequence: 24 reduced scans ~ 24 x
    # ~0.2 MB; budget 0.5 MB forces eviction after ~2 scans
    budget = 512 << 10
    cache = ScanCache(budget)

    # track every scan array ever created by the loader: the ALIVE set
    # at any moment is the true resident footprint
    live = []

    orig_read = cache_mod.read_scan

    def tracking_read(*a, **k):
        raw = orig_read(*a, **k)
        for v in raw.channels.values():
            live.append((weakref.ref(v), v.nbytes))
        return raw

    peak = 0

    def alive_bytes():
        return sum(nb for r, nb in live if r() is not None)

    cache_mod.read_scan = tracking_read
    try:
        results = register_streaming(
            str(tmp_path), format="uos",
            params=IcpParams(
                max_dist_match2=2500.0, max_iterations=30, epsilon=1e-6
            ),
            reduction=(15.0, 1),
            cache=cache,
        )
        gc.collect()
        peak = alive_bytes()
    finally:
        cache_mod.read_scan = orig_read

    assert len(results) == 24
    # trajectory: each scan's recovered position ~ (10k, 0, 6k)
    for k, r in enumerate(results):
        want = np.array([k * 10.0, 0.0, k * 6.0])
        assert np.linalg.norm(r["pose"][:3, 3] - want) < 3.0, (k, r["pose"][:3, 3])
    # raw file payloads died; the final resident set is a few reduced
    # scans, not the sequence
    total_raw = 24 * 20000 * 3 * 8
    assert peak < total_raw / 4
    assert cache._bytes <= budget


def test_streaming_cli_cache_mb(scan_dir, tmp_path_factory):
    """tpuslam --cache-mb drives the streaming path end-to-end."""
    import os
    import subprocess
    import sys

    tmp_path, _ = scan_dir
    out = tmp_path_factory.mktemp("frames")
    r = subprocess.run(
        [sys.executable, "-m", "tpu3dtk.cli.slam6d", "-r", "15",
         "-d", "50", "-i", "20", "--cache-mb", "1",
         "--frames-out", str(out), str(tmp_path)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "JAX_ENABLE_COMPILATION_CACHE": "false"},
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "scan023.frames").exists()
