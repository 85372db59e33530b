"""chip_smoke.py refuses to report without a GPU: non-zero exit and no
result line, both here (JAX on the CPU) and alone in a directory that
holds none of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, str(script)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    if where == "checkout":
        assert "no GPU" in r.stderr, r.stderr[-2000:]
