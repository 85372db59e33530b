"""Placement of JAX's persistent compilation cache (tpu3dtk/__init__):
JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed directory
inside the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "checkout"])
def test_cache_dir(tmp_path, env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, tpu3dtk; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(tpu3dtk.compile_cache_dir())"],
        env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    used, own = r.stdout.split()
    if env_dir:
        assert used == str(tmp_path) and own == "None"
    else:
        assert used == own == os.path.join(REPO, ".jax_cache")
