"""GPU tier: the NN engines of the GPU path against a scipy cKDTree f64
oracle on the card itself, with the checks chip_smoke.py makes at full
size, and the dat pipeline's ATE on the card.  Needs an NVIDIA GPU;
skips without one:

    python -m pytest tests/test_gpu_accuracy.py -m gpu -q
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {jax.default_backend()}")
    return jax.devices()[0]


@pytest.fixture(scope="module")
def room():
    rng = np.random.default_rng(7)
    model = rng.uniform(-800, 800, (8192, 3)).astype(np.float32)
    query = (model[rng.permutation(8192)]
             + rng.normal(0, 5, (8192, 3))).astype(np.float32)
    return model, query


GOLDEN_DAT = os.path.join(os.path.dirname(__file__), "golden", "dat")


@pytest.mark.parametrize("engine", ["triton_brute", "xla_brute", "cell_hash"])
def test_nn_engine_matches_oracle(gpu, room, engine):
    import jax.numpy as jnp

    import chip_smoke

    model, query = room
    oracle = chip_smoke.oracle_nn(query, model)
    engines = {
        name: (fn, make_args)
        for name, fn, make_args in chip_smoke.gpu_nn_engines(model, 25.0)
    }
    fn, make_args = engines[engine]
    idx, _, found = fn(*make_args(jnp.asarray(query), jnp.ones(8192, bool)))
    chip_smoke.check_nn(idx, found, query, model, 625.0, oracle)


def test_brute_auto_runs_the_triton_kernel_on_gpu(gpu, room):
    """nn_brute_auto is the fused kernel on a GPU: same answers as the
    XLA brute engine within the match radius."""
    import jax.numpy as jnp

    from tpu3dtk.ops import nn as nn_ops

    model, query = room
    args = (jnp.asarray(query), jnp.ones(8192, bool), jnp.asarray(model),
            jnp.ones(8192, bool), jnp.float32(625.0))
    _, d2a, fa = nn_ops.nn_brute_auto(*args)
    _, d2b, fb = nn_ops.nn_brute(*args)
    np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    sel = np.asarray(fa)
    np.testing.assert_allclose(np.asarray(d2a)[sel], np.asarray(d2b)[sel],
                               atol=0.5)


def test_ate_dat_on_gpu(gpu, dat_dir, tmp_path):
    """The dat pipeline (metascan ICP + LUM) on the card holds the ATE
    gate of tests/test_ate.py::test_ate_dat against the f64 oracle."""
    if not os.path.isdir(GOLDEN_DAT):
        pytest.skip("golden dat missing")
    from test_ate import run_dat_pipeline

    from tpu3dtk.io.converters import ate

    out = str(tmp_path / "frames")
    run_dat_pipeline(dat_dir, out)
    res = ate(out, GOLDEN_DAT, align=False)
    assert res["rmse"] < 5.0, res
    assert res["max"] < 8.0, res
