"""tpu3dtk — a 6D-SLAM / point-cloud framework on JAX.

A from-scratch re-design of the capabilities of 3DTK ("The 3D Toolkit")
as batched accelerator programs: JAX/XLA for the compute graph, a Pallas
kernel for the brute-force NN hot loop, jax.sharding/shard_map for
multi-device scaling.  The import name is ``tpu3dtk``.  Layout follows
SURVEY.md §7:

- ``core``      math & scan abstractions   (ref: include/slam6d/globals.icc, scan.h)
- ``io``        scan/pose/frames I/O       (ref: src/scanio/)
- ``ops``       device kernels: reduction, NN search, transforms, normals
- ``models``    registration algorithms: ICP, minimizers, GraphSLAM, ELCH
- ``parallel``  mesh/sharding layer (no analog in the reference: it is single-node)
- ``utils``     metrics, config
- ``cli``       drivers mirroring the reference binaries (slam6D, scan_red, ...)

Dtype policy: f64 is enabled globally so host-side pose math matches the
reference's double precision; all hot device kernels request f32
explicitly.
"""

import os as _os

from jax import config as _config

_config.update("jax_enable_x64", True)

# f32 matrix products at full f32 precision.  On a GPU the default lets
# XLA run them in TF32 (10 mantissa bits): with cm-scale coordinates a
# few metres from the origin that corrupts the matmul-expanded NN
# distances (ops.nn.nn_brute) by far more than the match radius, and
# the ICP / LUM statistics lose their low digits.
_config.update("jax_default_matmul_precision", "highest")

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir():
    """Directory for JAX's persistent compilation cache, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads it itself).
    The default is a fixed path inside the checkout, so every process
    of a checkout shares one cache."""
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return None
    return _os.path.join(_CHECKOUT, ".jax_cache")


if (_cache_dir := compile_cache_dir()) is not None:
    _config.update("jax_compilation_cache_dir", _cache_dir)

from . import core, io, ops, models, parallel, utils  # noqa: E402,F401

__version__ = "0.1.0"
