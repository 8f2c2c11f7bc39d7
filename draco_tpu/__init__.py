"""draco-tpu: a JAX framework for drift-scan radio interferometry.

A ground-up JAX/XLA re-design of the capabilities of
``radiocosmology/draco`` (plus the slices of its runtime deps caput,
driftscan and cora that draco relies on): typed axis-labelled distributed
containers, a YAML-driven task pipeline, the m-mode formalism
(simulate: sky map -> beam transfer -> visibilities; analyze:
visibilities -> m-modes -> maps), delay spectra, ring maps, flagging and
the full analysis/synthesis task library.

Design stance (see SURVEY.md section 7): arrays are ``jax.Array`` with
``NamedSharding`` over a device mesh instead of MPI-distributed ndarrays;
per-m/per-freq Python loops become vmapped/scanned batched device kernels;
MPI collectives become XLA collectives between devices.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# An f32 dot left at JAX's default precision may run in TF32 on a GPU
# (~1e-3 relative error per GEMM), two orders of magnitude above the
# 1e-5 science requirement.  So default every dot to true f32 unless the
# user has already chosen a precision.  (The SHT additionally pins
# Precision.HIGHEST per contraction; this covers the rest of the task
# library.)  Opt out with DRACO_TPU_KEEP_MATMUL_PRECISION.
if (
    _jax.config.jax_default_matmul_precision is None
    and not _os.environ.get("DRACO_TPU_KEEP_MATMUL_PRECISION")
):
    _jax.config.update("jax_default_matmul_precision", "highest")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    this sets no directory.  Otherwise the cache goes to ``.jax_cache``
    at the root of the checkout holding this package: a fixed path, so
    later processes find what earlier ones stored.
    """
    env_dir = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    cache_dir = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    _jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir


from . import parallel  # noqa: F401
