"""Test configuration: a virtual 8-device CPU mesh with x64 enabled.

Mirrors the reference's CI strategy of testing distributed behaviour on one
node (reference .github/workflows/main.yaml:84-87, `mpirun -np 4`): here the
"ranks" are 8 virtual XLA CPU devices and distribution is NamedSharding.

The suite runs on the CPU unless ``JAX_PLATFORMS`` says otherwise.  Tests
marked ``gpu`` need an NVIDIA GPU; they skip elsewhere, decided per test
by the ``_gpu_only`` fixture (never at import, so every xdist worker
collects the same tests).  Run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when JAX's default backend is no GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default backend is {backend}")


@pytest.fixture
def mesh8():
    """An installed 8-device mesh for sharding tests."""
    from draco_tpu.parallel import make_mesh, use_mesh

    with use_mesh(make_mesh()) as m:
        yield m


@pytest.fixture
def rng():
    return np.random.Generator(np.random.SFC64(1234))
