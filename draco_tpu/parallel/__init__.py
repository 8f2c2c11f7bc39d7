"""Parallelism layer: device mesh, named-axis sharding, collectives.

Replaces the reference stack's MPI backbone (caput.mpiarray.MPIArray and
mpi4py collectives; see SURVEY.md section 2.5) with a JAX device mesh.  A
container dataset's ``distributed_axis`` maps onto the mesh axis, and
``redistribute`` is a resharding ``device_put`` (an all-to-all between devices under
XLA) instead of an MPI all-to-all.
"""

from .mesh import (  # noqa: F401
    SHARD_AXIS,
    get_mesh,
    make_hybrid_mesh,
    make_mesh,
    make_mesh2d,
    set_mesh,
    sharding_for_axis,
    sharding_for_named_axes,
    shard_array,
    shard_array_named,
    unshard,
    use_mesh,
)
from . import multihost  # noqa: F401,E402
from .validate import (  # noqa: F401,E402
    DeterminismError,
    assert_deterministic,
    assert_sharding_invariant,
    check_pipeline_determinism,
    compare_products,
    fingerprint,
)
