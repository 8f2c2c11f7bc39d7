"""Global device mesh and named-axis sharding helpers.

The reference framework distributes every container dataset along one named
axis via ``caput.mpiarray.MPIArray`` (reference ``draco/core/containers.py``
``_dataset_spec['distributed_axis']``) and re-distributes with an MPI
all-to-all.  Here the equivalent is a 1-D (or multi-D) ``jax.sharding.Mesh``:
a dataset distributed along axis ``i`` is a global ``jax.Array`` with a
``NamedSharding`` whose :class:`PartitionSpec` shards dim ``i`` over the mesh
axis.  ``redistribute`` becomes a resharding ``device_put`` which XLA lowers
to an all-to-all between devices.

If no mesh has been installed (single-device use, unit tests), everything is
a no-op and arrays are ordinary single-device arrays.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

# Name of the default mesh axis that container distributed axes map onto.
SHARD_AXIS = "shard"

# Genuinely process-global (a plain module attribute, not thread-local):
# container transfers and task work may run on worker threads, which must
# see the mesh the main thread installed.
_mesh: Mesh | None = None


def make_mesh(devices=None, axis_name: str = SHARD_AXIS) -> Mesh:
    """Create a 1-D mesh over ``devices`` (default: all available)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh2d(
    shape: tuple[int, int] | None = None,
    axis_names: tuple[str, str] = ("freq", "m"),
    devices=None,
) -> Mesh:
    """Create a 2-D mesh whose axes are *named after container axes*.

    This is the production (freq x m) layout of SURVEY.md section 2.5:
    under a mesh with axes ``("freq", "m")`` every container dataset
    axis called ``freq`` or ``m`` is sharded over the matching mesh
    axis, so the SHT stage runs freq-parallel and the per-m solve stage
    m-parallel with XLA inserting the freq<->m all-to-alls (the
    reference's MPI parallel transposes, reference
    draco/synthesis/stream.py:96,119, draco/analysis/mapmaker.py:62-99).

    ``shape=None`` picks the most-square factorisation of the device
    count (1-D fallback for primes).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        first = 1
        for d in range(int(np.sqrt(n)), 0, -1):
            if n % d == 0:
                first = d
                break
        shape = (first, n // first)
    if shape[0] * shape[1] != n:
        raise ValueError(
            f"mesh shape {shape} does not cover the {n} devices provided"
        )
    return Mesh(np.asarray(devices).reshape(shape), tuple(axis_names))


def make_hybrid_mesh(
    ici_shape: tuple[int, ...],
    dcn_shape: tuple[int, ...],
    axis_names: tuple[str, ...] = ("freq", "m"),
    devices=None,
) -> Mesh:
    """Mesh spanning several hosts: between-host outer, in-host inner.

    The multi-host scale-out layout for the CHIME-scale problem
    (BASELINE.json: 1024 frequencies): each mesh axis's global extent is
    ``dcn_shape[i] * ici_shape[i]``, with the between-host factor
    (``dcn_shape``) outermost and the in-host factor (``ici_shape``)
    innermost.  Put the **freq** axis between hosts — frequencies are
    embarrassingly parallel through the whole m-mode spine (verified by
    the freq-sharded SPMD tests), so the only between-host traffic is
    the initial scatter and final gather, while the freq<->m parallel
    transposes (the all-to-alls of reference
    draco/synthesis/stream.py:96,119) stay on each host's own links.

    Where devices report a ``slice_index`` the device grid comes from
    ``jax.experimental.mesh_utils.create_hybrid_device_mesh``; otherwise
    (one host of GPUs, or the virtual CPU-mesh test platform) a
    contiguous block layout stands in so the same program shapes
    compile and run anywhere.
    """
    if devices is None:
        devices = jax.devices()
    if len(ici_shape) != len(dcn_shape) or len(ici_shape) != len(axis_names):
        raise ValueError(
            "ici_shape, dcn_shape and axis_names must have equal length; "
            f"got {ici_shape}, {dcn_shape}, {axis_names}"
        )
    total = int(np.prod(ici_shape)) * int(np.prod(dcn_shape))
    if total != len(devices):
        raise ValueError(
            f"mesh of {total} positions does not cover the "
            f"{len(devices)} devices provided"
        )

    n_slices = len({getattr(d, "slice_index", 0) for d in devices})
    if n_slices > 1:
        from jax.experimental import mesh_utils

        dev_grid = mesh_utils.create_hybrid_device_mesh(
            ici_shape, dcn_shape, devices=devices
        )
    else:
        # no slice topology: contiguous blocks, between-host factors
        # outermost so each in-host block is a contiguous device range
        grid = np.asarray(devices).reshape(*dcn_shape, *ici_shape)
        n = len(ici_shape)
        # interleave (dcn_i, ici_i) per axis then merge the pairs
        order = [
            ax for i in range(n) for ax in (i, n + i)
        ]
        dev_grid = grid.transpose(order).reshape(
            tuple(d * i for d, i in zip(dcn_shape, ici_shape))
        )
    return Mesh(dev_grid, tuple(axis_names))


def set_mesh(mesh: Mesh | None) -> None:
    """Install ``mesh`` as the process-global mesh (None to clear)."""
    global _mesh
    _mesh = mesh


def get_mesh() -> Mesh | None:
    """Return the installed mesh, or None if running unsharded."""
    return _mesh


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None):
    """Temporarily install ``mesh``."""
    old = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(old)


def _mesh_axis(mesh: Mesh) -> str:
    """The mesh axis used for container sharding (first axis by default)."""
    if SHARD_AXIS in mesh.axis_names:
        return SHARD_AXIS
    return mesh.axis_names[0]


def sharding_for_axis(
    ndim: int, axis: int | None, mesh: Mesh | None = None
) -> NamedSharding | None:
    """A NamedSharding placing ``axis`` on the mesh shard axis.

    Returns None when no mesh is active.  ``axis=None`` gives full
    replication.
    """
    if mesh is None:
        mesh = get_mesh()
    if mesh is None:
        return None
    spec = [None] * ndim
    if axis is not None:
        spec[axis] = _mesh_axis(mesh)
    return NamedSharding(mesh, PartitionSpec(*spec))


def _put(arr, sharding):
    """Place/reshard ``arr`` under ``sharding``, multi-process safe.

    ``jax.device_put`` handles host->global uploads (every process
    passes the identical host value) and all single-process reshards,
    but rejects resharding an existing global array whose devices span
    processes — that parallel transpose must run as a compiled
    collective, so it routes through a jitted identity with
    ``out_shardings`` (XLA emits the all-to-all/all-gather).
    """
    if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
        return jax.jit(lambda x: x, out_shardings=sharding)(arr)
    return jax.device_put(arr, sharding)


def shard_array(arr, axis: int | None):
    """Reshard ``arr`` so dim ``axis`` is split across the mesh.

    This is the JAX ``MPIArray.redistribute``: under a mesh the
    ``device_put`` is an all-to-all between devices; with no mesh it is a no-op.  If the
    axis length does not divide the mesh size the array is replicated
    instead (matching the reference's fallback of keeping data local).
    """
    mesh = get_mesh()
    if mesh is None:
        return arr
    if axis is not None:
        axis = axis % arr.ndim
        nshard = mesh.shape[_mesh_axis(mesh)]
        if arr.shape[axis] % nshard != 0:
            axis = None  # replicate: not evenly divisible
    sharding = sharding_for_axis(arr.ndim, axis, mesh)
    return _put(arr, sharding)


def _is_named_mesh(mesh: Mesh) -> bool:
    """True for meshes whose axes name container axes (multi-axis)."""
    return len(mesh.axis_names) > 1 or mesh.axis_names[0] != SHARD_AXIS


def sharding_for_named_axes(
    axis_names: tuple[str, ...],
    shape: tuple[int, ...],
    primary: str | None,
    mesh: Mesh | None = None,
) -> NamedSharding | None:
    """PartitionSpec for a dataset with labelled axes.

    Two placement regimes:

    * 1-D default mesh (axis ``"shard"``): the dataset's ``primary``
      (its ``distributed_axis``) is split over the single mesh axis —
      the reference's one-distributed-axis MPIArray layout.
    * named mesh (e.g. ``("freq", "m")`` from :func:`make_mesh2d`):
      every dataset axis whose *name* matches a mesh axis is split over
      that mesh axis, giving the 2-D production layout regardless of
      which axis is nominally "distributed".

    Axes that do not divide their mesh-axis size stay replicated.
    Returns None when no mesh is installed.
    """
    if mesh is None:
        mesh = get_mesh()
    if mesh is None:
        return None

    spec = [None] * len(axis_names)
    if _is_named_mesh(mesh):
        for i, (name, n) in enumerate(zip(axis_names, shape)):
            if name in mesh.shape and n % mesh.shape[name] == 0:
                spec[i] = name
    elif primary is not None and primary in axis_names:
        i = axis_names.index(primary)
        if shape[i] % mesh.shape[_mesh_axis(mesh)] == 0:
            spec[i] = _mesh_axis(mesh)
    return NamedSharding(mesh, PartitionSpec(*spec))


def shard_array_named(arr, axis_names, primary: str | None):
    """Reshard ``arr`` by axis *names* (see sharding_for_named_axes)."""
    mesh = get_mesh()
    if mesh is None:
        return arr
    sharding = sharding_for_named_axes(
        tuple(axis_names), tuple(arr.shape), primary, mesh
    )
    return _put(arr, sharding)


def unshard(arr):
    """Gather a (possibly sharded) array to a replicated array."""
    mesh = get_mesh()
    if mesh is None:
        return arr
    return _put(arr, sharding_for_axis(np.ndim(arr), None, mesh))
