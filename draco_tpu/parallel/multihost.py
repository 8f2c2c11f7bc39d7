"""Multi-host (multi-process) scale-out scaffolding.

The reference framework scales across nodes with mpi4py: every rank runs
the same pipeline, arrays are distributed per rank, and HDF5 I/O is
collective (SURVEY.md section 2.5).  The JAX equivalents here:

* :func:`initialize` — one call wrapping ``jax.distributed.initialize``
  so every process sees the global device set.  Configuration comes from arguments or the
  ``DRACO_TPU_COORDINATOR`` / ``DRACO_TPU_NUM_PROCESSES`` /
  ``DRACO_TPU_PROCESS_ID`` environment (which play the role of the MPI
  launcher's rank/size environment).
* :func:`split_local` — the ``caput.mpitools.split_local`` equivalent:
  this process's (offset, count) slab of an axis.
* :func:`broadcast_from_leader` — host-0 load + broadcast (the
  reference's ``comm.bcast`` catalog pattern).
* :func:`save_sharded` / :func:`load_sharded` — per-process HDF5 part
  files: each process writes only its slab of every distributed dataset
  (the reference's parallel-HDF5 role), and any process can reassemble
  the full container from the part set.

A two-process CPU smoke test lives in ``tests/test_multihost.py``.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> bool:
    """Join the global JAX process group; returns True if distributed.

    No-op (returns False) when neither arguments nor the
    ``DRACO_TPU_*`` environment configure more than one process — the
    framework then runs single-process exactly as before.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "DRACO_TPU_COORDINATOR"
    )
    if num_processes is None and "DRACO_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DRACO_TPU_NUM_PROCESSES"])
    if process_id is None and "DRACO_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DRACO_TPU_PROCESS_ID"])

    if not coordinator_address or not num_processes or num_processes <= 1:
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return True


def process_index() -> int:
    import jax

    return jax.process_index()


def process_count() -> int:
    import jax

    return jax.process_count()


def split_local(n: int, rank: int | None = None, size: int | None = None):
    """(count, offset) of this process's slab of an ``n``-long axis.

    The first ``n % size`` processes carry one extra element — the
    balanced split of the reference's ``mpitools.split_local``.
    """
    if rank is None:
        rank = process_index()
    if size is None:
        size = process_count()
    base, extra = divmod(n, size)
    count = base + (1 if rank < extra else 0)
    offset = rank * base + min(rank, extra)
    return count, offset


def broadcast_from_leader(value):
    """Share a host value loaded by process 0 with every process.

    Single-process: returns the value unchanged.  Distributed: the value
    is pickled and broadcast as bytes, so arbitrary host objects work
    and non-leader processes may pass ``None`` (the reference
    ``comm.bcast`` catalog pattern) — a raw
    ``multihost_utils.broadcast_one_to_all`` would require every
    process to supply a structurally identical array pytree.
    """
    if process_count() == 1:
        return value
    import pickle

    from jax.experimental import multihost_utils

    leader = process_index() == 0
    payload = pickle.dumps(value) if leader else b""
    # phase 1: agree on the byte length (identical structure everywhere)
    n = multihost_utils.broadcast_one_to_all(
        np.array([len(payload)], dtype=np.int64)
    )
    n = int(np.asarray(n)[0])
    # phase 2: the padded byte buffer
    buf = np.zeros(n, dtype=np.uint8)
    if leader:
        buf[:] = np.frombuffer(payload, dtype=np.uint8)
    buf = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return pickle.loads(buf.tobytes())


def is_leader() -> bool:
    """True on process 0 (and in any single-process run).

    Rank-gates side effects like task save outputs: in a multi-process
    launch every process executes every task, so an ungated
    ``output.save(fname)`` would have N ranks writing one HDF5 file
    concurrently.
    """
    try:
        return process_index() == 0
    except Exception:
        return True


# ---------------------------------------------------------------------------
# Per-process sharded container I/O
# ---------------------------------------------------------------------------


def _part_path(path: str, rank: int, size: int) -> str:
    stem, ext = os.path.splitext(path)
    return f"{stem}.part{rank:04d}of{size:04d}{ext or '.h5'}"


def save_sharded(
    container,
    path: str,
    rank: int | None = None,
    size: int | None = None,
) -> str:
    """Write this process's slab of ``container`` as an HDF5 part file.

    Every dataset with a ``distributed_axis`` is sliced to the process's
    :func:`split_local` slab along that axis; non-distributed datasets,
    index maps and attrs are written in full by every part (they are
    small and make each part self-describing).  Returns the part path.
    """
    import h5py

    from ..core.containers import _h5_safe

    if rank is None:
        rank = process_index()
    if size is None:
        size = process_count()

    ppath = _part_path(path, rank, size)
    with h5py.File(ppath, "w") as f:
        f.attrs["__draco_tpu_container__"] = type(container).__name__
        f.attrs["__shard_rank__"] = rank
        f.attrs["__shard_size__"] = size
        for k, v in container.attrs.items():
            try:
                f.attrs[k] = v
            except TypeError:
                import json

                f.attrs[k] = json.dumps(v)
        im = f.create_group("index_map")
        for name, arr in container.index_map.items():
            im.create_dataset(name, data=_h5_safe(np.asarray(arr)))
        if container.reverse_map:
            rm = f.create_group("reverse_map")
            for name, arr in container.reverse_map.items():
                rm.create_dataset(name, data=_h5_safe(np.asarray(arr)))

        if getattr(container, "history", None):
            hg = f.create_group("history")
            import json as _json

            for k, v in container.history.items():
                try:
                    hg.attrs[k] = v
                except TypeError:
                    hg.attrs[k] = _json.dumps(v)

        for name, ds in container.datasets.items():
            from ..ops.tools import device_to_numpy

            axis = ds.distributed_axis if ds.distributed else None
            ai = ds.axes.index(axis) if axis in ds.axes else None
            slab = _local_slab(ds._data, ai) if ai is not None else None
            if slab is not None:
                # process-spanning global array: write the ADDRESSABLE
                # slab directly — no full-array gather, so host memory
                # stays O(local) like the reference's per-rank MPIArray
                # writes
                arr, offset = slab
                dset = f.create_dataset(name, data=_h5_safe(arr))
                dset.attrs["__shard_axis__"] = axis
                dset.attrs["__shard_offset__"] = offset
            else:
                # a non-addressable array that was not sliceable above
                # gathers collectively here — all processes run this
                arr = device_to_numpy(ds[:])
                if ai is not None:
                    count, offset = split_local(arr.shape[ai], rank, size)
                    sl = [slice(None)] * arr.ndim
                    sl[ai] = slice(offset, offset + count)
                    arr = arr[tuple(sl)]
                    dset = f.create_dataset(name, data=_h5_safe(arr))
                    dset.attrs["__shard_axis__"] = axis
                    dset.attrs["__shard_offset__"] = offset
                else:
                    dset = f.create_dataset(name, data=_h5_safe(arr))
            dset.attrs["axis"] = np.array([a.encode() for a in ds.axes])
    return ppath


def _local_slab(data, ai: int):
    """(host slab, offset) of this process's shards along axis ``ai``.

    Returns None unless ``data`` is a process-spanning global jax.Array
    whose addressable shards form one contiguous block along ``ai`` and
    cover the full extent of every other axis — the layout every 1-axis
    container sharding produces.
    """
    import jax

    from ..ops.tools import device_to_numpy

    if not isinstance(data, jax.Array) or data.is_fully_addressable:
        return None
    try:
        shards = data.addressable_shards
        pieces = []
        for sh in shards:
            idx = sh.index
            for d, sl in enumerate(idx):
                if d == ai:
                    continue
                if not (sl.start is None and sl.stop is None):
                    return None  # sharded on another axis too
            sl = idx[ai]
            start = 0 if sl.start is None else int(sl.start)
            pieces.append((start, sh.data))
        pieces.sort(key=lambda t: t[0])
        offset = pieces[0][0]
        pos = offset
        arrs = []
        for start, d in pieces:
            if start != pos:
                return None  # discontiguous local block
            a = device_to_numpy(d)
            arrs.append(a)
            pos += a.shape[ai]
        slab = np.concatenate(arrs, axis=ai)
        # the process slabs must partition the axis exactly (a dataset
        # replicated across some processes would otherwise write
        # duplicate blocks that the loader concatenates twice)
        if slab.shape[ai] * process_count() != data.shape[ai]:
            return None
        return slab, offset
    except Exception:
        return None


def load_sharded(path: str):
    """Reassemble a container from the full set of part files.

    Any process may call this; it reads every ``.partNNNNofMMMM`` file
    matching ``path`` and concatenates sharded datasets along their
    recorded axes.
    """
    import h5py

    from ..core.containers import ContainerBase

    stem, ext = os.path.splitext(path)
    parts_all = sorted(glob.glob(f"{glob.escape(stem)}.part*of*{ext or '.h5'}"))
    if not parts_all:
        raise FileNotFoundError(f"no shard parts found for {path!r}")
    # group by declared shard count and pick a COMPLETE set (stale parts
    # from a previous run with a different process count are ignored;
    # the largest complete set wins)
    by_size: dict = {}
    for p in parts_all:
        m = re.search(r"part(\d+)of(\d+)", p)
        if m:
            by_size.setdefault(int(m.group(2)), []).append(p)
    complete = {n: ps for n, ps in by_size.items() if len(ps) == n}
    if not complete:
        counts = {n: len(ps) for n, ps in by_size.items()}
        raise FileNotFoundError(
            f"incomplete shard set for {path!r}: present counts {counts}"
        )
    size = max(complete)
    parts = sorted(complete[size])

    # every part is self-describing except for the sharded dataset slabs:
    # load the first part via the standard reader, then stitch the slabs
    cont = ContainerBase.from_file(parts[0])
    with h5py.File(parts[0], "r") as f:
        shard_axis = {}
        for name, d in f.items():
            if name in ("index_map", "reverse_map", "history"):
                continue
            if "__shard_axis__" in d.attrs:
                val = d.attrs["__shard_axis__"]
                shard_axis[name] = (
                    val.decode() if isinstance(val, bytes) else str(val)
                )

    for name, axis in shard_axis.items():
        ds = cont.datasets[name]
        ai = ds.axes.index(axis)
        pieces = []
        for p in parts:
            with h5py.File(p, "r") as f:
                pieces.append(
                    (int(f[name].attrs["__shard_offset__"]), f[name][:])
                )
        pieces.sort(key=lambda t: t[0])
        full = np.concatenate([a for _, a in pieces], axis=ai)
        ds._data = full
    return cont
