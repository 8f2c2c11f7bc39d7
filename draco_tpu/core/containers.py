"""Typed, axis-labelled, mesh-shardable data containers.

Native re-design of the reference's distributed container system
(reference ``draco/core/containers.py`` — 74 container classes on top of
``caput.containers.ContainerPrototype``).  The structure is preserved —
every container declares named axes and a ``_dataset_spec`` describing per
dataset axes/dtype/distribution — but the storage is a global array
(``jax.Array`` or ``numpy.ndarray``) and ``distributed_axis`` maps onto a
``jax.sharding`` mesh axis rather than an MPI communicator rank split.

``redistribute(axis)`` is a resharding ``device_put`` (an all-to-all
between devices under XLA) instead of an MPI all-to-all (see SURVEY.md
section 2.5).

HDF5 round-trips (``save``/``from_file``) keep layout compatibility with the
reference: datasets at the root with an ``axis`` attribute, ``index_map/``
and ``reverse_map/`` groups, and pipeline provenance in ``history``.
"""

from __future__ import annotations

import json
import logging
from typing import Any, ClassVar

import numpy as np

from ..parallel import mesh as pmesh

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)

# Storage compression defaults, mirroring the reference container chunk
# specs (reference draco/core/containers.py:500-513).
COMPRESSION = "gzip"
COMPRESSION_OPTS = 4

_UNSET = object()


def _is_jax(arr) -> bool:
    return isinstance(arr, jax.Array)


def _to_numpy(arr) -> np.ndarray:
    """Host copy of ``arr``.

    jax arrays go through :func:`~draco_tpu.ops.tools.device_to_numpy`,
    which also gathers arrays spanning several processes.
    """
    if _is_jax(arr):
        from ..ops.tools import device_to_numpy

        return device_to_numpy(arr)
    return np.asarray(arr)


class Dataset:
    """A named array with labelled axes and attributes.

    The array may be a numpy array (host data: index-like, small) or a
    ``jax.Array`` (device data: the compute path).  Assignment through
    ``ds[sel] = value`` is supported for both (functional ``.at[].set``
    under the hood for jax arrays).
    """

    def __init__(
        self,
        name: str,
        data,
        axes: tuple[str, ...],
        attrs: dict | None = None,
        distributed: bool = False,
        distributed_axis: str | None = None,
        spec: dict | None = None,
    ):
        self.name = name
        self._data = data
        self.attrs = dict(attrs or {})
        self.attrs.setdefault("axis", tuple(axes))
        self.distributed = distributed
        self.distributed_axis = distributed_axis
        self.spec = dict(spec or {})

    # -- array access -----------------------------------------------------
    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        if tuple(np.shape(value)) != tuple(self._data.shape):
            raise ValueError(
                f"Dataset {self.name!r}: shape {np.shape(value)} != "
                f"{self._data.shape}"
            )
        self._data = value

    @property
    def axes(self) -> tuple[str, ...]:
        return tuple(self.attrs["axis"])

    @property
    def shape(self):
        return self._data.shape

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    # Reference-compat alias: the global array (no per-rank locality here).
    @property
    def local_array(self):
        return self._data

    def __getitem__(self, sel):
        if sel is Ellipsis or (isinstance(sel, slice) and sel == slice(None)):
            return self._data
        return self._data[sel]

    def __setitem__(self, sel, value):
        full = sel is Ellipsis or (isinstance(sel, slice) and sel == slice(None))
        if _is_jax(self._data):
            if np.iscomplexobj(value) and not _is_jax(value):
                from ..ops.tools import numpy_to_device

                value = numpy_to_device(value).astype(self._data.dtype)
            else:
                value = jnp.asarray(value, dtype=self._data.dtype)
            if full and value.shape == self._data.shape:
                self._data = value
            elif full:
                self._data = jnp.broadcast_to(value, self._data.shape)
            else:
                self._data = self._data.at[sel].set(value)
        else:
            self._data[sel] = _to_numpy(value) if _is_jax(value) else value

    def __array__(self, dtype=None):
        from ..ops.tools import device_to_numpy

        arr = device_to_numpy(self._data)
        return arr.astype(dtype) if dtype is not None else arr

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return (
            f"<Dataset {self.name!r} axes={self.axes} shape={self.shape} "
            f"dtype={self.dtype}>"
        )

    def _as_device(self):
        """Device view of the data (see ops.tools.as_device)."""
        from ..ops.tools import as_device

        return as_device(self._data)

    # -- device/sharding ----------------------------------------------------
    def to_device(self) -> "Dataset":
        """Move the array onto device (respecting its distributed axis).

        Under a named multi-axis mesh (``parallel.make_mesh2d``) every
        dataset axis matching a mesh-axis name is sharded — the 2-D
        (freq x m) production layout; under the default 1-D mesh only
        the ``distributed_axis`` is split.
        """
        primary = self.distributed_axis if self.distributed else None
        self._data = pmesh.shard_array_named(
            self._as_device(), self.axes, primary
        )
        return self

    def redistribute(self, axis_name: str | None) -> "Dataset":
        """Reshard with ``axis_name`` as the distributed axis.

        On a 1-D mesh this moves the single split axis (the reference's
        MPI parallel transpose); on a named multi-axis mesh name-matched
        placement already pins each axis, so this only updates which
        axis is nominally "distributed".
        """
        if not self.distributed:
            return self
        if axis_name is not None and axis_name not in self.axes:
            return self
        if pmesh.get_mesh() is None:
            # metadata-only: with no mesh there is nothing to reshard,
            # and forcing a host->device transfer here would change
            # numpy in-place semantics for host-only flows as a side
            # effect of a documented no-op
            self.distributed_axis = axis_name
            return self
        self._data = pmesh.shard_array_named(
            self._as_device(), self.axes, axis_name
        )
        self.distributed_axis = axis_name
        return self


def dataset_property(name: str, doc: str = ""):
    """Class property returning the named dataset."""

    def fget(self):
        return self.datasets[name]

    return property(fget, doc=doc or f"The {name!r} dataset.")


def make_freq_map(freq) -> np.ndarray:
    """Build a structured frequency index map (centre/width in MHz)."""
    freq = np.asarray(freq)
    if freq.dtype.names and "centre" in freq.dtype.names:
        return freq
    freq = np.atleast_1d(freq)
    out = np.zeros(len(freq), dtype=[("centre", np.float64), ("width", np.float64)])
    out["centre"] = freq
    out["width"] = np.abs(np.median(np.diff(freq))) if len(freq) > 1 else 1.0
    return out


def make_prod_map(prod) -> np.ndarray:
    prod = np.asarray(prod)
    if prod.dtype.names:
        return prod
    out = np.zeros(len(prod), dtype=[("input_a", np.int64), ("input_b", np.int64)])
    out["input_a"] = prod[:, 0]
    out["input_b"] = prod[:, 1]
    return out


def default_stack_maps(nprod: int):
    """Identity stack index/reverse maps (each product its own stack)."""
    fwd = np.zeros(nprod, dtype=[("prod", "<u4"), ("conjugate", "u1")])
    fwd["prod"] = np.arange(nprod)
    rev = np.zeros(nprod, dtype=[("stack", "<u4"), ("conjugate", "u1")])
    rev["stack"] = np.arange(nprod)
    return fwd, rev


class ContainerBase:
    """Base for all typed containers.

    Subclasses declare ``_axes`` (named axes) and ``_dataset_spec``
    (datasets over those axes).  Constructor keyword args give axis
    definitions (array, or int for a default integer/uniform axis);
    ``axes_from=`` copies missing axes from another container and
    ``attrs_from=`` copies attributes (matching the reference container
    construction protocol, reference test/test_containers.py:25-39).
    """

    _axes: ClassVar[tuple[str, ...]] = ()
    _dataset_spec: ClassVar[dict[str, dict]] = {}

    def __init__(
        self,
        *,
        axes_from: "ContainerBase | None" = None,
        attrs_from: "ContainerBase | None" = None,
        skip_datasets: bool = False,
        distributed: bool = True,
        comm: Any = None,  # accepted for API parity; unused (no MPI)
        **kwargs,
    ):
        self.index_map: dict[str, np.ndarray] = {}
        self.reverse_map: dict[str, np.ndarray] = {}
        self.attrs: dict[str, Any] = {}
        self.datasets: dict[str, Dataset] = {}
        self.distributed = distributed
        self.comm = comm
        self.history: dict[str, Any] = {}

        # Stage 1: axes from explicit kwargs, falling back to axes_from.
        overridden: set[str] = set()
        for ax in self.axes_spec():
            if ax in kwargs:
                overridden.add(ax)
                val = kwargs.pop(ax)
                if val is not None and val is not _UNSET:
                    self.create_index_map(ax, self._convert_axis(ax, val))
                elif val is None:
                    # explicit None: suppress inheritance, let subclass derive
                    kwargs[ax] = None
                    continue
            elif axes_from is not None and ax in axes_from.index_map:
                self.create_index_map(ax, axes_from.index_map[ax])
        self._extra_kwargs = kwargs

        if axes_from is not None:
            for name, rmap in axes_from.reverse_map.items():
                # only for axes INHERITED from axes_from: a reverse_map
                # indexes into its own axis, so copying it onto an axis
                # the caller replaced (e.g. empty_like(x, stack=...))
                # would leave a stale, out-of-range mapping
                if name in self.index_map and name not in overridden:
                    self.reverse_map[name] = np.asarray(rmap).copy()

        # Stage 2: subclass hook for derived axes (stack from prod, ...).
        self._finalise_axes(axes_from)

        # Stage 3: attributes.
        if attrs_from is not None:
            for k, v in attrs_from.attrs.items():
                self.attrs.setdefault(k, v)
            self.history.update(getattr(attrs_from, "history", {}))

        # Stage 4: datasets.
        if not skip_datasets:
            for name, spec in self.dataset_spec().items():
                if spec.get("initialise", False):
                    self.add_dataset(name)

        # Anything left in _extra_kwargs that no stage (or subclass
        # _finalise_axes hook) consumed is a typo'd axis/argument —
        # swallowing it silently would let e.g. empty_like(c, stakc=...)
        # inherit the old axis without any error.  Explicit-None axis
        # suppressions from stage 1 are expected leftovers.
        axes_known = set(self.axes_spec())
        unknown = [
            k
            for k, v in self._extra_kwargs.items()
            if not (k in axes_known and v is None)
        ]
        if unknown:
            raise TypeError(
                f"{type(self).__name__}: unknown constructor argument(s) "
                f"{sorted(unknown)}; valid axes: {sorted(axes_known)}"
            )

    # -- subclass hooks -----------------------------------------------------
    def _finalise_axes(self, axes_from: "ContainerBase | None") -> None:
        """Derive axes that depend on other axes; override in subclasses."""

    # -- class-level spec assembly -------------------------------------------
    @classmethod
    def axes_spec(cls) -> tuple[str, ...]:
        axes: list[str] = []
        for klass in reversed(cls.__mro__):
            for ax in vars(klass).get("_axes", ()):
                if ax not in axes:
                    axes.append(ax)
        return tuple(axes)

    @classmethod
    def dataset_spec(cls) -> dict[str, dict]:
        spec: dict[str, dict] = {}
        for klass in reversed(cls.__mro__):
            for name, ds in vars(klass).get("_dataset_spec", {}).items():
                spec[name] = ds
        return spec

    # -- axis handling --------------------------------------------------------
    def _convert_axis(self, name: str, value):
        """Convert an axis constructor argument into an index map array."""
        if isinstance(value, ContainerBase):
            return value.index_map[name]
        if np.isscalar(value) and np.issubdtype(type(value), np.integer):
            n = int(value)
            if name == "ra":
                return np.linspace(0.0, 360.0, n, endpoint=False)
            return np.arange(n)
        value = np.asarray(value)
        if name == "freq":
            return make_freq_map(value)
        if name == "prod":
            return make_prod_map(value)
        return value

    def create_index_map(self, name: str, imap) -> None:
        self.index_map[name] = np.asarray(imap)

    def create_reverse_map(self, name: str, rmap) -> None:
        self.reverse_map[name] = np.asarray(rmap)

    # -- datasets ----------------------------------------------------------
    def add_dataset(self, name: str, data=None) -> Dataset:
        spec = self.dataset_spec()[name]
        axes = tuple(spec["axes"])
        missing = [ax for ax in axes if ax not in self.index_map]
        if missing:
            raise ValueError(
                f"Cannot create dataset {name!r}: axes {missing} undefined on "
                f"{type(self).__name__} (define via constructor or axes_from)"
            )
        shape = tuple(len(self.index_map[ax]) for ax in axes)
        dtype = spec.get("dtype", np.float64)
        if data is None:
            data = np.zeros(shape, dtype=dtype)
        elif not _is_jax(data):
            data = np.asarray(data)
        if tuple(data.shape) != shape:
            raise ValueError(
                f"Dataset {name!r}: supplied shape {data.shape} != "
                f"axis shape {shape}"
            )
        ds = Dataset(
            name,
            data,
            axes,
            distributed=spec.get("distributed", False) and self.distributed,
            distributed_axis=spec.get("distributed_axis"),
            spec=spec,
        )
        self.datasets[name] = ds
        return ds

    def __getitem__(self, name: str) -> Dataset:
        return self.datasets[name]

    def __contains__(self, name: str) -> bool:
        return name in self.datasets

    def __delitem__(self, name: str) -> None:
        del self.datasets[name]

    # -- distribution -----------------------------------------------------
    def redistribute(self, axis_name: str | None) -> "ContainerBase":
        """Reshard every distributed dataset along ``axis_name``.

        Mirrors ``MPIArray.redistribute``: datasets not carrying the axis
        are left unchanged (reference draco/analysis/transform.py:592).
        """
        for ds in self.datasets.values():
            ds.redistribute(axis_name)
        return self

    def to_device(self) -> "ContainerBase":
        for ds in self.datasets.values():
            ds.to_device()
        return self

    # -- copying ------------------------------------------------------------
    def copy(self, shared: tuple[str, ...] = ()) -> "ContainerBase":
        """Deep copy; datasets named in ``shared`` share storage."""
        new = self.__class__.__new__(self.__class__)
        new.index_map = {k: np.asarray(v).copy() for k, v in self.index_map.items()}
        new.reverse_map = {k: np.asarray(v).copy() for k, v in self.reverse_map.items()}
        new.attrs = dict(self.attrs)
        new.history = dict(self.history)
        new.distributed = self.distributed
        new.comm = self.comm
        new._extra_kwargs = {}
        new.datasets = {}
        for name, ds in self.datasets.items():
            if name in shared or _is_jax(ds._data):
                data = ds._data  # jax arrays are immutable: safe to share
            else:
                data = ds._data.copy()
            new.datasets[name] = Dataset(
                name,
                data,
                ds.axes,
                attrs=dict(ds.attrs),
                distributed=ds.distributed,
                distributed_axis=ds.distributed_axis,
                spec=ds.spec,
            )
        return new

    def ensure_host(self) -> "ContainerBase":
        """Replace every device-resident dataset with its host copy.

        On a multi-process mesh, gathering a process-spanning global
        ``jax.Array`` is a compiled collective — EVERY process must call
        this (in the same dataset order, which dict order guarantees)
        before any process does host-side work like a leader-only file
        write.  Single-process: a plain device->host fetch.
        """
        for ds in self.datasets.values():
            if _is_jax(ds._data):
                ds._data = _to_numpy(ds._data)
        return self

    # -- IO ------------------------------------------------------------------
    def save(self, path: str, mode: str = "w", truncate: bool = False) -> None:
        """Write to HDF5 (layout mirrors the reference on-disk format).

        With ``truncate=True``, datasets whose spec carries a
        ``truncate`` entry (mirroring reference containers.py:510-523)
        have sub-noise mantissa bits rounded away before compression
        (see :mod:`draco_tpu.core.truncate`). Off by default: unlike
        the reference, saving is lossless unless explicitly requested.
        """
        import h5py

        from . import truncate as _trunc

        with h5py.File(path, mode) as f:
            f.attrs["__draco_tpu_container__"] = type(self).__name__
            _write_attrs(f.attrs, self.attrs)
            im = f.create_group("index_map")
            for name, arr in self.index_map.items():
                im.create_dataset(name, data=_h5_safe(arr))
            if self.reverse_map:
                rm = f.create_group("reverse_map")
                for name, arr in self.reverse_map.items():
                    d = rm.create_dataset(name, data=_h5_safe(arr))
                    # Record which axis indexes the rows, so a later
                    # partial read can check staleness EXACTLY instead
                    # of by the row-count-coincidence heuristic (absent
                    # in foreign files, where the heuristic remains).
                    arr_np = np.asarray(arr)
                    nrow = arr_np.shape[0] if arr_np.ndim else 0
                    src = [
                        ax
                        for ax, im in self.index_map.items()
                        if np.asarray(im).ndim
                        and np.asarray(im).shape[0] == nrow
                        and ax != name
                    ]
                    if len(src) == 1:
                        d.attrs["__source_axis__"] = src[0]
            for name, ds in self.datasets.items():
                arr = _h5_safe(_to_numpy(ds._data))
                tspec = ds.spec.get("truncate") if truncate else None
                if tspec:
                    wname = (
                        tspec.get("weight_dataset")
                        if isinstance(tspec, dict)
                        else None
                    )
                    wds = self.datasets.get(wname) if wname else None
                    weight = _to_numpy(wds._data) if wds is not None else None
                    arr = _trunc.truncate_dataset(arr, tspec, weight)
                kwargs = {}
                chunks = ds.spec.get("chunks")
                if chunks is not None and arr.size:
                    chunks = tuple(
                        max(1, min(c, s)) for c, s in zip(chunks, arr.shape)
                    )
                    kwargs = {
                        "chunks": chunks,
                        "compression": ds.spec.get("compression", COMPRESSION),
                        "compression_opts": ds.spec.get(
                            "compression_opts", COMPRESSION_OPTS
                        ),
                    }
                d = f.create_dataset(name, data=arr, **kwargs)
                d.attrs["axis"] = np.array([a.encode() for a in ds.axes])
                _write_attrs(
                    d.attrs,
                    {k: v for k, v in ds.attrs.items() if k != "axis"},
                )
            hist = f.create_group("history")
            _write_attrs(
                hist.attrs,
                {
                    k: (v if isinstance(v, str) else _ForceJSON(v))
                    for k, v in self.history.items()
                },
            )

    @classmethod
    def from_file(
        cls,
        path: str,
        *,
        distributed: bool = True,
        comm=None,
        sel: dict | None = None,
        **kwargs,
    ):
        """Read a container back from HDF5.

        ``sel`` optionally maps axis name -> slice/index-array for partial
        reads (the reference's fsel/isel/tsel selections, reference
        test/test_selections.py:33-60).
        """
        import h5py

        if kwargs:
            # silent-typo guard matching constructor strictness: a
            # misspelled sel=/distributed= must not be dropped
            raise TypeError(
                f"{cls.__name__}.from_file() got unexpected keyword "
                f"argument(s): {sorted(kwargs)}"
            )
        sel = dict(sel or {})
        with h5py.File(path, "r") as f:
            clsname = f.attrs.get("__draco_tpu_container__")
            klass = cls
            if clsname and (cls is ContainerBase or str(clsname) != cls.__name__):
                klass = _container_registry().get(str(clsname), cls)
            self = klass.__new__(klass)
            self.index_map = {}
            self.reverse_map = {}
            self.attrs = {}
            self.datasets = {}
            self.history = {}
            self.distributed = distributed
            self.comm = comm
            self._extra_kwargs = {}
            def _decode_attrs(h5attrs, target):
                for k, v in h5attrs.items():
                    k = str(k)
                    if k.startswith("__"):
                        continue
                    if k.endswith("!json"):
                        # our writer's tag for non-native attrs; a
                        # foreign file may coincidentally name an attr
                        # '*!json' with a non-JSON payload — keep it
                        # verbatim rather than raising mid-load
                        try:
                            target[k[: -len("!json")]] = json.loads(v)
                        except (TypeError, ValueError):
                            target[k] = v
                    else:
                        target[k] = v

            _decode_attrs(f.attrs, self.attrs)
            orig_len = {}
            for name, d in f["index_map"].items():
                arr = d[:]
                orig_len[name] = arr.shape[0] if arr.ndim else 0
                if name in sel:
                    arr = arr[sel[name]]
                # forward maps may index INTO another axis via a
                # structured field of that axis's name (e.g. the stack
                # index_map's 'prod' indices); a selection on the
                # referenced axis leaves those indices stale.  The map
                # defines its own axis so it cannot be dropped — warn.
                if arr.dtype.names:
                    stale = [fn for fn in arr.dtype.names if fn in sel]
                    if stale:
                        logger.warning(
                            "%s: index_map[%r] field(s) %s index into "
                            "selected axes; those indices refer to the "
                            "UNSELECTED axis ordering",
                            path,
                            name,
                            stale,
                        )
                self.index_map[name] = arr
            selected_lens = {orig_len.get(ax) for ax in sel}
            if "reverse_map" in f:
                for name, d in f["reverse_map"].items():
                    arr = d[:]
                    # a reverse map indexes INTO its target axis (so a
                    # selection on `name` makes its values stale) and is
                    # indexed BY a source axis (so a selection on that
                    # axis makes its row order stale).  Files we wrote
                    # record the source axis exactly; foreign files fall
                    # back to the row-count-coincidence heuristic (which
                    # can also drop a still-valid map when an unrelated
                    # selected axis merely matches in length).
                    src_axis = d.attrs.get("__source_axis__")
                    if isinstance(src_axis, bytes):
                        src_axis = src_axis.decode()
                    if src_axis is not None:
                        stale = name in sel or src_axis in sel
                    else:
                        stale = name in sel or (
                            sel and arr.shape[0] in selected_lens
                        )
                    if stale:
                        logger.warning(
                            "%s: dropping reverse_map[%r] invalidated "
                            "by the axis selection",
                            path,
                            name,
                        )
                        continue
                    self.reverse_map[name] = arr
            spec = klass.dataset_spec()
            for name, d in f.items():
                if name in ("index_map", "reverse_map", "history"):
                    continue
                # axis labels may be bytes (our writer) or vlen unicode
                # (reference/caput-written files)
                axes = tuple(
                    a.decode() if isinstance(a, bytes) else str(a)
                    for a in d.attrs["axis"]
                )
                arr = d[:]
                for i, ax in enumerate(axes):
                    if ax in sel:
                        arr = np.take(arr, _sel_to_indices(sel[ax], arr.shape[i]), axis=i)
                dspec = spec.get(name, {})
                ds_attrs: dict[str, Any] = {}
                _decode_attrs(d.attrs, ds_attrs)
                ds_attrs["axis"] = axes
                self.datasets[name] = Dataset(
                    name,
                    arr,
                    axes,
                    attrs=ds_attrs,
                    distributed=dspec.get("distributed", False) and distributed,
                    distributed_axis=dspec.get("distributed_axis"),
                    spec=dspec,
                )
            if "history" in f:
                _decode_attrs(f["history"].attrs, self.history)
        return self

    def __repr__(self):
        dss = ", ".join(f"{n}{list(d.shape)}" for n, d in self.datasets.items())
        return f"<{type(self).__name__} {dss}>"


class _ForceJSON:
    """Marker: always JSON-encode this attr value (used for history)."""

    def __init__(self, value):
        self.value = value


def _write_attrs(h5attrs, attrs: dict) -> None:
    """Write attrs to an HDF5 attribute set, JSON-tagging as needed.

    Attrs h5py cannot store natively (dicts, lists of mixed type, ...)
    are JSON encoded under ``<name>!json`` so :meth:`from_file` can
    decode them back symmetrically.  Collisions between a tagged key
    and a literal attr named ``<name>!json`` would silently shadow one
    another on read, so they are rejected here; so is a plain attr
    whose own name carries the tag suffix while a sibling would encode
    to the same key.
    """
    for k in attrs:
        if k.endswith("!json") and k[: -len("!json")] in attrs:
            raise ValueError(
                f"attribute name collision: {k!r} shadows the JSON-"
                f"tagged encoding of {k[:-len('!json')]!r}"
            )
    for k, v in attrs.items():
        if isinstance(v, _ForceJSON):
            h5attrs[k + "!json"] = json.dumps(v.value)
            continue
        try:
            h5attrs[k] = v
        except TypeError:
            h5attrs[k + "!json"] = json.dumps(v)


def _h5_safe(arr: np.ndarray) -> np.ndarray:
    """Convert unicode string dtypes to bytes for HDF5 storage."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "U":
        return arr.astype(f"S{arr.dtype.itemsize // 4 or 1}")
    if arr.dtype.names:
        new_dtype = []
        needs_convert = False
        for name in arr.dtype.names:
            dt = arr.dtype[name]
            if dt.kind == "U":
                new_dtype.append((name, f"S{dt.itemsize // 4 or 1}"))
                needs_convert = True
            else:
                new_dtype.append((name, dt))
        if needs_convert:
            out = np.zeros(arr.shape, dtype=new_dtype)
            for name in arr.dtype.names:
                out[name] = arr[name]
            return out
    return arr


def _sel_to_indices(s, n):
    if isinstance(s, slice):
        return np.arange(n)[s]
    return np.asarray(s)


def _container_registry() -> dict[str, type]:
    # Make sure the full class zoo is imported before resolving names.
    from ..core import containers_spec  # noqa: F401

    reg = {}
    stack = [ContainerBase]
    while stack:
        klass = stack.pop()
        reg[klass.__name__] = klass
        stack.extend(klass.__subclasses__())
    return reg


def empty_like(cont: ContainerBase, **kwargs) -> ContainerBase:
    """New zeroed container with the same axes/attrs as ``cont``."""
    return cont.__class__(axes_from=cont, attrs_from=cont, **kwargs)


def concatenate_tod(containers_list):
    """Concatenate containers along their time-like axis.

    Equivalent of ``caput.containers.tod.concatenate`` (used by the
    reference SiderealGrouper, draco/analysis/sidereal.py:148).
    """
    first = containers_list[0]
    if len(containers_list) == 1:
        return first.copy()
    taxis = "time" if "time" in first.index_map else "ra"
    new_time = np.concatenate([np.asarray(c.index_map[taxis]) for c in containers_list])
    new = first.__class__(
        axes_from=first, attrs_from=first, **{taxis: new_time}
    )
    for name, ds in first.datasets.items():
        if taxis in ds.axes:
            ax = list(ds.axes).index(taxis)
            arr = np.concatenate(
                [_to_numpy(c.datasets[name][:]) for c in containers_list],
                axis=ax,
            )
        else:
            arr = _to_numpy(ds[:])
        if name not in new.datasets:
            new.add_dataset(name)
        new.datasets[name][:] = arr
        # carry per-dataset metadata (units, calibration tags, ...)
        new.datasets[name].attrs.update(
            {k: v for k, v in ds.attrs.items() if k != "axis"}
        )
    return new


def copy_datasets_filter(
    source: ContainerBase,
    dest: ContainerBase,
    axis: str | tuple[str, ...] = (),
    selection: dict | None = None,
    exclude_axes: tuple[str, ...] | None = None,
) -> None:
    """Copy datasets from source to dest applying per-axis selections.

    Mirrors the reference helper used to down-select containers
    (reference test/test_containers.py:87-142): ``axis`` names the
    filtered axes; a non-dict ``selection`` applies to the single named
    axis, and a dict selection's keys must match ``axis`` when given.
    """
    axis = (axis,) if isinstance(axis, str) else tuple(axis)
    if selection is None:
        selection = {}
    if not isinstance(selection, dict):
        if len(axis) != 1:
            raise ValueError(
                "a non-dict selection needs exactly one axis name, got "
                f"axis={axis!r}"
            )
        selection = {axis[0]: selection}
    else:
        selection = dict(selection)
        if axis and set(axis) != set(selection):
            raise ValueError(
                f"axis argument {sorted(axis)} does not match selection "
                f"keys {sorted(selection)}"
            )
    exclude_axes = tuple(exclude_axes or ())
    for name, ds in source.datasets.items():
        if name not in dest.dataset_spec():
            continue
        if any(ax in ds.axes for ax in exclude_axes):
            continue
        arr = _to_numpy(ds._data)
        for i, ax in enumerate(ds.axes):
            if ax in selection:
                arr = np.take(arr, _sel_to_indices(selection[ax], arr.shape[i]), axis=i)
        if name not in dest.datasets:
            dest.add_dataset(name, data=arr)
        else:
            dest.datasets[name][:] = arr


# ---------------------------------------------------------------------------
# Structural base containers (reference draco/core/containers.py:83-467)
# ---------------------------------------------------------------------------


class TODContainer(ContainerBase):
    """A container with a time axis (reference containers.py:83)."""

    _axes = ("time",)

    @property
    def time(self):
        t = self.index_map["time"]
        if t.dtype.names and "ctime" in t.dtype.names:
            return t["ctime"]
        return t


class FreqContainer(ContainerBase):
    """A container with a frequency axis (reference containers.py:362)."""

    _axes = ("freq",)

    def _convert_axis(self, name, value):
        if name == "freq" and np.isscalar(value) and np.issubdtype(type(value), np.integer):
            return make_freq_map(np.linspace(800.0, 400.0, int(value), endpoint=False))
        return super()._convert_axis(name, value)

    @property
    def freq(self):
        f = self.index_map["freq"]
        if f.dtype.names and "centre" in f.dtype.names:
            return f["centre"]
        return f


class SiderealContainer(ContainerBase):
    """A container with a right-ascension axis (reference containers.py:386)."""

    _axes = ("ra",)

    @property
    def ra(self):
        return self.index_map["ra"]


class MContainer(ContainerBase):
    """A container with harmonic m and msign axes (reference containers.py:422)."""

    _axes = ("m", "msign")

    def __init__(self, mmax: int | None = None, oddra: bool | None = None, **kwargs):
        if mmax is not None:
            kwargs["m"] = np.arange(mmax + 1)
        kwargs.setdefault("msign", np.array(["+", "-"]))
        super().__init__(**kwargs)
        if oddra is not None:
            self.attrs["oddra"] = bool(oddra)

    def _finalise_axes(self, axes_from):
        # Derive oddra/m from a sidereal container when transforming.
        if "m" not in self.index_map and axes_from is not None:
            if "ra" in axes_from.index_map:
                nra = len(axes_from.index_map["ra"])
                self.create_index_map("m", np.arange(nra // 2 + 1))
                self.attrs["oddra"] = bool(nra % 2)

    @property
    def mmax(self) -> int:
        return len(self.index_map["m"]) - 1

    @property
    def oddra(self) -> bool:
        return bool(self.attrs.get("oddra", False))


class DataWeightContainer(ContainerBase):
    """Base for containers with a primary data + weight pair."""

    _data_dset_name: ClassVar[str] = "data"
    _weight_dset_name: ClassVar[str] = "weight"

    @property
    def data(self):
        return self.datasets[self._data_dset_name]

    @property
    def weight(self):
        return self.datasets[self._weight_dset_name]


class VisBase(DataWeightContainer):
    """Base for visibility containers (reference containers.py:94)."""

    _data_dset_name = "vis"
    _weight_dset_name = "vis_weight"

    @property
    def vis(self):
        return self.datasets["vis"]

    @property
    def weight(self):
        return self.datasets["vis_weight"]


class VisContainer(VisBase):
    """Visibilities with input/prod/stack index maps (reference containers.py:109).

    ``stack=None`` suppresses inheritance and builds identity stack maps
    from ``prod`` (the ExpandProducts convention, reference
    draco/synthesis/stream.py:216-230).
    """

    _axes = ("input", "prod", "stack")

    def __init__(self, *args, reverse_map_stack=None, **kwargs):
        self._reverse_map_stack = reverse_map_stack
        super().__init__(*args, **kwargs)

    def _convert_axis(self, name, value):
        if name == "input" and np.isscalar(value) and np.issubdtype(
            type(value), np.integer
        ):
            return np.arange(int(value))
        return super()._convert_axis(name, value)

    def _finalise_axes(self, axes_from):
        super()._finalise_axes(axes_from)
        # Auto-construct full-triangle prod map from inputs if missing
        # (reference containers.py:156-161).
        if "prod" not in self.index_map and "input" in self.index_map:
            nfeed = len(self.index_map["input"])
            self.create_index_map(
                "prod",
                make_prod_map(
                    np.array(
                        [[fi, fj] for fi in range(nfeed) for fj in range(fi, nfeed)]
                    )
                ),
            )
        stack_arg = self._extra_kwargs.pop("stack", _UNSET)
        if "prod" in self.index_map and (
            stack_arg is None or "stack" not in self.index_map
        ):
            nprod = len(self.index_map["prod"])
            fwd, rev = default_stack_maps(nprod)
            self.create_index_map("stack", fwd)
            self.create_reverse_map("stack", rev)
        if self._reverse_map_stack is not None:
            self.create_reverse_map("stack", np.asarray(self._reverse_map_stack))
        # Default input axis from prod if missing.
        if "input" not in self.index_map and "prod" in self.index_map:
            prod = self.index_map["prod"]
            ninput = int(max(prod["input_a"].max(), prod["input_b"].max())) + 1
            self.create_index_map("input", np.arange(ninput))

    @property
    def prod(self):
        return self.index_map["prod"]

    @property
    def stack(self):
        return self.index_map["stack"]

    @property
    def is_stacked(self) -> bool:
        return len(self.stack) != len(self.prod)

    @property
    def prodstack(self):
        """Input-pairs representative of each stack entry (conjugation applied)."""
        if not self.is_stacked:
            return self.prod
        t = self.prod[self.index_map["stack"]["prod"]]
        conj = self.stack["conjugate"]
        out = t.copy()
        out["input_a"] = np.where(conj, t["input_b"], t["input_a"])
        out["input_b"] = np.where(conj, t["input_a"], t["input_b"])
        return out

    @property
    def input(self):
        return self.index_map["input"]

    @property
    def nstack(self) -> int:
        return len(self.index_map["stack"])


class SampleVarianceContainer(ContainerBase):
    """Base adding sample mean/variance over a component axis.

    The component axis holds the upper triangle of the real/imag
    covariance: [(real,real), (real,imag), (imag,imag)]
    (reference containers.py:236-360).
    """

    _axes = ("component",)

    def _finalise_axes(self, axes_from):
        super()._finalise_axes(axes_from)
        if "component" not in self.index_map:
            self.create_index_map(
                "component",
                np.array(
                    [("real", "real"), ("real", "imag"), ("imag", "imag")],
                    dtype=[("component_a", "<U8"), ("component_b", "<U8")],
                ),
            )

    @property
    def component(self):
        return self.index_map["component"]

    @property
    def sample_variance(self):
        if "sample_variance" in self.datasets:
            return self.datasets["sample_variance"]
        raise KeyError("The 'sample_variance' dataset has not been created yet.")

    @property
    def nsample(self):
        if "nsample" in self.datasets:
            return self.datasets["nsample"]
        raise KeyError("The 'nsample' dataset has not been created yet.")

    @property
    def sample_variance_iq(self):
        """Sample variance rotated to the in-phase/quadrature basis."""
        C = np.asarray(self.sample_variance[:])
        phi = np.angle(np.asarray(self._mean[:]))
        cc, cs, ss = np.cos(phi) ** 2, np.cos(phi) * np.sin(phi), np.sin(phi) ** 2
        Cphi = np.zeros_like(C)
        Cphi[0] = cc * C[0] + 2 * cs * C[1] + ss * C[2]
        Cphi[1] = -cs * C[0] + (cc - ss) * C[1] + cs * C[2]
        Cphi[2] = ss * C[0] - 2 * cs * C[1] + cc * C[2]
        return Cphi

    @property
    def sample_variance_amp_phase(self):
        """Amplitude/phase covariance (valid for small fractional variation)."""
        amp2 = np.abs(np.asarray(self._mean[:])[np.newaxis, ...]) ** 2
        out = self.sample_variance_iq.copy()
        np.divide(out, amp2, out=out, where=amp2 != 0)
        out[..., :] = np.where(amp2 == 0, 0.0, out)
        return out

    @property
    def sample_weight(self):
        """Inverse variance of the mean estimated from the sample variance."""
        C = np.asarray(self.sample_variance[:])
        nsample = np.asarray(self.nsample[:])
        tot = C[0] + C[2]
        out = np.zeros_like(tot)
        np.divide(nsample, tot, out=out, where=tot != 0)
        return out


# The concrete container zoo lives in ``containers_spec`` but is exposed from
# this namespace too, mirroring the reference's single-module layout
# (reference draco/core/containers.py).  The re-export is lazy (PEP 562) so
# that ``import draco_tpu.core.containers_spec`` works cold: containers_spec
# imports the base classes from this module, and an eager star-import here
# would make that a circular import.
_BASE_ALL = [
    "ContainerBase",
    "Dataset",
    "TODContainer",
    "FreqContainer",
    "SiderealContainer",
    "MContainer",
    "DataWeightContainer",
    "VisBase",
    "VisContainer",
    "SampleVarianceContainer",
    "empty_like",
    "copy_datasets_filter",
    "COMPRESSION",
    "COMPRESSION_OPTS",
]


def __getattr__(name):
    from . import containers_spec as _spec

    if name == "__all__":
        return _BASE_ALL + list(_spec.__all__)
    if name in _spec.__all__:
        return getattr(_spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    from . import containers_spec as _spec

    return sorted(set(globals()) | set(_BASE_ALL) | set(_spec.__all__))
