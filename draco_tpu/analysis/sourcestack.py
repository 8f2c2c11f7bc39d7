"""Stacking formed beams over catalog sources in frequency offset.

JAX re-design of reference ``draco/analysis/sourcestack.py``
(SourceStack:17, RandomSubset:214, GroupSourceStacks:332).  The
reference accumulates one ``np.bincount`` per polarisation on host;
here every (source, frequency-channel) contribution is routed through a
single device ``segment_sum`` batched over polarisations, with
off-stack pairs parked in a sentinel segment.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops.tools import invert_no_zero

#: HI hyperfine rest frequency in MHz
NU21 = 1420.405751768


@functools.partial(jax.jit, static_argnames=("nstack", "uniform"))
def _stack_segments(beam, weight, seg_ids, *, nstack: int, uniform: bool):
    """Weighted scatter-add of beams into offset bins, per polarisation.

    beam, weight : [nsource, npol, nfreq]
    seg_ids : [nsource * nfreq] target bin per pair; ``nstack`` parks
        invalid pairs in a discarded sentinel segment.

    Returns (stack[npol, nstack], weight_sum[npol, nstack]).
    """
    npol = beam.shape[1]
    w = (weight > 0).astype(beam.dtype) if uniform else weight

    # [nsource, npol, nfreq] -> [nsource * nfreq, npol]
    flat = lambda a: a.transpose(0, 2, 1).reshape(-1, npol)  # noqa: E731
    num = jax.ops.segment_sum(
        flat(w * beam), seg_ids, num_segments=nstack + 1
    )
    den = jax.ops.segment_sum(flat(w), seg_ids, num_segments=nstack + 1)

    den = den[:nstack].T
    return num[:nstack].T * invert_no_zero(den), den


class SourceStack(ContainerTask):
    """Average formed beams over catalog sources in offset frequency.

    Each source contributes the spectrum around its own 21 cm frequency,
    shifted onto a common offset axis; the result is the weighted mean
    over sources.  The input BeamForm must have collapsed the hour-angle
    axis.  Semantics of reference ``draco/analysis/sourcestack.py:17-211``.

    Attributes
    ----------
    freqside : int
        Channels kept on each side of each source's own channel.
    single_source_bin_index : int
        If set, keep only sources whose redshifted frequency falls in
        this channel of the input.
    uniform_weight : bool
        Weight every unmasked sample equally instead of by inverse
        variance.
    """

    freqside = config.int_prop(50)
    single_source_bin_index = config.int_prop(None)
    uniform_weight = config.bool_prop(False)

    def _offset_axis(self, formed_beam, nfreq):
        """Offset-frequency axis: the central ``2 freqside + 1`` channels
        of the input, re-centred on zero."""
        half = self.freqside
        sel = slice(nfreq // 2 - half, nfreq // 2 + half + 1)
        axis = np.copy(formed_beam.frequency[sel])
        axis["centre"] -= axis["centre"][half]
        return axis

    @staticmethod
    def _bin_edges(axis):
        """Channel edges of the offset axis, in its own channel order."""
        step = 1.0 if axis["centre"][-1] >= axis["centre"][0] else -1.0
        lead = axis["centre"] - step * 0.5 * axis["width"]
        tail = axis["centre"][-1] + step * 0.5 * axis["width"][-1]
        return np.append(lead, tail)

    def process(self, formed_beam):
        """Stack over sources; returns FrequencyStack[ByPol]."""
        freq = np.asarray(formed_beam.freq)
        nfreq = freq.size
        pol = formed_beam.pol
        npol = len(pol)
        nstack = 2 * self.freqside + 1

        axis = self._offset_axis(formed_beam, nfreq)
        edges = self._bin_edges(axis)

        # offset of every channel from every source's redshifted line
        z = np.asarray(formed_beam["redshift"][:]["z"])
        nu_src = NU21 / (1.0 + z)
        offset = freq[np.newaxis, :] - nu_src[:, np.newaxis]

        bins = np.digitize(offset, edges) - 1
        in_range = (bins >= 0) & (bins < nstack)

        keep_source = in_range.any(axis=1)
        if self.single_source_bin_index is not None:
            chan = formed_beam.index_map["freq"][self.single_source_bin_index]
            keep_source &= (
                np.abs(nu_src - chan["centre"]) < 0.5 * chan["width"]
            )
        good = in_range & keep_source[:, np.newaxis]
        self.log.info(
            f"Stacking {int(keep_source.sum())} of {len(nu_src)} sources."
        )

        seg_ids = np.where(good, bins, nstack).ravel()

        stacked, wsum = _stack_segments(
            jnp.asarray(np.asarray(formed_beam.beam[:])),
            jnp.asarray(np.asarray(formed_beam.weight[:])),
            jnp.asarray(seg_ids),
            nstack=nstack,
            uniform=bool(self.uniform_weight),
        )
        stacked = np.asarray(stacked)
        wsum = np.asarray(wsum)

        if npol > 1:
            out = containers.FrequencyStackByPol(
                freq=axis, pol=pol, attrs_from=formed_beam
            )
            out.stack[:] = stacked
            out.weight[:] = wsum
        else:
            out = containers.FrequencyStack(freq=axis, attrs_from=formed_beam)
            out.stack[:] = stacked[0]
            out.weight[:] = wsum[0]
        return out


class RandomSubset(ContainerTask, RandomTask):
    """Emit ``number`` random fixed-size sub-catalogs of a catalog.

    Semantics of reference ``draco/analysis/sourcestack.py:214-329``.

    Attributes
    ----------
    number : int
        How many sub-catalogs to draw.
    size : int
        Objects in each draw (without replacement).
    """

    number = config.int_prop()
    size = config.int_prop()

    def __init__(self):
        super().__init__()
        self._drawn = 0

    def setup(self, catalog):
        """Store the parent catalog and derive the output tag pattern."""
        self.catalog = catalog
        stem = catalog.attrs.get("tag")
        self._tag_pattern = (f"{stem}_" if stem else "") + "mock_{:05d}"

    def process(self):
        """Draw the next sub-catalog."""
        if self._drawn >= self.number:
            raise PipelineStopIteration

        objects = self.catalog.index_map["object_id"]
        pick = np.sort(
            self.rng.choice(len(objects), self.size, replace=False)
        )

        sub = self.catalog.__class__(
            object_id=objects[pick],
            attrs_from=self.catalog,
            axes_from=self.catalog,
        )
        sub.attrs["tag"] = self._tag_pattern.format(self._drawn)

        for name, dset in self.catalog.datasets.items():
            if name not in sub.datasets:
                sub.add_dataset(name)
            arr = np.asarray(dset[:])
            if tuple(dset.attrs["axis"])[0] == "object_id":
                arr = arr[pick]
            sub.datasets[name][:] = arr

        self._drawn += 1
        return sub


class GroupSourceStacks(ContainerTask):
    """Concatenate incoming frequency stacks along a new mock axis.

    Semantics of reference ``draco/analysis/sourcestack.py:332-467``.

    Attributes
    ----------
    ngroup : int
        Inputs gathered into each emitted container.
    """

    ngroup = config.int_prop(100)

    _PROMOTE = {
        containers.FrequencyStack: containers.MockFrequencyStack,
        containers.FrequencyStackByPol: containers.MockFrequencyStackByPol,
        containers.MockFrequencyStack: containers.MockFrequencyStack,
        containers.MockFrequencyStackByPol: containers.MockFrequencyStackByPol,
    }

    def setup(self):
        """Start with an empty accumulator."""
        self._pending = []
        self._groups_out = 0

    def process(self, stack):
        """Buffer one stack; flush when ``ngroup`` have arrived."""
        self._pending.append(stack)
        self.log.debug(f"Buffered stack {len(self._pending)}/{self.ngroup}.")
        if len(self._pending) % self.ngroup == 0:
            return self._flush()
        return None

    def process_finish(self):
        """Flush any remainder."""
        if self._pending:
            return self._flush()
        return None

    @staticmethod
    def _group_tag(tag, counter_str):
        """Rewrite mock->group->supergroup in the accumulated tag."""
        parts = tag.split("_")
        for marker, promoted in (("group", "supergroup"), ("mock", "group")):
            if marker in parts:
                at = max(i for i, p in enumerate(parts) if p == marker)
                parts[at] = promoted
                parts[at + 1] = counter_str
                return "_".join(parts)
        return "_".join(parts + ["group", counter_str])

    def _flush(self):
        first = self._pending[0]
        counter_str = f"{self._groups_out:03d}"

        def mock_count(s):
            return len(s.index_map["mock"]) if "mock" in s.index_map else 1

        total = sum(mock_count(s) for s in self._pending)
        self.log.info(
            f"Emitting group {counter_str} with {total} mock realisations."
        )

        out = self._PROMOTE[first.__class__](
            mock=np.arange(total, dtype=np.int64),
            axes_from=first,
            attrs_from=first,
        )
        out.attrs["tag"] = self._group_tag(
            out.attrs.get("tag", ""), counter_str
        ) if "tag" in out.attrs else f"group_{counter_str}"

        for name, src in first.datasets.items():
            if name not in out.datasets:
                out.add_dataset(name)
            pieces = []
            for s in self._pending:
                dset = s.datasets[name]
                arr = np.asarray(dset[:])
                if tuple(dset.attrs["axis"])[0] != "mock":
                    arr = arr[np.newaxis]
                pieces.append(arr)
            out.datasets[name][:] = np.concatenate(pieces, axis=0)

        self._pending = []
        self._groups_out += 1
        return out
