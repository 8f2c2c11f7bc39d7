"""Simulate sidereal and time stream data.

Re-provides reference ``draco/synthesis/stream.py`` (SimulateSidereal:22,
ExpandProducts:181, MakeTimeStream:249, MakeTimeStreamFixedInput:346,
MakeTimeStreamFixedTime:378, MakeMultipleTimeStreams:410,
MakeSiderealDayStream:495).

Device design: the simulate spine (reference stream.py:85-140) — map -> alm
(SHT) -> per-m beam transfer projection -> inverse FFT over RA — runs as
three batched device kernels with no per-m Python loop; under a mesh the
alm tensor is resharded freq <-> m between the SHT and projection stages
(the reference's MPI parallel transpose, stream.py:96,119).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask, PipelineStopIteration
from ..ops import mmode, regrid, sht, tools
from ..ops.tools import invert_no_zero

# Module-scope jit: re-wrapping per call would give every process() a
# fresh jit cache and recompile the inverse transform for each day.
_mmodes_to_sidereal_jit = jax.jit(
    mmode.mmodes_to_sidereal, static_argnames=("n", "oddra")
)


@partial(jax.jit, static_argnames=("ax",))
def _regrid_ra_data(x, R, *, ax):
    """Lanczos regrid along RA, moveaxis folded into one program."""
    moved = jnp.moveaxis(x, ax, -1)
    return jnp.moveaxis(moved @ R.astype(moved.dtype), -1, ax)


@partial(jax.jit, static_argnames=("ax",))
def _regrid_ra_weight(w, R, *, ax):
    """Inverse-variance weight combination through the regrid matrix."""
    moved = jnp.moveaxis(w, ax, -1)
    out = invert_no_zero(invert_no_zero(moved) @ (R.astype(moved.dtype) ** 2))
    return jnp.moveaxis(out, -1, ax)


@jax.jit
def _expand_products_kernel(vis, idx, conj, valid):
    """Gather unique products to the full triangle in ONE program.

    The gather + conjugation mask runs as a single jit.
    """
    gathered = jnp.take(vis, idx, axis=1)
    out = jnp.where(conj[None, :, None], jnp.conj(gathered), gathered)
    return out * valid[None, :, None]


class SimulateSidereal(ContainerTask):
    """Create a simulated sidereal dataset from an input map.

    (reference stream.py:22-178)

    Attributes
    ----------
    stacked : bool
        Label the output baselines as a stacked set (index_map/stack +
        reverse_map/stack from the telescope) rather than a down-selection.
    """

    stacked = config.bool_prop(True)
    # Round the sidereal axis up to the next 2/3/5-smooth length.  The
    # natural minimal length 2*mmax + 1 often has a large prime factor
    # (e.g. 1535 = 5 x 307), which FFT libraries handle by a slower
    # Bluestein fallback; the extra samples carry no extra information (the m-mode
    # content is identical) but keep the iFFT on the radix path.
    fast_ra = config.bool_prop(False)
    # Streaming (factorised) projection: never materialises the beam
    # transfer — required at production scales where the B tensors exceed
    # device memory.
    streaming = config.bool_prop(False)
    baseline_chunk = config.int_prop(256)

    def setup(self, bt):
        """Set the beam transfer manager (BeamTransfer or ProductManager)."""
        self.beamtransfer = io.get_beamtransfer(bt)
        self.telescope = io.get_telescope(bt)

    def process(self, map_: containers.Map) -> containers.SiderealStream:
        """Simulate a SiderealStream from a Map."""
        bt = self.beamtransfer
        tel = self.telescope

        lmax, mmax = tel.lmax, tel.mmax
        ntime = (
            mmode.fast_fft_size(2 * mmax + 1) if self.fast_ra else 2 * mmax + 1
        )

        freqmap = map_.index_map["freq"][:]
        if not np.array_equal(tel.frequencies, freqmap["centre"]):
            raise ValueError("The sky map and beam-transfer frequency axes disagree.")

        # Sky harmonics for every (freq, pol) map; trim to mmax.  Device
        # pass-through: a map already on the mesh (possibly spanning
        # processes) must not round-trip through the host.
        row_map = tools.as_device(map_.map[:])
        alm = sht.sphtrans_sky(row_map, lmax=lmax)[..., : mmax + 1]

        # Batched beam-transfer projection over every m; under a
        # mesh this reshards freq-parallel alm into m-parallel visibilities.
        if self.streaming:
            vis_m = bt.project_sky_to_telescope_streaming(
                alm, chunk=self.baseline_chunk
            )
        else:
            vis_m = bt.project_sky_to_telescope(alm)  # [m+1, 2, nfreq, nb]

        # Inverse m-mode transform onto the sidereal grid
        # one jitted call (eager dispatch of the inverse m-mode transform
        # is slow); the simulated m-modes always fill the largest negative m (oddra).
        vis_stream = _mmodes_to_sidereal_jit(
            vis_m, n=ntime, oddra=True
        )  # [f, b, t]

        # Construct the output container.  A redundancy-stacked telescope
        # (fewer unique pairs than the full triangle) carries its own
        # prod/stack maps; otherwise label each unique pair directly.
        full_triangle = tel.npairs == tel.nfeed * (tel.nfeed + 1) // 2
        if self.stacked and not full_triangle:
            pair_kwargs = dict(
                prod=tel.index_map_prod,
                stack=tel.index_map_stack,
                reverse_map_stack=tel.reverse_map_stack,
            )
        else:
            pairs = np.asarray(tel.uniquepairs)
            prod_map = np.empty(
                len(pairs), dtype=[("input_a", int), ("input_b", int)]
            )
            prod_map["input_a"], prod_map["input_b"] = pairs.T
            pair_kwargs = {"prod": prod_map}

        sstream = containers.SiderealStream(
            freq=freqmap,
            ra=ntime,
            input=getattr(tel, "input_index", tel.nfeed),
            distributed=True,
            **pair_kwargs,
        )
        sstream.vis[:] = tools.device_to_numpy(vis_stream).astype(np.complex64)
        sstream.weight[:] = np.ones(sstream.weight.shape, dtype=np.float32)
        return sstream


class ExpandProducts(ContainerTask):
    """Un-wrap collated products to the full triangle (reference stream.py:181).

    Vectorised: a gather along the stack axis with a conjugation mask
    replaces the per-product Python loop (reference stream.py:233-244).
    """

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def process(
        self, sstream: containers.SiderealStream
    ) -> containers.SiderealStream:
        tel = self.telescope
        ninput = len(sstream.input)
        fi, fj = np.triu_indices(ninput)
        nprod = fi.size
        prod = np.empty(nprod, dtype=[("input_a", int), ("input_b", int)])
        prod["input_a"], prod["input_b"] = fi, fj

        new_stream = containers.SiderealStream(
            prod=prod, stack=None, axes_from=sstream
        )

        unique_ind = tel.feedmap[fi, fj]  # [nprod]
        conj = tel.feedconj[fi, fj]
        valid = unique_ind >= 0

        # the gather/conjugate runs as one jitted program
        vis = tools.as_device(np.asarray(sstream.vis[:]))  # [f, stack, ra]
        new_vis = _expand_products_kernel(
            vis,
            jnp.asarray(np.where(valid, unique_ind, 0).astype(np.int32)),
            jnp.asarray(conj),
            jnp.asarray(valid),
        )

        new_stream.vis[:] = tools.device_to_numpy(new_vis).astype(np.complex64)
        new_stream.weight[:] = (
            np.ones(new_stream.weight.shape, dtype=np.float32)
            * valid[None, :, None]
        )

        # Identity stack maps to mimic an N^2 file (reference stream.py:221-230)
        fwd, rev = containers.default_stack_maps(nprod)
        new_stream.create_index_map("stack", fwd)
        new_stream.create_reverse_map("stack", rev)
        return new_stream


class MakeTimeStream(ContainerTask):
    """Sample a sidereal stream at the times of a timestream.

    (reference stream.py:249-343) — Lanczos interpolation of the RA axis.
    """

    lanczos_width = config.int_prop(5)

    # output container per input type; checked in order so subclasses
    # that appear in both rows resolve to the more specific mapping
    _output_types = (
        (containers.HybridVisStream, containers.HybridVisStream),
        (containers.SiderealStream, containers.TimeStream),
    )

    def setup(self, observer):
        self.observer = io.get_telescope(observer)

    def _sample_times(self, tstream):
        """(unix time, RA degrees) of the target samples."""
        if hasattr(tstream, "time") and "time" in tstream.index_map:
            t = tstream.time[:]
            return t, self.observer.unix_to_lsa(t)
        ra = tstream.ra[:]
        day = tstream.attrs.get("lsd", tstream.attrs.get("csd"))
        return self.observer.lsd_to_unix(day + ra / 360.0), ra

    def process(self, sstream, tstream):
        time, tra = self._sample_times(tstream)

        for in_type, out_type in self._output_types:
            if isinstance(sstream, in_type):
                break
        else:
            raise TypeError(
                f"No valid container mapping for {sstream.__class__}."
            )

        # TimeStream carries only a time axis; HybridVisStream keeps an
        # RA axis alongside — pass ra only where the output defines it
        kw = {"time": time}
        if "ra" in out_type.axes_spec():
            kw["ra"] = tra
        out = out_type(axes_from=sstream, attrs_from=sstream, **kw)

        # Periodic Lanczos interpolation matrix over RA, applied on
        # device; weights combine as inverse variances.
        R = jnp.asarray(
            regrid.lanczos_forward_matrix(
                sstream.ra, tra % 360, self.lanczos_width, periodic=True
            ).T.copy()
        )

        def along_ra(values, axis_names, kernel):
            # ONE jitted program per call
            ax = list(axis_names).index("ra")
            dev = tools.as_device(np.asarray(values))
            return tools.device_to_numpy(kernel(dev, R, ax=ax))

        out.data[:] = along_ra(
            sstream.data[:], sstream.data.axes, _regrid_ra_data
        ).astype(out.data.dtype)
        out.weight[:] = along_ra(
            sstream.weight[:], sstream.weight.axes, _regrid_ra_weight
        ).astype(out.weight.dtype)
        return out


class MakeTimeStreamFixedInput(MakeTimeStream):
    """Make multiple time streams from a single input (reference stream.py:346)."""

    def setup(self, observer, sstream):
        super().setup(observer)
        self.sstream = sstream

    def process(self, tstream):
        return super().process(self.sstream, tstream)


class MakeTimeStreamFixedTime(MakeTimeStream):
    """Make multiple time streams for fixed time samples (reference stream.py:378)."""

    def setup(self, observer, tstream):
        super().setup(observer)
        self.tstream = tstream

    def process(self, sstream):
        return super().process(sstream, self.tstream)


class MakeMultipleTimeStreams(MakeTimeStreamFixedInput):
    """Generate a series of time stream files from a sidereal stream.

    (reference stream.py:410-492)
    """

    start_time = config.utc_time()
    end_time = config.utc_time()
    integration_time = config.float_prop(None)
    integration_frame_exp = config.int_prop(23)
    samples_per_file = config.int_prop(1024)

    _time_axes = None

    def process(self):
        if self._time_axes is None:
            self._time_axes = self._iter_time_axes()
        try:
            tstream = next(self._time_axes)
        except StopIteration:
            raise PipelineStopIteration() from None
        return super().process(tstream)

    def _iter_time_axes(self):
        """Yield one TOD time axis per output file across the span.

        Samples are spaced by ``integration_time`` seconds when given,
        else by an FPGA frame count of ``2**integration_frame_exp``
        (2.56 us frames); the FPGA case carries a structured
        (fpga_count, ctime) axis like real correlator data.
        """
        fpga_frames = self.integration_time is None
        step = (
            2.56e-6 * 2**self.integration_frame_exp
            if fpga_frames
            else self.integration_time
        )
        cursor = self.start_time
        while cursor < self.end_time:
            n = min(
                self.samples_per_file,
                int(np.ceil((self.end_time - cursor) / step)),
            )
            stamps = cursor + step * np.arange(1, n + 1)
            cursor += n * step
            if fpga_frames:
                axis = np.zeros(
                    n, dtype=[("fpga_count", np.uint64), ("ctime", np.float64)]
                )
                axis["ctime"] = stamps
                frames = (stamps - self.start_time) / step
                axis["fpga_count"] = (
                    frames * 2**self.integration_frame_exp
                ).astype(np.uint64)
            else:
                axis = stamps
            yield containers.TODContainer(time=axis, skip_datasets=True)


class MakeSiderealDayStream(ContainerTask):
    """Emit a copy of a base sidereal stream for every LSD in a time range.

    (reference stream.py:495-561)
    """

    start_time = config.utc_time()
    end_time = config.utc_time()

    def setup(self, bt, sstream):
        observer = io.get_telescope(bt)
        lsd_start = observer.unix_to_lsd(self.start_time)
        lsd_end = observer.unix_to_lsd(self.end_time)
        self.log.info(
            "Simulating the sidereal range LSD %i..%i",
            int(lsd_start),
            int(lsd_end),
        )
        # first full day after the start, through the last day before the end
        self._days = iter(range(int(lsd_start + 1), int(np.ceil(lsd_end))))
        self.sstream = sstream

    def process(self):
        try:
            day = next(self._days)
        except StopIteration:
            raise PipelineStopIteration() from None
        out = self.sstream.copy()
        out.attrs.update(tag=f"lsd_{day}", lsd=day)
        return out
