"""Miscellaneous transformations: the m-mode transform hub + reshaping.

Re-provides reference ``draco/analysis/transform.py`` (2253 LoC;
FrequencyRebin:20, CollateProducts:142, SelectFreq:333, MModeTransform:535,
MModeInverseTransform:708, SiderealMModeResample:795, ShiftRA:993,
SelectPol:1068, StokesIVis:1333, MixData:1606, Downselect:1848, ...).

The m-mode transform (the hot FFT stage, reference transform.py:644-705)
runs as one batched device FFT via :mod:`draco_tpu.ops.mmode`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask, group_tasks
from ..ops import mmode, tools
from ..ops.tools import invert_no_zero

C_LIGHT = 299792458.0


@partial(jax.jit, static_argnames=("mmax", "deconv", "nra"))
def _mmode_pack(svis, mmax, deconv, nra):
    """FFT + +/-m packing (+ optional window deconvolution), one program.

    Module-scope so the jit cache persists across process() calls — a
    closure defined per call has a fresh identity and recompiles the
    same executable for every incoming container.
    """
    mvis = mmode.make_marray(svis, mmax=mmax)
    if deconv:
        m = jnp.arange(mmax + 1)
        w_win = jnp.sinc(m / nra)
        sl = (slice(None),) + (None,) * (mvis.ndim - 1)
        mvis = mvis * invert_no_zero(w_win)[sl]
    return mvis


class FrequencyRebin(ContainerTask):
    """Rebin neighbouring frequency channels (reference transform.py:20).

    Attributes
    ----------
    channel_bin : int
        Number of channels to merge.
    """

    channel_bin = config.int_prop(1)

    def process(self, ss):
        if "freq" not in ss.index_map:
            raise RuntimeError("A freq axis is required for rebinning.")
        cb = self.channel_bin
        if len(ss.freq) % cb != 0:
            raise RuntimeError("The channel count is not a multiple of the bin size.")

        freq_map = ss.index_map["freq"]
        centre = freq_map["centre"].reshape(-1, cb).mean(axis=-1)
        width = freq_map["width"].reshape(-1, cb).sum(axis=-1)
        new_freq = np.zeros(len(centre), dtype=freq_map.dtype)
        new_freq["centre"] = centre
        new_freq["width"] = width

        sb = ss.__class__(freq=new_freq, axes_from=ss, attrs_from=ss)

        for name, ds in ss.datasets.items():
            if name not in sb.dataset_spec():
                continue
            if "freq" not in ds.axes:
                if name not in sb.datasets:
                    sb.add_dataset(name)
                sb.datasets[name][:] = ds[:]
                continue
            fax = list(ds.axes).index("freq")
            # device pass-through (no host round trip): the math then
            # runs SPMD on sharded/global arrays unchanged — including
            # process-spanning arrays on a multi-host mesh, where a
            # host pull of the full array is not even possible
            arr = jnp.moveaxis(ds._as_device(), fax, 0)
            shape = (len(centre), cb) + arr.shape[1:]
            if name.endswith("weight") or name == "weight":
                # inverse-variance weights combine as a sum
                new = arr.reshape(shape).sum(axis=1)
            else:
                # weighted average using the weight dataset when present
                if name == "vis" and "vis" in ss.datasets:
                    w = jnp.moveaxis(ss.weight._as_device(), fax, 0)
                    num = (arr * w).reshape(shape).sum(axis=1)
                    den = w.reshape(shape).sum(axis=1)
                    new = num * invert_no_zero(den)
                else:
                    new = arr.reshape(shape).mean(axis=1)
            if name not in sb.datasets:
                sb.add_dataset(name)
            sb.datasets[name][:] = jnp.moveaxis(new, 0, fax).astype(ds.dtype)
        return sb


class SelectFreq(ContainerTask):
    """Select a subset of frequencies (reference transform.py:333).

    Attributes
    ----------
    freq_physical : list
        Physical frequencies (MHz) to select.
    channel_range : list
        [start, stop, (step)] channel range.
    channel_index : list
        Explicit channel indices.
    freq_physical_range : list
        [low, high] physical frequency bounds.
    """

    freq_physical = config.list_prop([])
    channel_range = config.list_prop([])
    channel_index = config.list_prop([])
    freq_physical_range = config.list_prop([])

    def _chosen_channels(self, freq):
        """Resolve the configured selection to an index/slice."""
        if self.freq_physical:
            nearest = {np.argmin(np.abs(freq - fp)) for fp in self.freq_physical}
            return sorted(nearest)
        if self.channel_range and (len(self.channel_range) <= 3):
            return slice(*self.channel_range)
        if self.channel_index:
            return self.channel_index
        if self.freq_physical_range:
            low, high = sorted(self.freq_physical_range)
            return np.where((freq >= low) & (freq < high))[0]
        raise ValueError(
            "Must specify one of freq_physical, channel_range, "
            "channel_index or freq_physical_range."
        )

    def process(self, data):
        freq_map = data.index_map["freq"]
        freq = freq_map["centre"] if freq_map.dtype.names else freq_map

        fsel = np.arange(len(freq))[self._chosen_channels(freq)]
        newdata = data.__class__(
            freq=freq_map[fsel], axes_from=data, attrs_from=data
        )
        # copy_datasets_filter also carries freq-independent datasets
        # across unchanged (the selection only applies to named axes)
        containers.copy_datasets_filter(data, newdata, selection={"freq": fsel})
        return newdata


class MModeTransform(ContainerTask):
    """Transform a sidereal stream to m-modes (reference transform.py:535).

    The FFT over RA and the +/-m packing run as one batched device kernel
    (ops.mmode.make_marray).

    Attributes
    ----------
    remove_integration_window : bool
        Deconvolve the finite-width rectangular RA integration window.
    """

    remove_integration_window = config.bool_prop(False)
    # Accepted for reference-config compatibility (transform.py:555); the
    # transform always runs as a batched on-device XLA FFT here.
    use_fftw = config.bool_prop(True)

    def setup(self, manager=None):
        """Optionally set the telescope to define mmax."""
        self.telescope = io.get_telescope(manager) if manager is not None else None

    def process(self, sstream) -> containers.MContainer:
        contmap = {
            containers.SiderealStream: containers.MModes,
            containers.HybridVisStream: containers.HybridVisMModes,
        }
        out_cont = None
        for cls in type(sstream).__mro__:
            if cls in contmap:
                out_cont = contmap[cls]
                break
        if out_cont is None:
            raise TypeError(f"No m-mode container for {type(sstream)}")

        sstream.redistribute("freq")
        svis = tools.as_device(sstream.vis[:])
        sweight = sstream.weight._as_device()

        # Noise variance of the m-modes: sum of per-sample variances
        # (reference transform.py:599-602)
        nra = sweight.shape[-1]
        var_sum = invert_no_zero(sweight).sum(axis=-1)
        weight_sum = nra**2 * invert_no_zero(var_sum)

        mmax = (
            svis.shape[-1] // 2
            if self.telescope is None
            else self.telescope.mmax
        )

        ma = out_cont(
            mmax=mmax,
            oddra=bool(nra % 2),
            axes_from=sstream,
            attrs_from=sstream,
        )
        # one jitted call: a single executable is faster
        mvis = _mmode_pack(svis, mmax, self.remove_integration_window, nra)
        # weight shape: vis weight axes minus ra, broadcast over (m, msign)
        mw = np.broadcast_to(
            tools.device_to_numpy(weight_sum)[None, None],
            (mmax + 1, 2) + weight_sum.shape,
        ).copy()
        if self.remove_integration_window:
            w_win = np.sinc(np.arange(mmax + 1) / nra)
            sl = (slice(None),) + (None,) * (mw.ndim - 1)
            mw = mw * (w_win[sl] ** 2)

        ma.vis[:] = tools.device_to_numpy(mvis).astype(ma.vis.dtype)
        ma.weight[:] = mw.astype(ma.weight.dtype)
        return ma


@partial(jax.jit, static_argnames=("nra", "oddra", "apply_win"))
def _mmode_inverse(mvis, mweight, *, nra, oddra, apply_win):
    """Window re-application + inverse m-mode FFT as ONE device program."""
    if apply_win:
        m = jnp.arange(mvis.shape[0])
        w = jnp.sinc(m / nra)
        inv_w = invert_no_zero(w)
        sl = (slice(None),) + (None,) * (mvis.ndim - 1)
        mvis = mvis * w[sl]
        mweight = mweight * (inv_w[sl] ** 2)
    return mmode.mmodes_to_sidereal(mvis, n=nra, oddra=oddra), mweight


class MModeInverseTransform(ContainerTask):
    """Transform m-modes back to a sidereal stream (reference transform.py:708).

    Attributes
    ----------
    nra : int
        Number of output RA bins (default: Nyquist for the stored mmax).
    apply_integration_window : bool
        Re-apply the rectangular integration window.
    """

    nra = config.int_prop(None)
    apply_integration_window = config.bool_prop(False)

    def process(self, mmodes: containers.MContainer):
        mmodes.redistribute("freq")
        nra = self.nra
        if nra is None:
            # critically-sampled RA count for the stored mmax
            nra = 2 * mmodes.mmax + int(bool(mmodes.oddra))

        mvis = tools.as_device(mmodes.vis[:])
        mweight = mmodes.weight._as_device()

        ssarray, mweight = _mmode_inverse(
            mvis,
            mweight,
            nra=nra,
            oddra=bool(mmodes.oddra),
            apply_win=bool(self.apply_integration_window),
        )
        nra = ssarray.shape[-1]

        sstream = containers.SiderealStream(
            ra=nra, axes_from=mmodes, attrs_from=mmodes, distributed=True
        )
        sstream.vis[:] = tools.device_to_numpy(ssarray).astype(
            sstream.vis.dtype
        )
        # No time information recoverable: spread the m=0 weight over RA
        # (reference transform.py:788-790)
        w0 = tools.device_to_numpy(mweight[0, 0]) / nra
        sstream.weight[:] = w0[..., np.newaxis] * np.ones(
            (1,) * w0.ndim + (nra,), dtype=sstream.weight.dtype
        )
        return sstream


class SiderealMModeResample(group_tasks(MModeTransform, MModeInverseTransform)):
    """Resample a sidereal stream by forward+inverse m-mode transform.

    (reference transform.py:795)
    """


class ShiftRA(ContainerTask):
    """Add an offset to the RA axis (reference transform.py:993).

    Attributes
    ----------
    delta : float
        Shift in degrees.
    periodic : bool
        Wrap and roll so the axis stays in [0, 360).
    """

    delta = config.float_prop(0.0)
    periodic = config.bool_prop(False)

    def process(self, sscont: containers.SiderealContainer):
        if not isinstance(sscont, containers.SiderealContainer):
            raise TypeError(
                f"Expected SiderealContainer, got {type(sscont)}"
            )
        ra = sscont.index_map["ra"] + self.delta
        if self.periodic:
            shift = int(np.argmin(ra % 360.0))
            ra = np.roll(ra % 360.0, -shift)
            for ds in sscont.datasets.values():
                if "ra" in ds.axes:
                    ax = list(ds.axes).index("ra")
                    ds[:] = np.roll(np.asarray(ds[:]), -shift, axis=ax)
        sscont.create_index_map("ra", ra)
        return sscont


class LanczosRegridder(ContainerTask):
    """Interpolate the time-like axis onto a regular grid.

    Maximum-likelihood inverse of a Lanczos interpolation via the banded
    Wiener filter (reference transform.py:854-986); the banded solve runs
    batched on device (ops.banded).

    Attributes
    ----------
    samples : int
        Number of output samples.
    start, end : float
        Range of the output grid (defaults to the data bounds).
    kernel_width : int
        Lanczos kernel width.
    epsilon : float
        Regulariser (inverse signal variance).
    mask_zero_weight : bool
        Zero output weights where the input weights were all zero.
    """

    samples = config.int_prop(1024)
    start = config.float_prop(None)
    end = config.float_prop(None)
    kernel_width = config.int_prop(5)
    epsilon = config.float_prop(1e-3)
    mask_zero_weight = config.bool_prop(False)

    def setup(self, observer):
        self.observer = io.get_telescope(observer)

    def process(self, data):
        data.redistribute("freq")
        weight = np.asarray(data.weight[:])
        vis_data = np.asarray(data.vis[:])

        timelike_axis = data.vis.attrs["axis"][-1]
        times = data.index_map[timelike_axis][:]
        if times.dtype.names and "ctime" in times.dtype.names:
            times = times["ctime"]

        if self.start is None:
            self.start = float(times[0])
        if self.end is None:
            self.end = float(times[-1])
        if self.start < times[0] or self.end > times[-1]:
            msg = (
                "Start or end points for regridder fall outside bounds of "
                "input data."
            )
            self.log.error(msg)
            raise RuntimeError(msg)

        new_grid, new_vis, ni = self._regrid(vis_data, weight, times)

        cont_type = data.__class__
        new_data = cont_type(axes_from=data, attrs_from=data, **{timelike_axis: new_grid})
        new_data.vis[:] = new_vis.astype(new_data.vis.dtype)
        new_data.weight[:] = ni.astype(new_data.weight.dtype)
        return new_data

    def _regrid(self, vis_data, weight, times):
        from ..ops import regrid as regrid_ops

        # Padded output grid (trimmed after the solve to kill edge wrap)
        pad = 5 * self.kernel_width
        span = self.end - self.start
        ticks = np.arange(-pad, self.samples + pad, dtype=np.float64)
        grid = self.start + span * ticks / self.samples

        projector = regrid_ops.lanczos_forward_matrix(
            grid, times, self.kernel_width
        ).T.copy()

        ntime = vis_data.shape[-1]
        solved, ni = regrid_ops.band_wiener(
            projector,
            weight.reshape(-1, ntime),
            np.full(grid.size, self.epsilon),
            vis_data.reshape(-1, ntime),
            2 * self.kernel_width - 1,
        )

        core = slice(pad, -pad)
        out_shape = (*vis_data.shape[:-1], self.samples)
        solved = np.asarray(solved)[:, core].reshape(out_shape)
        ni = np.asarray(ni)[:, core].reshape(out_shape)

        if self.mask_zero_weight:
            had_data = weight.sum(axis=-1) != 0.0
            ni = ni * had_data[..., np.newaxis]
        return grid[core].copy(), solved, ni


# Alias for compatibility
Regridder = LanczosRegridder


class TelescopeStreamMixIn:
    """Mixin computing telescope-defined prod/stack index maps.

    (reference transform.py:91-139).  Provides ``bt_prod``, ``bt_stack``
    and ``bt_rev`` for building streams compatible with a telescope's
    baseline configuration.
    """

    def setup(self, tel):
        """Set the telescope instance and precompute index maps."""
        from ..ops import tools

        self.telescope = tel = io.get_telescope(tel)
        nfeed = tel.nfeed

        # stack map: each unique pair's upper-triangle product id, with a
        # conjugation bit when the pair is stored lower-triangle
        pairs = np.asarray(tel.uniquepairs)
        lo = pairs.min(axis=1)
        hi = pairs.max(axis=1)
        self.bt_stack = np.zeros(
            len(pairs), dtype=[("prod", "<u4"), ("conjugate", "u1")]
        )
        self.bt_stack["prod"] = [
            tools.cmap(a, b, nfeed) for a, b in zip(lo, hi)
        ]
        self.bt_stack["conjugate"] = pairs[:, 0] > pairs[:, 1]

        # full upper-triangle product map
        ia, ib = np.triu_indices(nfeed)
        self.bt_prod = np.zeros(
            ia.size, dtype=[("input_a", "<u2"), ("input_b", "<u2")]
        )
        self.bt_prod["input_a"] = ia
        self.bt_prod["input_b"] = ib

        # reverse map: product -> stack (masked products park one past
        # the end)
        ok = tel.feedmask[ia, ib]
        self.bt_rev = np.zeros(
            ok.size, dtype=[("stack", "<u4"), ("conjugate", "u1")]
        )
        self.bt_rev["stack"] = np.where(ok, tel.feedmap[ia, ib], tel.npairs)
        self.bt_rev["conjugate"] = ok & (tel.feedconj[ia, ib] != 0)


class CollateProducts(TelescopeStreamMixIn, ContainerTask):
    """Extract and order the correlation products for map-making.

    (reference transform.py:142-330).  The per-product accumulation loop
    becomes a device segment-sum: gather (source product, destination
    stack, conjugation) index arrays on the host, then one batched
    ``jax.ops.segment_sum`` per dataset.

    Attributes
    ----------
    weight : "natural" | "uniform" | "inverse_variance"
        Redundant-baseline weighting for the stack.
    """

    weight = config.enum(
        ["natural", "uniform", "inverse_variance"], default="natural"
    )

    def _incoming_products(self, ss):
        """(product pairs, conjugation flags) of the incoming stream."""
        from ..ops import tools

        if not ss.is_stacked:
            return ss.prod, np.zeros(ss.prod.size, dtype=bool)
        stack_new, stack_flag = tools.redefine_stack_index_map(
            self.telescope,
            ss.input,
            ss.prod,
            ss.stack,
            ss.reverse_map["stack"],
        )
        dropped = int((~stack_flag).sum())
        if dropped:
            self.log.warning(
                f"{dropped} stacks are flagged out by the telescope model."
            )
        return ss.prod[stack_new["prod"]], stack_new["conjugate"].astype(bool)

    def process(self, ss):
        """Select and reorder products to match the telescope config."""
        from ..ops import tools

        tel = self.telescope
        input_ind = tools.find_inputs(
            tel.input_index, ss.input, require_match=False
        )
        rev_input_ind = tools.find_inputs(
            ss.input, tel.input_index, require_match=True
        )
        freq_ind = tools.find_keys(
            np.asarray(ss.freq), tel.frequencies, require_match=True
        )

        ss_prod, ss_conj = self._incoming_products(ss)

        sp = ss.__class__(
            freq=ss.index_map["freq"][freq_ind],
            input=tel.input_index,
            prod=self.bt_prod,
            stack=self.bt_stack,
            reverse_map_stack=self.bt_rev,
            axes_from=ss,
            attrs_from=ss,
        )

        if "input_flags" in sp.datasets or "input_flags" in sp.dataset_spec():
            if "input_flags" not in sp.datasets:
                sp.add_dataset("input_flags")
            sp.datasets["input_flags"][:] = np.asarray(ss.input_flags[:])[
                rev_input_ind, :
            ]

        # Redundancy-style weights per input stack
        if self.weight != "inverse_variance":
            nprod_in_stack = tools.calculate_redundancy(
                np.asarray(ss.input_flags[:]),
                np.asarray(ss.index_map["prod"][:]),
                np.asarray(ss.reverse_map["stack"]["stack"][:]),
                ss.vis.shape[1],
            )
            if self.weight == "uniform":
                nprod_in_stack = (nprod_in_stack > 0).astype(np.float32)
        else:
            nprod_in_stack = None

        # Build gather/scatter indices on the host: map each incoming
        # product onto a telescope feed pair, then onto its output stack
        fa = np.array(
            [-1 if x is None else x for x in input_ind], dtype=int
        )
        bi = fa[ss_prod["input_a"].astype(int)]
        bj = fa[ss_prod["input_b"].astype(int)]
        known = (bi >= 0) & (bj >= 0)
        stack_of = np.where(
            known, self.telescope.feedmap[bi, bj], -1
        )
        usable = known & (stack_of >= 0)

        src = np.flatnonzero(usable)
        dst = stack_of[src]
        conj = (
            self.telescope.feedconj[bi[src], bj[src]] != ss_conj[src]
        )
        nstack_out = len(self.bt_stack)

        ssv = tools.as_device(ss.vis[:])[jnp.asarray(freq_ind)]
        ssw = jnp.asarray(np.asarray(ss.weight[:])[freq_ind])

        vis_sel = ssv[:, src]
        w_sel = ssw[:, src]
        if self.weight == "inverse_variance":
            wss = w_sel
        else:
            wss = (w_sel > 0.0).astype(jnp.float32) * jnp.asarray(
                nprod_in_stack
            )[None, src]

        vis_c = jnp.where(
            jnp.asarray(conj)[None, :, None], vis_sel.conj(), vis_sel
        )

        # Segment-sum over the destination stack (device scatter-add)
        def seg(x):
            return jax.ops.segment_sum(
                jnp.moveaxis(x, 1, 0), jnp.asarray(dst), num_segments=nstack_out
            )

        acc_vis = jnp.moveaxis(seg(wss * vis_c), 0, 1)
        acc_var = jnp.moveaxis(seg(wss**2 * invert_no_zero(w_sel)), 0, 1)
        counter = jnp.moveaxis(seg(wss), 0, 1)

        sp.vis[:] = np.asarray(acc_vis * invert_no_zero(counter)).astype(
            sp.vis.dtype
        )
        sp.weight[:] = np.asarray(
            counter**2 * invert_no_zero(acc_var)
        ).astype(sp.weight.dtype)

        # Copy over any additional frequency-filtered datasets (those on
        # input/prod/stack axes are handled above)
        containers.copy_datasets_filter(
            ss,
            sp,
            selection={"freq": freq_ind},
            exclude_axes=("input", "prod", "stack"),
        )

        return sp


class GenerateSubBands(SelectFreq):
    """Generate multiple frequency sub-bands from one container.

    (reference transform.py:436-497)

    Attributes
    ----------
    sub_band_spec : dict
        ``{tag: {<SelectFreq property>: value, ...}, ...}`` — one output
        per entry.
    """

    sub_band_spec = config.dict_prop()

    def setup(self, data):
        """Cache the container to sub-divide."""
        self.data = data
        self.base_tag = data.attrs.get("tag", None)
        self._pending = list(self.sub_band_spec)

    def process(self):
        """Emit the next sub-band."""
        from ..core.task import PipelineStopIteration

        if not self._pending:
            raise PipelineStopIteration

        tag = self._pending.pop(0)
        self._configure_band(self.sub_band_spec[tag])
        self.data.attrs["tag"] = (
            tag if self.base_tag is None else f"{self.base_tag}_{tag}"
        )
        return super().process(self.data)

    def _configure_band(self, spec):
        """Reset every SelectFreq property, then apply this band's spec."""
        for key, prop in vars(SelectFreq).items():
            if isinstance(prop, config.Property):
                setattr(self, key, spec.get(key, prop._default_value()))


class ElevationDependentHybridVisWeight(ContainerTask):
    """Broadcast hybrid-vis weights over the elevation axis.

    (reference transform.py:500-532)
    """

    def process(self, data):
        if "elevation_vis_weight" in data:
            self.log.debug("Requested dataset already present; leaving it in place.")
        else:
            weights = np.asarray(data["vis_weight"][:])
            del data["vis_weight"]
            data.add_dataset("elevation_vis_weight")
            data.weight[:] = np.broadcast_to(
                weights[..., np.newaxis, :], data.weight.shape
            ).astype(data.weight.dtype)
        return data


def _clone_for_pol(polcont, pol_labels):
    """Clone a container with a new pol axis, mirroring its datasets."""
    out = containers.empty_like(polcont, pol=np.array(pol_labels))
    known = out.dataset_spec()
    for name in polcont.datasets:
        if name not in out.datasets and name in known:
            out.add_dataset(name)
    return out


class SelectPol(ContainerTask):
    """Extract Stokes parameters from beamformed data.

    (reference transform.py:1068-1231).  Supports I, Q, U, V from linear
    polarisations XX, YY, reXY, imXY.

    Attributes
    ----------
    pol : list
        Subset of ["I", "Q", "U", "V"].
    """

    pol = config.list_prop()

    # Stokes parameter -> {instrumental pol: sign} recipe
    P = {
        "I": {"XX": 1, "YY": 1},
        "Q": {"XX": 1, "YY": -1},
        "U": {"reXY": 1},
        "V": {"imXY": 1},
    }

    def setup(self):
        """Validate the requested polarisations."""
        unknown = set(self.pol) - set(self.P)
        if unknown:
            raise ValueError(
                f"Cannot form {sorted(unknown)}; supported selections are "
                f"{list(self.P)}."
            )
        if len(set(self.pol)) != len(self.pol):
            raise ValueError("`pol` lists the same Stokes parameter twice.")

    def _combine_pol(self, name, arr, pax, input_pol, kind):
        """Combine the pol axis of one dataset into the requested Stokes.

        kind: 'data' (signed sum / N), 'weight' (inverse-variance
        composition with a joint positivity flag), or 'other'.
        """
        at = lambda i: (slice(None),) * pax + (i,)  # noqa: E731
        out_shape = arr.shape[:pax] + (len(self.pol),) + arr.shape[pax + 1:]
        out = np.zeros(out_shape, dtype=arr.dtype)
        boolean = np.issubdtype(arr.dtype, np.bool_)

        for oo, stokes in enumerate(self.pol):
            recipe = self.P[stokes]
            nsum = len(recipe)
            dst = out[at(oo)]
            live = np.ones(dst.shape, dtype=bool)

            for pname, sign in recipe.items():
                row = arr[at(input_pol.index(pname))]
                if kind == "data":
                    dst += sign * row
                elif kind == "weight":
                    live &= row > 0.0
                    dst += np.asarray(invert_no_zero(row))
                elif boolean:
                    dst |= row
                else:
                    dst += row

            if kind == "weight":
                out[at(oo)] = live * nsum**2 * np.asarray(invert_no_zero(dst))
            elif np.issubdtype(arr.dtype, np.integer):
                out[at(oo)] = dst // nsum
            elif boolean:
                pass
            elif "freq_cov" in name:
                out[at(oo)] = dst / nsum**2
            else:
                out[at(oo)] = dst / nsum
        return out

    def process(self, polcont):
        """Extract the requested Stokes parameters."""
        if "pol" not in polcont.index_map:
            raise ValueError(
                f"{type(polcont)} carries no pol axis to select over."
            )
        input_pol = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in polcont.index_map["pol"]
        ]

        needed = {p for stokes in self.pol for p in self.P[stokes]}
        absent = sorted(needed - set(input_pol))
        if absent:
            raise ValueError(
                f"Forming {self.pol} requires polarisations {absent}, "
                f"which the input lacks."
            )

        data_name = getattr(polcont, "_data_dset_name", None)
        weight_name = getattr(polcont, "_weight_dset_name", None)

        outcont = _clone_for_pol(polcont, self.pol)

        for name, dset in polcont.datasets.items():
            if name not in outcont.datasets:
                continue
            out_dset = outcont.datasets[name]
            axis_names = list(dset.attrs["axis"])
            if "pol" not in axis_names:
                out_dset[:] = dset[:]
                continue
            kind = (
                "data"
                if name == data_name
                else "weight" if name == weight_name else "other"
            )
            combined = self._combine_pol(
                name,
                np.asarray(dset[:]),
                axis_names.index("pol"),
                input_pol,
                kind,
            )
            out_dset[:] = combined.astype(out_dset.dtype)

        return outcont


class PolWeightedAverage(ContainerTask):
    """Optimally weighted pseudo-Stokes I from XX and YY.

    (reference transform.py:1234-1330)
    """

    def process(self, polcont):
        """Compute the weighted average over the XX/YY pol axis."""
        from ..ops import tools

        if not hasattr(polcont, "_weight_dset_name"):
            raise TypeError(
                "Input must be a subclass of DataWeightContainer."
            )
        if "pol" not in polcont.index_map:
            raise ValueError(
                f"Input container of type {type(polcont)} has no 'pol' axis."
            )

        input_pol = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in polcont.index_map["pol"]
        ]
        try:
            ixx = input_pol.index("XX")
            iyy = input_pol.index("YY")
        except ValueError:
            raise ValueError(
                "Stokes I needs the XX and YY polarisations present."
            ) from None

        # slice picking exactly the XX and YY entries of the pol axis
        step = abs(iyy - ixx)
        first = min(ixx, iyy)
        copol = slice(first, first + step + 1, step)

        def pol_axis_of(axis_names):
            axis = list(axis_names).index("pol")
            return axis, (slice(None),) * axis + (copol,)

        outcont = _clone_for_pol(polcont, ["I"])

        waxis = polcont.weight.attrs["axis"]
        wpax, wslc = pol_axis_of(waxis)

        weight = np.asarray(polcont.weight[:])[wslc]
        wsum = weight.sum(axis=wpax, keepdims=True)
        outcont.weight[:] = wsum.astype(outcont.weight.dtype)
        norm = np.asarray(invert_no_zero(wsum))

        for name, dset in polcont.datasets.items():
            if name == polcont._weight_dset_name or name not in outcont.datasets:
                continue
            target = outcont.datasets[name]
            if "pol" not in dset.attrs["axis"]:
                target[:] = dset[:]
                continue
            pax, dslc = pol_axis_of(dset.attrs["axis"])
            wexp = tools.broadcast_weights(waxis, dset.attrs["axis"])
            averaged = (
                weight[wexp] * np.asarray(dset[:])[dslc]
            ).sum(axis=pax, keepdims=True) * norm[wexp]
            target[:] = averaged.astype(target.dtype)

        return outcont


class StokesIVis(ContainerTask):
    """Extract instrumental Stokes I from visibilities.

    (reference transform.py:1333-1448)
    """

    def setup(self, telescope):
        """Set the telescope object."""
        self.telescope = io.get_telescope(telescope)

    def process(self, data):
        """Combine co-pol baselines into Stokes I (shrinks the stack axis)."""
        vis, weight, baselines = stokes_I(data, self.telescope)
        out = containers.empty_like(data, stack=baselines)
        out.vis[:] = np.asarray(vis).astype(out.vis.dtype)
        out.weight[:] = np.asarray(weight).astype(out.weight.dtype)
        return out


def stokes_I(sstream, tel):
    """Extract instrumental Stokes I from a time/sidereal stream.

    (reference transform.py:1382-1448).  The per-product accumulation is a
    device segment-sum over unique baseline vectors.

    Returns (vis_I [freq, nbase, time], weight_I, ubase [nbase, 2]).
    """
    # Group stacks by their (rounded) baseline vector; complex packing
    # gives a single sortable key per 2-vector
    key = np.around(tel.baselines @ np.array([1.0, 1.0j]), 4)
    uniq, uinv, ucount = np.unique(
        key, return_inverse=True, return_counts=True
    )
    ubase = np.stack([uniq.real, uniq.imag], axis=-1)
    nbase = ubase.shape[0]

    pairs = tel.uniquepairs
    pol_a, pol_b = tel.polarisation[pairs].T
    # co-pol stacks whose baseline group has all four pol products
    good = (
        (pol_a == pol_b)
        & (ucount[uinv] >= 4)
        & (tel.feedmap[pairs[:, 0], pairs[:, 1]] != -1)
    )

    src = np.flatnonzero(good)
    dst = uinv[src]

    ssv = tools.as_device(sstream.vis[:])
    ssw = jnp.asarray(np.asarray(sstream.weight[:]))

    def seg(x):
        return jnp.moveaxis(
            jax.ops.segment_sum(
                jnp.moveaxis(x[:, src], 1, 0),
                jnp.asarray(dst),
                num_segments=nbase,
            ),
            0,
            1,
        )

    return seg(ssv), seg(ssw), ubase


class TransformJanskyToKelvin(ContainerTask):
    """Convert visibilities between Jy and Kelvin units.

    (reference transform.py:1451-1603).  Integrates the primary beam solid
    angle from the telescope model.

    Attributes
    ----------
    convert_Jy_to_K : bool
        Direction of the conversion.
    reference_declination : float
        Flux reference declination in degrees (default: zenith).
    share : "none" | "all"
        Whether to copy the container before modifying.
    nside : int
        Healpix resolution for the beam-area integral.
    """

    convert_Jy_to_K = config.bool_prop(True)
    reference_declination = config.float_prop(None)
    share = config.enum(["none", "all"], default="all")
    nside = config.int_prop(256)

    def setup(self, telescope):
        """Set the telescope object."""
        self.telescope = io.get_telescope(telescope)
        if self.reference_declination is None:
            self.reference_declination = self.telescope.latitude
        self._omega_cache = {}

    def _beam_area(self, feed, freq_ind):
        """Primary beam solid angle normalised at the reference declination."""
        from ..ops import healpix

        beam = np.asarray(self.telescope.beam(feed, freq_ind, self.nside))
        horizon = self.telescope.horizon_mask(self.nside)
        if beam.ndim == 2:
            beam_pow = np.sum(np.abs(beam) ** 2, axis=-1) * horizon
        else:
            beam_pow = np.abs(beam) ** 2 * horizon

        pxarea = 4 * np.pi / beam_pow.shape[0]
        omega = beam_pow.sum() * pxarea

        ref_pix = int(
            np.asarray(
                healpix.ang2pix(
                    self.nside,
                    np.radians(90.0 - self.reference_declination),
                    0.0,
                )
            ).reshape(-1)[0]
        )
        omega *= float(np.asarray(invert_no_zero(beam_pow[ref_pix])))
        return float(omega)

    def _omega_per_pair(self, sstream, freqs):
        """sqrt(omega_i * omega_j) per (freq, prodstack) entry.

        Solid angles are cached per (beamclass, freq); only one feed per
        beamclass is ever integrated.
        """
        tel = self.telescope
        pairs = sstream.prodstack
        bc = tel.beamclass[
            np.stack([pairs["input_a"], pairs["input_b"]], axis=-1)
        ]

        channel = {f: int(np.argmin(np.abs(tel.frequencies - f))) for f in freqs}
        # one representative feed index per beamclass
        flat_feeds = np.stack(
            [pairs["input_a"], pairs["input_b"]], axis=-1
        ).ravel()
        rep = dict(zip(bc.ravel(), flat_feeds))
        for klass, feed in rep.items():
            for f, fi in channel.items():
                if (klass, f) not in self._omega_cache:
                    self._omega_cache[(klass, f)] = self._beam_area(feed, fi)

        lookup = np.vectorize(
            lambda klass, f: self._omega_cache[(klass, f)]
        )
        om = np.empty((len(freqs), len(pairs)))
        for fi, f in enumerate(freqs):
            om[fi] = np.sqrt(lookup(bc[:, 0], f) * lookup(bc[:, 1], f))
        return om

    def process(self, sstream):
        """Apply the conversion to the data and weights."""
        kB = 1.380649e-23
        freqs = np.asarray(sstream.freq)

        om_ij = self._omega_per_pair(sstream, freqs)
        wavelength = (C_LIGHT / (freqs * 1e6))[:, np.newaxis, np.newaxis]
        K_to_Jy = 2 * 1e26 * kB * om_ij[:, :, np.newaxis] / wavelength**2
        Jy_to_K = np.asarray(invert_no_zero(K_to_Jy))

        out = sstream if self.share == "all" else sstream.copy()
        d_fac, w_fac = (
            (Jy_to_K, K_to_Jy) if self.convert_Jy_to_K else (K_to_Jy, Jy_to_K)
        )
        out.vis[:] = (np.asarray(out.vis[:]) * d_fac).astype(out.vis.dtype)
        out.weight[:] = (np.asarray(out.weight[:]) * w_fac**2).astype(
            out.weight.dtype
        )
        return out


class MixData(ContainerTask):
    """Mix containers with specified linear coefficients.

    (reference transform.py:1606-1797).  Useful for signal injection,
    jackknives, weight replacement, etc.  No normalisation is applied.

    Attributes
    ----------
    data_coeff, weight_coeff : list
        Per-input coefficients for the data / weight datasets.
    tag_coeff : list
        Which input tags contribute to the output tag.
    aux_coeff : dict
        ``{dataset_name: [coefficients]}`` for auxiliary datasets.
    invert_weight : bool
        Mix variances instead of inverse variances.
    require_nonzero_weight : bool
        Zero the output weight wherever any input weight was zero.
    """

    data_coeff = config.list_type(float)
    weight_coeff = config.list_type(float)
    tag_coeff = config.list_type(bool)
    aux_coeff = config.dict_prop({})
    invert_weight = config.bool_prop(False)
    require_nonzero_weight = config.bool_prop(False)

    mixed_data = None

    def setup(self):
        """Validate coefficient lists."""
        if len(self.data_coeff) != len(self.weight_coeff):
            raise config.ConfigError(
                "One weight coefficient is needed per data coefficient."
            )
        self._data_ind = 0
        self._tags = []
        self._wfunc = invert_no_zero if self.invert_weight else (lambda x: x)

    def _start_mix(self, data):
        """Zero-initialised accumulator shaped like the first input."""
        acc = containers.empty_like(data)
        targets = ["data", "weight", *self.aux_coeff]
        for key in targets:
            if key in ("data", "weight"):
                ds = getattr(acc, key)
            else:
                if key not in acc.datasets:
                    acc.add_dataset(key)
                ds = acc.datasets[key]
            ds[:] = np.zeros(ds.shape, dtype=ds.dtype)
        if self.require_nonzero_weight:
            self._flag = np.ones(acc.weight.shape, dtype=bool)
        return acc

    def _accumulate(self, target, coeff, values):
        if coeff != 0.0:
            target[:] = np.asarray(target[:]) + coeff * np.asarray(values)

    def process(self, data):
        """Add one container into the mix."""
        step = self._data_ind
        if step >= len(self.data_coeff):
            raise RuntimeError(
                "This task cannot accept more items than there are "
                "coefficients set."
            )

        if self.mixed_data is None:
            self.mixed_data = self._start_mix(data)
        acc = self.mixed_data

        if type(acc) is not type(data):
            raise TypeError(
                f"Mixed containers disagree: {type(data)} vs "
                f"type(data_stack) (={type(acc)})"
            )
        if tuple(acc.data.shape) != tuple(data.data.shape):
            raise ValueError(
                f"Mixed datasets disagree in shape: {data.data.shape} vs "
                f"{acc.data.shape}"
            )

        self._accumulate(acc.data, self.data_coeff[step], data.data[:])
        wco = self.weight_coeff[step]
        if wco != 0.0:
            self._accumulate(
                acc.weight, wco, self._wfunc(np.asarray(data.weight[:]))
            )
            if self.require_nonzero_weight:
                self._flag &= np.asarray(data.weight[:]) > 0.0
        for key, coeffs in self.aux_coeff.items():
            self._accumulate(acc.datasets[key], coeffs[step], data.datasets[key][:])

        take_tag = self.tag_coeff is None or self.tag_coeff[step]
        if take_tag and "tag" in data.attrs:
            self._tags.append(data.attrs["tag"])

        self._data_ind = step + 1

    def _make_output(self):
        if self._data_ind != len(self.data_coeff):
            raise RuntimeError(
                f"Mixing ended early: {self._data_ind} inputs arrived but "
                f"{len(self.data_coeff)} coefficients were configured."
            )
        data = self.mixed_data
        self.mixed_data = None

        final_w = np.asarray(data.weight[:])
        if self.require_nonzero_weight:
            final_w = final_w * self._flag
            self._flag = None
        data.weight[:] = np.asarray(self._wfunc(final_w)).astype(
            data.weight.dtype
        )
        data.attrs["tag"] = "_".join(self._tags)
        return data

    def process_finish(self):
        """Return the mixed container."""
        return self._make_output()


class Jackknife(MixData):
    """Half-difference jackknife of two datasets (reference transform.py:1800)."""

    data_coeff = config.list_type(float, default=[0.5, -0.5])
    weight_coeff = config.list_type(float, default=[0.25, 0.25])
    tag_coeff = config.list_type(bool, default=[True, True])
    invert_weight = config.bool_prop(True)
    require_nonzero_weight = config.bool_prop(True)


class MixTwoDatasets(MixData):
    """Mix exactly two datasets per iteration (reference transform.py:1814)."""

    data_coeff = config.list_type(float, 2)
    weight_coeff = config.list_type(float, 2)
    tag_coeff = config.list_type(bool, 2)

    def process(self, data1, data2):
        """Combine the two inputs and emit the result immediately."""
        for d in (data1, data2):
            super().process(d)
        out = self._make_output()
        self._data_ind = 0
        self._tags = []
        return out

    def process_finish(self):
        """No-op: outputs are emitted per iteration."""
        return None


class Downselect(io.SelectionsMixin, ContainerTask):
    """Apply axis selections to every dataset of a container.

    (reference transform.py:1848-1901).  Selections use the SelectionsMixin
    syntax (``<axis>_range`` / ``<axis>_index``) plus ``<axis>_map`` for
    selection by index-map value.
    """

    _sel_extra_suffixes = ("_map",)

    def process(self, data):
        """Apply the downselections."""
        sel = self._resolve_sel()

        # Also support selection by index-map entry
        if self.selections:
            for k, v in self.selections.items():
                if k.endswith("_map"):
                    axis_name = k[: -len("_map")]
                    imap = list(data.index_map[axis_name])
                    sel[axis_name] = [imap.index(x) for x in v]

        output_axes = {}
        for ax, ax_sel in sel.items():
            imap = np.asarray(data.index_map[ax])
            output_axes[ax] = (
                imap[ax_sel]
                if isinstance(ax_sel, slice)
                else imap[np.asarray(ax_sel)]
            )

        out = data.__class__(
            axes_from=data, attrs_from=data, skip_datasets=True, **output_axes
        )
        containers.copy_datasets_filter(data, out, selection=sel)
        return out


class ReduceBase(ContainerTask):
    """Weighted reduction across named axes (reference transform.py:1904).

    Non-functional without overriding :meth:`reduction`.  At least one axis
    must be excluded from the reduction.

    Attributes
    ----------
    axes : list
        Axis names to reduce over.
    dataset : str
        Dataset name to reduce.
    weighting : "none" | "masked" | "weighted"
    """

    axes = config.list_prop()
    dataset = config.str_prop()
    weighting = config.enum(["none", "masked", "weighted"], default="none")

    _op = None

    def process(self, data):
        """Apply the reduction; reduced axes collapse to length 1."""
        out = self._make_output_container(data)
        out.add_dataset(self.dataset)

        ds = data.datasets[self.dataset]
        ds_axes = list(ds.attrs["axis"])

        weight, w_axes = self._get_weights(data)
        if weight is not None:
            wslc = tuple(slice(None) if ax in w_axes else None for ax in ds_axes)
            weight = np.asarray(weight)[wslc]
        else:
            weight = np.ones(ds.shape, dtype=np.float32)
            wslc = None
        weight = np.broadcast_to(weight, ds.shape)

        apply_over = tuple(ds_axes.index(ax) for ax in self.axes if ax in ds_axes)

        reduced, reduced_weight = self.reduction_device(
            np.asarray(ds[:]), weight, apply_over
        )

        from ..ops.tools import device_to_numpy

        out[self.dataset][:] = device_to_numpy(reduced).astype(
            out[self.dataset].dtype
        )

        if hasattr(out, "weight"):
            rw = device_to_numpy(reduced_weight)
            if wslc is not None:
                owslc = tuple(0 if ws is None else ws for ws in wslc)
                rw = rw[owslc]
            out.weight[:] = rw.astype(out.weight.dtype)

        return out

    def _get_weights(self, data):
        """Weights for the reduction (reference transform.py:2016)."""
        if hasattr(data, "weight"):
            return data.weight[:], list(data.weight.attrs["axis"])
        if self.weighting != "none":
            raise RuntimeError(
                "Weighted/masked averaging needs a weight dataset, which is absent."
            )
        return None, None

    def _make_output_container(self, data):
        """Same container type with the reduced axes collapsed to one entry."""
        collapsed = {}
        for ax in self.axes:
            collapsed[ax] = np.asarray(data.index_map[ax])[:1]
        out = data.__class__(
            axes_from=data, attrs_from=data, skip_datasets=True, **collapsed
        )
        out.attrs.update(
            reduced=True,
            reduction_axes=np.array(self.axes),
            reduced_dataset=self.dataset,
            reduction_op=self._op,
        )
        for wname in ("weight", "vis_weight"):
            if wname in data.datasets:
                out.add_dataset(wname)
                break
        return out

    def reduction(self, arr, weight, axis):
        """Override to implement the reduction operation."""
        raise NotImplementedError

    def reduction_device(self, arr, weight, axis):
        """Run :meth:`reduction` as ONE jitted device program.

        Driver for every caller (the process() path above and
        analysis/dayenu.py's per-group loop).
        """
        from ..ops.tools import as_device

        # One jitted callable per reduction axis, cached on the instance:
        # a fresh jax.jit(lambda ...) per call would discard the compiled
        # executable every time, so dayenu's per-group loop (and repeat
        # process() calls) would retrace — and recompile on a persistent
        # -cache miss — for identical shapes (round-4 advisor finding).
        cache = self.__dict__.setdefault("_reduction_jit_cache", {})
        jitted = cache.get(axis)
        if jitted is None:
            jitted = jax.jit(partial(self.reduction, axis=axis))
            cache[axis] = jitted
        return jitted(as_device(arr), jnp.asarray(np.asarray(weight)))

    def _weighted_mean(self, arr, weight, axis):
        """Weighted mean + summed weight, on device."""
        arr = jnp.asarray(arr)
        weight = jnp.asarray(weight)
        ws = jnp.sum(weight, axis=axis, keepdims=True)
        mu = jnp.sum(weight * arr, axis=axis, keepdims=True) * invert_no_zero(ws)
        return arr, weight, ws, mu


class ReduceVar(ReduceBase):
    """Weighted variance over the given axes (reference transform.py:2065)."""

    _op = "variance"

    def reduction(self, arr, weight, axis):
        if self.weighting == "none":
            v = jnp.var(jnp.asarray(arr), axis=axis, keepdims=True)
            return v, jnp.ones_like(v)

        if self.weighting == "masked":
            weight = (jnp.asarray(weight) > 0).astype(jnp.float32)

        arr, weight, ws, mu = self._weighted_mean(arr, weight, axis)
        # (arr - mu)**2, NOT |arr - mu|**2: for complex data the
        # reference stores the complex pseudo-variance
        # (transform.py:2087); ReduceChisq below uses the magnitude form
        v = jnp.sum(
            weight * (arr - mu) ** 2, axis=axis, keepdims=True
        ) * invert_no_zero(ws)
        return v, ws


class ReduceChisq(ReduceBase):
    """Chi-squared per dof assuming weights are inverse noise variance.

    (reference transform.py:2092)
    """

    _op = "chisq_per_dof"

    def reduction(self, arr, weight, axis):
        arr = jnp.asarray(arr)
        weight = jnp.asarray(weight)
        dof = jnp.sum(weight > 0, axis=axis, keepdims=True) - 1
        dof = jnp.maximum(dof, 0).astype(arr.real.dtype)
        _, _, _, mu = self._weighted_mean(arr, weight, axis)
        resid2 = jnp.abs(arr - mu) ** 2
        chisq = jnp.sum(weight * resid2, axis=axis, keepdims=True)
        return chisq * invert_no_zero(dof), dof


class _InverseStackRedundancyWeights(ReduceBase):
    """Weights that undo redundancy averaging (reference transform.py:2120)."""

    def _get_weights(self, data):
        if "stack" not in data.index_map:
            raise RuntimeError(
                "Weight calculation needs a 'stack' entry in the index map."
            )
        from ..ops import tools as _tools

        counts = _tools.calculate_redundancy(
            np.asarray(data.input_flags[:]),
            np.asarray(data.index_map["prod"][:]),
            np.asarray(data.reverse_map["stack"]["stack"][:]),
            len(data.index_map["stack"]),
        )
        descaled = np.asarray(invert_no_zero(counts**2))[np.newaxis]
        return (
            np.asarray(data.weight[:]) * descaled,
            list(data.weight.attrs["axis"]),
        )


class ReduceChisqInverseRedundancy(ReduceChisq, _InverseStackRedundancyWeights):
    """Chi-squared per dof, undoing redundancy averaging."""


class HPFTimeStream(ContainerTask):
    """High-pass filter a timestream (reference transform.py:2146).

    Solves for a low-pass model in a truncated Fourier basis and subtracts
    it.  The per-row Wiener solves (reference transform.py:2230-2251) run as
    one batched device solve.

    Attributes
    ----------
    tau : float
        Timescale in seconds below which fluctuations are kept (i.e.
        fluctuations slower than tau are removed).
    pad : float
        Implicit zero-padding in multiples of tau (edge-effect mitigation).
    window : bool
        Apply a Blackman window to the basis.
    prior : float
        Expected scale of the slow fluctuations (regulariser).
    """

    tau = config.float_prop()
    pad = config.float_prop(2)
    window = config.bool_prop(True)
    prior = config.float_prop(1e2)

    def process(self, tstream):
        if "time" != tuple(tstream.data.attrs["axis"])[-1]:
            raise TypeError("The dataset must end with its 'time' axis.")
        if tuple(tstream.data.shape) != tuple(tstream.weight.shape):
            raise ValueError("Weights do not match the data shape.")

        tau = 2 * self.tau if self.window else self.tau

        times = np.asarray(tstream.time)
        dt = np.diff(times)
        if not np.allclose(dt, dt[0], atol=1e-4):
            self.log.warning(
                "Irregular sample spacing detected; results may degrade."
            )

        span = 2 * tau + times[-1] - times[0]
        nmodes = int(np.ceil(span / tau))
        low_freqs = np.arange(-nmodes, nmodes) / span

        F = np.exp(2.0j * np.pi * np.outer(times, low_freqs))
        if self.window:
            F = F * np.blackman(2 * nmodes)

        d = np.asarray(tstream.data[:])
        w = np.asarray(tstream.weight[:])
        dflat = d.reshape(-1, len(times))
        wflat = w.reshape(-1, len(times))

        from ..ops.tools import as_device, device_to_numpy

        filtered = device_to_numpy(
            _hpf_rows(
                as_device(dflat),
                jnp.asarray(wflat.astype(np.float64)),
                as_device(F),
                self.prior,
            )
        )
        tstream.data[:] = filtered.reshape(d.shape).astype(tstream.data.dtype)
        return tstream


@jax.jit
def _hpf_rows(d, w, F, prior):
    """Batched low-pass solve + subtract for :class:`HPFTimeStream`."""
    Fh = F.conj().T
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    mu = jnp.sum(d * w, axis=-1, keepdims=True) * invert_no_zero(wsum)
    dd = d - mu

    dirty = jnp.einsum("mt,rt->rm", Fh, dd * w)
    Ci = jnp.einsum("mt,rt,tn->rmn", Fh, w.astype(F.dtype), F)
    Ci = Ci + jnp.eye(F.shape[1], dtype=F.dtype) / prior**2

    f_lpf = jnp.linalg.solve(Ci, dirty[..., None])[..., 0]
    t_lpf = jnp.einsum(
        "tm,rm->rt", F.real, f_lpf.real
    ) - jnp.einsum("tm,rm->rt", F.imag, f_lpf.imag)
    out = dd - t_lpf
    # Rows with no valid data are left unchanged (minus nothing)
    return jnp.where(wsum > 0, out, d)
