"""Group, regrid and stack timestreams into sidereal days.

Re-provides reference ``draco/analysis/sidereal.py`` (SiderealGrouper:27,
SiderealRegridder:160 with GP:281/nearest:362/linear:386/cubic:464 variants,
SiderealRebinner:550, RebinGradientCorrection:734, SiderealStacker:834,
SiderealStackerMatch:1082).

Device notes: the Lanczos regrid runs on the batched banded-Wiener kernel
(ops.banded); the interpolation variants are fully vectorised gathers; the
streaming stacker keeps the West (1979) update (reference
sidereal.py:986-1015) with device-side arithmetic.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..core import config, containers, io
from ..core.containers import concatenate_tod, empty_like
from ..core.task import ContainerTask
from ..ops import regrid
from ..ops import tools as ops_tools
from ..ops.tools import invert_no_zero
from .transform import LanczosRegridder

# Speed of light in m / (MHz * s) consistency: lambda[m] = C / f[MHz]
C_MHZ_M = 299.792458


def _ensure_list(x):
    return list(x) if hasattr(x, "__iter__") else [x]


def get_slice_to_broadcast(weight_axis, dataset_axis):
    """Slice broadcasting the weights against a dataset (reference :1253)."""
    assert len(weight_axis) <= len(dataset_axis)
    assert all(wax in tuple(dataset_axis) for wax in weight_axis)
    common = [ax for ax in dataset_axis if ax in tuple(weight_axis)]
    assert all(wax == dax for wax, dax in zip(weight_axis, common))
    return tuple(slice(None) if ax in tuple(weight_axis) else None for ax in dataset_axis)


class SiderealGrouper(ContainerTask):
    """Group individual timestreams into whole sidereal days.

    (reference sidereal.py:27-157)
    """

    padding = config.float_prop(0.0)
    offset = config.float_prop(0.0)
    min_day_length = config.float_prop(0.10)

    def __init__(self):
        super().__init__()
        self._group = []
        self._group_day = None

    def setup(self, manager):
        self.observer = io.get_telescope(manager)

    def _day_of(self, unix_time, pad):
        """Integer LSD containing ``unix_time`` padded by ``pad`` seconds."""
        return int(self.observer.unix_to_lsd(unix_time + pad - self.offset))

    def process(self, tstream):
        first_day = self._day_of(tstream.time[0], -self.padding)
        last_day = self._day_of(tstream.time[-1], self.padding)
        if self._group_day is None:
            self._group_day = first_day
        if first_day == self._group_day:
            self._group.append(tstream)
        self.log.info("Grouping another file under LSD %i", first_day)

        if last_day <= self._group_day:
            return None
        # the file crossed into a new day: the running group is complete
        self.log.info("Joining the collected files of LSD %i", self._group_day)
        finished = self._assemble()
        self._group = [tstream]
        self._group_day = last_day
        return finished

    def process_finish(self):
        return self._assemble() if self._group else None

    def _assemble(self):
        day = self._group_day
        files = self._group
        self._group = []
        span = (
            self.observer.unix_to_lsd(files[0].time[0]),
            self.observer.unix_to_lsd(files[-1].time[-1]),
        )
        if min(span[1], day + 1) - max(span[0], day) < self.min_day_length:
            return None
        self.log.info("Assembling LSD %i from %i files", day, len(files))
        out = concatenate_tod(files)
        out.attrs.update(tag=f"lsd_{day:d}", lsd=day)
        return out


class SiderealRegridder(LanczosRegridder):
    """Regrid a sidereal day onto a regular RA grid.

    (reference sidereal.py:160-278); ML inverse Lanczos via the batched
    banded Wiener filter, with optional fringe-rate down-mixing.
    """

    down_mix = config.bool_prop(False)

    def process(self, data):
        self.log.info(f"Regrid of LSD {data.attrs['lsd']}")
        data.redistribute("freq")
        self.start = float(data.attrs["lsd"])
        self.end = self.start + 1

        if "time" in data.index_map:
            source_samples = self.observer.unix_to_lsd(data.time)
        elif "ra" in data.index_map:
            source_samples = self.start + data.ra / 360.0
        else:
            raise TypeError(
                f"Invalid input data container {data.__class__.__name__}."
            )

        weight = np.asarray(data.weight[:]).copy()
        vis_data = np.asarray(data.vis[:]).copy()

        if self.down_mix:
            self.log.info("Fringe-rate down-mix applied ahead of the regrid.")
            freq = data.freq
            phase = self._get_phase(freq, data.prodstack, source_samples)
            vis_data = vis_data * phase

        new_grid, sts, ni = self._regrid(vis_data, weight, source_samples)
        sts = np.asarray(sts)
        ni = np.asarray(ni)

        if self.down_mix:
            phase = self._get_phase(freq, data.prodstack, new_grid).conj()
            sts = sts * phase
            ni = ni * (np.abs(phase) > 0.0).astype(ni.dtype)

        sdata = containers.SiderealStream(
            attrs_from=data, axes_from=data, ra=self.samples
        )
        sdata.vis[:] = sts.astype(sdata.vis.dtype)
        sdata.weight[:] = ni.astype(sdata.weight.dtype)
        sdata.attrs.update(lsd=self.start, tag=f"lsd_{self.start:.0f}")
        return sdata

    def _get_phase(self, freq, prod, lsd):
        """Zenith fringe-rate sinusoid (reference sidereal.py:255-278)."""
        tel = self.observer
        mask = tel.feedmask[prod["input_a"], prod["input_b"]]
        # east-west fringe rate of the zenith-pointing phase centre, in
        # rad per sidereal turn, per (freq, baseline)
        u_ew = np.outer(np.asarray(freq) / C_MHZ_M, tel.baselines[:, 0])
        omega = -2.0 * np.pi * u_ew * np.cos(np.radians(tel.latitude))
        turns = 2.0 * np.pi * np.mod(np.asarray(lsd), 1.0)
        return (
            mask.astype(np.float32)[None, :, None]
            * np.exp(-1.0j * omega[..., None] * turns)
        )


def _search_nearest(x, xeval):
    """Index of the element of sorted ``x`` nearest each value in ``xeval``."""
    right = np.clip(np.searchsorted(x, xeval), 0, x.size - 1)
    left = np.clip(right - 1, 0, None)
    return np.where(
        np.abs(xeval - x[left]) < np.abs(x[right] - xeval), left, right
    )


def _apply_stencil(vis, weight, x, grid, taps, coeffs, invalid, reach):
    """Shared gather-and-combine core of the stencil regridders.

    One engine serves nearest/linear/cubic: each variant supplies its
    tap indices ``taps`` [T, ngrid] (already clipped into range), tap
    weights ``coeffs`` [T, ngrid], and a precomputed ``invalid`` column
    mask for stencils that ran off the domain.  The engine adds the
    distance rule — any tap farther than ``reach`` median input
    spacings from its target zeroes that column — combines the variance
    through the stencil, and requires every tap to be unflagged.
    """
    spacing = np.median(np.abs(np.diff(x)))
    dead = invalid | (np.abs(x[taps] - grid[None]) > reach * spacing).any(
        axis=0
    )

    flagged = weight > 0.0
    var = invert_no_zero(weight)
    out_shape = (*vis.shape[:-1], grid.size)
    out_vis = np.zeros(out_shape, dtype=vis.dtype)
    out_var = np.zeros(out_shape, dtype=np.float64)
    out_ok = np.ones(out_shape, dtype=bool)
    for tap, cc in zip(taps, coeffs):
        out_vis += cc * vis[..., tap]
        out_var += cc**2 * var[..., tap]
        out_ok &= flagged[..., tap]
    out_weight = invert_no_zero(out_var) * (out_ok & ~dead)
    return out_vis, out_weight.astype(np.float32)


class _StencilRegridder(SiderealRegridder):
    """Base for the fixed-stencil (nearest/linear/cubic) regridders."""

    #: max tap distance from the target, in median input spacings
    reach = 1.0

    def _stencil(self, x, grid):
        """Return (taps [T, ngrid], coeffs [T, ngrid], invalid [ngrid])."""
        raise NotImplementedError()

    def _regrid(self, vis, weight, lsd):
        grid = np.linspace(
            self.start, self.end, self.samples, endpoint=False
        )
        taps, coeffs, invalid = self._stencil(np.asarray(lsd), grid)
        out_vis, out_weight = _apply_stencil(
            vis, weight, lsd, grid, taps, coeffs, invalid, self.reach
        )
        return grid, out_vis, out_weight


class SiderealRegridderNearest(_StencilRegridder):
    """Nearest-neighbour regridding (reference sidereal.py:362)."""

    def _stencil(self, x, grid):
        pick = _search_nearest(x, grid)
        return pick[None], np.ones((1, grid.size)), np.zeros(grid.size, bool)


class SiderealRegridderLinear(_StencilRegridder):
    """Linear-interpolation regridding (reference sidereal.py:386).

    Vectorised over all leading axes (the reference loops over freq).
    """

    def _stencil(self, x, grid):
        hi = np.searchsorted(x, grid)
        invalid = (hi == 0) | (hi == x.size)
        hi = np.clip(hi, 1, x.size - 1)
        lo = hi - 1
        span = invert_no_zero(x[hi] - x[lo])
        return (
            np.stack([lo, hi]),
            np.stack([(x[hi] - grid) * span, (grid - x[lo]) * span]),
            invalid,
        )


class SiderealRegridderCubic(_StencilRegridder):
    """Cubic Hermite (Catmull-Rom) spline regridding (reference :464)."""

    reach = 2.0

    def _stencil(self, x, grid):
        taps = np.searchsorted(x, grid)[None] + np.arange(-2, 2)[:, None]
        invalid = ((taps < 0) | (taps >= x.size)).any(axis=0)
        taps = np.clip(taps, 0, x.size - 1)
        u = (grid - x[taps[1]]) * invert_no_zero(x[taps[2]] - x[taps[1]])
        # Catmull-Rom basis at spline parameter u
        coeffs = 0.5 * np.stack(
            [
                u * ((2 - u) * u - 1),
                u * u * (3 * u - 5) + 2,
                u * ((4 - 3 * u) * u + 1),
                u * u * (u - 1),
            ]
        )
        return taps, coeffs, invalid


class SiderealRegridderGP(SiderealRegridder):
    """Regrid with Gaussian-process regression (reference sidereal.py:281).

    Uses a Matern-5/2 kernel; the per-frequency masked solves run as one
    batched device solve (see :mod:`draco_tpu.ops.gaussian_process`).

    Attributes
    ----------
    mask_cutoff : float
        Max distance (input samples) from the nth nearest valid input to
        keep an output sample.  Default 1.7.
    mask_cutoff_partition : int
        Which nearest sample (0-indexed) the cutoff applies to.
    """

    mask_cutoff = config.float_prop(1.7)
    mask_cutoff_partition = config.int_prop(1)

    def _regrid(self, vis, weight, times):
        from ..ops import gaussian_process
        from ..ops.delay import _inv_move_front, _move_front

        pad = 5 * self.kernel_width
        grid = np.arange(-pad, self.samples + pad, dtype=np.float64) / self.samples

        times = times - self.start

        vx = _move_front(vis, (0, vis.ndim - 1), vis.shape)
        wx = _move_front(weight, (0, weight.ndim - 1), weight.shape)
        # [nfreq * ntime, rest] -> [nfreq, ntime, rest]
        vx = vx.reshape(vis.shape[0], vis.shape[-1], -1)
        wx = wx.reshape(weight.shape[0], weight.shape[-1], -1)

        kernel_spec = dict(
            name="matern",
            width=self.kernel_width,
            alpha=1.0,
            nu=2.5,
            epsilon=self.epsilon,
        )

        vout, wout = gaussian_process.resample(
            vx,
            wx,
            xi=times,
            xo=grid,
            cutoff_dist=self.mask_cutoff,
            cutoff_partition=self.mask_cutoff_partition,
            kernel_spec=kernel_spec,
        )

        grid = grid[pad:-pad].copy()
        vout = vout[:, pad:-pad].reshape(vis.shape[0], -1)
        wout = wout[:, pad:-pad].reshape(weight.shape[0], -1)
        vout = _inv_move_front(
            vout, (0, vis.ndim - 1), (*vis.shape[:-1], self.samples)
        )
        wout = _inv_move_front(
            wout, (0, weight.ndim - 1), (*weight.shape[:-1], self.samples)
        )

        return grid * (self.end - self.start) + self.start, vout, wout


class SiderealRebinner(SiderealRegridder):
    """Rebin a sidereal day by fractional bin assignment.

    (reference sidereal.py:550-731): tracks the weighted effective RA bin
    centre for the downstream gradient correction.
    """

    weight = config.enum(["uniform", "inverse_variance"], default="inverse_variance")

    # output container per input type, most specific first
    _output_types = (
        (containers.HybridVisStream, containers.HybridVisStream),
        (containers.TimeStream, containers.SiderealStream),
        (containers.SiderealStream, containers.SiderealStream),
    )

    def process(self, data):
        self.log.info(
            f"Rebin of LSD {data.attrs['lsd']:.0f} ({self.weight} weights)."
        )
        for in_type, out_type in self._output_types:
            if isinstance(data, in_type):
                break
        else:
            raise TypeError(f"No valid container mapping for {data.__class__}.")

        data.redistribute("freq")
        self.start = float(data.attrs["lsd"])
        self.end = self.start + 1

        if "ra" in data.index_map:
            timestamp_lsd = self.start + data.ra / 360.0
        else:
            timestamp_lsd = self.observer.unix_to_lsd(data.time)

        sdata = out_type(ra=self.samples, axes_from=data, attrs_from=data)
        sdata.add_dataset("effective_ra")
        sdata.add_dataset("nsample")

        weight = np.asarray(data.weight[:])
        vis_data = np.asarray(data.vis[:])
        # the weight dataset may have fewer axes than vis (e.g.
        # HybridVisStream's vis_weight has no 'el'): align by NAME so
        # broadcasting never pairs unrelated axes
        vax = list(data.vis.axes)
        wax = list(data.weight.axes)
        to_vis = tuple(slice(None) if ax in wax else None for ax in vax)

        width_t = np.median(np.abs(np.diff(timestamp_lsd)))
        target_lsd = np.linspace(self.start, self.end, self.samples, endpoint=False)
        R = regrid.rebin_matrix(timestamp_lsd, target_lsd, width_t=width_t)
        Rt = R.T  # [ntime, nra]
        Rtsq = Rt**2

        m = (weight > 0.0).astype(np.float32)
        if self.weight == "uniform":
            v = invert_no_zero(weight)
            w = m
        else:
            v = weight
            w = weight

        norm = invert_no_zero(w @ Rt)
        ssv = norm[to_vis] * ((vis_data * w[to_vis]) @ Rt)
        ssn = m @ Rt
        effective_lsd = norm * ((timestamp_lsd * w) @ Rt)
        sera = 360 * (effective_lsd - self.start)
        rvar = v @ Rtsq
        ssw = invert_no_zero(norm**2 * rvar)

        # Correct effective ra where weights are zero (avoid discontinuities)
        imask = ssw == 0.0
        grid_ra = np.broadcast_to(sdata.ra, sera.shape)
        sera = np.where(imask, grid_ra, sera)

        sdata.vis[:] = ssv.astype(sdata.vis.dtype)
        sdata.weight[:] = ssw.astype(sdata.weight.dtype)
        sdata.datasets["nsample"][:] = ssn.astype(
            sdata.datasets["nsample"].dtype
        )
        sdata.datasets["effective_ra"][:] = sera.astype(np.float32)

        # Carry every auxiliary dataset through the rebin (reference
        # sidereal.py:624-666): weighted mean with the same norm;
        # freq_cov quadratically (one weight/norm factor per freq axis).
        handled = {
            data.vis.name,
            data.weight.name,
            "vis",
            "weight",
            "vis_weight",
            "nsample",
            "effective_ra",
        }
        for name, ds in data.datasets.items():
            if name in handled or name not in sdata.dataset_spec():
                continue
            arr = np.asarray(ds[:])
            if name not in sdata.datasets:
                sdata.add_dataset(name)
            axes_d = list(ds.axes)
            if "ra" not in axes_d and "time" not in axes_d:
                sdata.datasets[name][:] = arr
                continue
            if "freq_cov" in name:
                # axes [pol, freq, freq_sum, ew, ra]: each freq axis
                # carries its own weight and normalisation factor
                new = (
                    norm[:, :, None]
                    * norm[:, None]
                    * ((arr * w[:, :, None] * w[:, None]) @ Rtsq)
                )
            elif set(wax) <= set(axes_d):
                to_d = tuple(
                    slice(None) if ax in wax else None for ax in axes_d
                )
                new = norm[to_d] * ((arr * w[to_d]) @ Rt)
            else:
                # no compatible weight: plain (mask-free) mean rebin
                uni = invert_no_zero(
                    np.ones(arr.shape[-1], arr.real.dtype) @ Rt
                )
                new = uni * (arr @ Rt)
            sdata.datasets[name][:] = new.astype(sdata.datasets[name].dtype)
        sdata.attrs.update(lsd=self.start, tag=f"lsd_{self.start:.0f}")
        return sdata


class RebinGradientCorrection(ContainerTask):
    """Shift rebinned samples to bin centres using a local gradient.

    (reference sidereal.py:734-831)
    """

    def setup(self, sstream_ref: containers.SiderealStream):
        self.sstream_ref = sstream_ref

    def process(self, sstream: containers.SiderealStream):
        self.sstream_ref.redistribute("freq")
        sstream.redistribute("freq")

        if "effective_ra" not in sstream.datasets:
            self.log.info(
                f"Dataset of type ({type(sstream)}) has no effective_ra "
                "dataset. No correction will be applied."
            )
            return sstream
        era = np.asarray(sstream.datasets["effective_ra"][:])

        if "effective_ra" in self.sstream_ref.datasets:
            ref_ra = np.asarray(self.sstream_ref.datasets["effective_ra"][:])
        else:
            ref_ra = self.sstream_ref.ra

        vis = np.asarray(sstream.vis[:]).copy()
        weight = np.asarray(sstream.weight[:]).copy()
        ref_vis = np.asarray(self.sstream_ref.vis[:])
        ref_weight = np.asarray(self.sstream_ref.weight[:])

        # flatten every leading axis into one row loop
        nra = vis.shape[-1]
        rows = zip(
            vis.reshape(-1, nra),
            weight.reshape(-1, nra),
            era.reshape(-1, nra),
            ref_vis.reshape(-1, nra),
            ref_weight.reshape(-1, nra),
            (
                ref_ra.reshape(-1, nra)
                if np.ndim(ref_ra) > 1
                else itertools.repeat(ref_ra)
            ),
        )
        for v_row, w_row, e_row, rv_row, rw_row, rra_row in rows:
            if not w_row.any():
                continue
            grad, bad = regrid.grad_1d(
                rv_row, rra_row, rw_row == 0.0, period=360.0
            )
            v_row -= grad * (w_row > 0.0) * (e_row - sstream.ra)
            w_row *= ~bad

        sstream.vis[:] = vis.astype(sstream.vis.dtype)
        sstream.weight[:] = weight.astype(sstream.weight.dtype)
        del sstream["effective_ra"]
        return sstream


class SiderealStacker(ContainerTask):
    """Streaming mean/variance stack of sidereal days.

    (reference sidereal.py:834-1079): West (1979) running update; optional
    sample-variance dataset with Bessel correction.
    """

    tag = config.str_prop("stack")
    weight = config.enum(["uniform", "inverse_variance"], default="inverse_variance")
    with_sample_variance = config.bool_prop(False)

    stack = None

    def _begin(self, sdata):
        """Zero-filled stack container + broadcast slices, from day one."""
        self.stack = empty_like(sdata)
        stack_ds = self.stack.datasets
        if "nsample" not in stack_ds:
            self.stack.add_dataset("nsample")
        if self.with_sample_variance and "sample_variance" not in stack_ds:
            self.stack.add_dataset("sample_variance")

        wax = sdata.weight.axes
        self.weight_slice = {"vis": get_slice_to_broadcast(wax, sdata.vis.axes)}
        # datasets beyond the container defaults ride along; frequency
        # covariances accumulate QUADRATICALLY — one coefficient per
        # freq axis (reference sidereal.py:922-926,1052-1058), finished
        # with a (norm_i * norm_j)^-1 normalisation in process_finish; a
        # running mean would overestimate an N-day stack's covariance ~N
        self.additional_datasets = [
            name for name in sdata.datasets if name not in stack_ds
        ]
        for name in self.additional_datasets:
            self.log.info(f"Creating {name} dataset in the stack.")
            self.stack.add_dataset(name)
            slc = get_slice_to_broadcast(wax, sdata.datasets[name].axes)
            if "freq_cov" in name:
                slc = (
                    slc,
                    get_slice_to_broadcast(wax, sdata.swapped_freq_cov_axis),
                )
            self.weight_slice[name] = slc

        for ds in stack_ds.values():
            ds[:] = np.zeros(ds.shape, dtype=ds.dtype)
        self.lsd_list = []
        if self.with_sample_variance:
            self.sum_coeff_sq = np.zeros(
                self.stack.weight.shape, dtype=np.float32
            )

    def process(self, sdata):
        if self.stack is None:
            self._begin(sdata)
        elif not isinstance(sdata, type(self.stack)):
            raise TypeError(
                f"Stacker input {type(sdata)} differs from the existing "
                f"stack type {type(self.stack)}."
            )

        input_lsd = _ensure_list(
            sdata.attrs.get("lsd", sdata.attrs.get("csd", -1))
        )
        self.log.info(
            f"Folding LSD {input_lsd} into the stack ({self.weight} weights)."
        )
        self.lsd_list += input_lsd

        weight = np.asarray(sdata.weight[:])
        if "nsample" in sdata.datasets:
            count = np.asarray(sdata.nsample[:]) * (weight > 0.0)
        else:
            count = (weight > 0.0).astype(self.stack.nsample.dtype)

        # The running West-update state lives in device HBM across days
        # (SURVEY section 2.5: per-day accumulation as donated-buffer
        # jitted updates); each day moves on once and the stack
        # materialises on the host only in process_finish.
        if getattr(self, "_dev", None) is None:
            import jax.numpy as jnp

            shape = self.stack.vis.shape
            self._dev = {
                "vis": ops_tools.as_device(
                    np.zeros(shape, dtype=np.complex64)
                ),
                "weight": jnp.zeros(self.stack.weight.shape, jnp.float32),
                "nsample": jnp.zeros(self.stack.nsample.shape, jnp.float32),
                "scs": jnp.zeros(self.stack.weight.shape, jnp.float32),
                "sv": ops_tools.as_device(
                    np.zeros(
                        (3, *shape) if self.with_sample_variance else (0,),
                        dtype=np.float32,
                    )
                ),
            }
            self._update_fn = _build_stack_update(
                self.weight_slice["vis"],
                uniform=(self.weight == "uniform"),
                with_var=self.with_sample_variance,
            )

        d = self._dev
        out = self._update_fn(
            d["vis"],
            d["weight"],
            d["nsample"],
            d["scs"],
            d["sv"],
            ops_tools.as_device(np.asarray(sdata.vis[:])),
            ops_tools.as_device(weight.astype(np.float32)),
            ops_tools.as_device(count.astype(np.float32)),
        )
        (d["vis"], d["weight"], d["nsample"], d["scs"], d["sv"],
         coeff_dev, inv_dev) = out

        if self.additional_datasets:
            # rare datasets of arbitrary dtype stay host-side; fetch the
            # device-computed coefficients once per day, not per dataset
            coeff = ops_tools.device_to_numpy(coeff_dev)
            inv_sum_coeff = ops_tools.device_to_numpy(inv_dev)
        for name in self.additional_datasets:
            ws = self.weight_slice[name]
            st = np.asarray(self.stack[name][:])
            if "freq_cov" in name:
                new = st + coeff[ws[0]] * coeff[ws[1]] * np.asarray(
                    sdata[name][:]
                )
            else:
                delta = coeff[ws] * (np.asarray(sdata[name][:]) - st)
                new = st + delta * inv_sum_coeff[ws]
            self.stack[name][:] = new.astype(self.stack[name].dtype)

    def process_finish(self):
        self.stack.attrs["tag"] = self.tag
        self.stack.attrs["lsd"] = np.array(self.lsd_list)

        # materialise the device-resident running state
        d = getattr(self, "_dev", None)
        if d is not None:
            self.stack.vis[:] = ops_tools.device_to_numpy(d["vis"]).astype(
                self.stack.vis.dtype
            )
            self.stack.weight[:] = np.asarray(d["weight"]).astype(
                self.stack.weight.dtype
            )
            self.stack.nsample[:] = np.asarray(d["nsample"]).astype(
                self.stack.nsample.dtype
            )
            self.sum_coeff_sq = np.asarray(d["scs"])
            if self.with_sample_variance:
                self.stack.sample_variance[:] = ops_tools.device_to_numpy(
                    d["sv"]
                ).astype(self.stack.sample_variance.dtype)
            self._dev = None

        st_weight = np.asarray(self.stack.weight[:])
        if self.weight == "uniform":
            norm = np.asarray(self.stack.nsample[:]).astype(np.float32)
            self.stack.weight[:] = (
                invert_no_zero(st_weight) * norm**2
            ).astype(self.stack.weight.dtype)
        else:
            norm = st_weight

        if self.with_sample_variance:
            norm_b = norm - self.sum_coeff_sq * invert_no_zero(norm)
            wslc = (None, *self.weight_slice["vis"])
            sv = np.asarray(self.stack.sample_variance[:])
            sv *= np.where(
                np.asarray(self.stack.nsample[:]) > 1,
                invert_no_zero(norm_b),
                0.0,
            )[wslc]
            self.stack.sample_variance[:] = sv

        # finish the quadratic covariance accumulation
        for name in getattr(self, "additional_datasets", []):
            if "freq_cov" in name:
                ws = self.weight_slice[name]
                fc = np.asarray(self.stack[name][:])
                fc = fc * invert_no_zero(norm[ws[0]] * norm[ws[1]])
                self.stack[name][:] = fc.astype(self.stack[name].dtype)

        # For samples with no data, effective ra falls back to the grid ra
        if "effective_ra" in self.stack.datasets:
            weight = np.asarray(self.stack.weight[:])
            era = np.asarray(self.stack.datasets["effective_ra"][:])
            grid_ra = np.broadcast_to(self.stack.ra, era.shape)
            era = np.where(weight == 0.0, grid_ra, era)
            self.stack.datasets["effective_ra"][:] = era.astype(np.float32)

        return self.stack


def _build_stack_update(wslc, uniform: bool, with_var: bool):
    """Jitted donated-buffer West (1979) update for SiderealStacker.

    The running (vis, weight, nsample, sum-coeff-sq, sample-variance)
    state stays in device HBM; each sidereal day is folded in by one
    XLA program (reference sidereal.py:940-1014 recomputes this chain
    in host numpy per day).  Without sample variance the ``sv`` slot
    carries a zero-size placeholder through the same single body.
    """
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
    def update(st_vis, st_weight, st_nsample, scs, sv, vis, weight, count):
        st_nsample = st_nsample + count
        if uniform:
            coeff = count
            st_weight = st_weight + coeff**2 * invert_no_zero(weight)
            sum_coeff = st_nsample
        else:
            coeff = weight
            st_weight = st_weight + weight
            sum_coeff = st_weight
        inv = invert_no_zero(sum_coeff)
        delta_before = coeff[wslc] * (vis - st_vis)
        st_vis = st_vis + delta_before * inv[wslc]
        scs = scs + coeff**2
        if with_var:
            delta_after = vis - st_vis
            sv = sv + jnp.stack(
                [
                    delta_before.real * delta_after.real,
                    delta_before.real * delta_after.imag,
                    delta_before.imag * delta_after.imag,
                ]
            )
        return st_vis, st_weight, st_nsample, scs, sv, coeff, inv

    return update


def _match_stack_update(st_vis, st_weight, d, weight):
    """One day of Wiener-matched stacking, on device (donated state).

    Jitted once at module level so repeated days reuse one executable.
    """
    global _match_stack_update_jit
    try:
        up = _match_stack_update_jit
    except NameError:
        import functools

        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def up(st_vis, st_weight, d, weight):
            Ni_d = weight.mean(axis=1)  # [freq, ra]
            tr_Ni = Ni_d.sum(axis=1)
            v = Ni_d * invert_no_zero(tr_Ni[:, None]) ** 0.5
            st_vis = st_vis + (
                d * Ni_d[:, None, :]
                - v[:, None, :] * jnp.matmul(d, v[:, :, None].astype(d.dtype))
            )
            st_weight = (
                st_weight + invert_no_zero(weight) * Ni_d[:, None, :] ** 2
            )
            return st_vis, st_weight, Ni_d, v

        _match_stack_update_jit = up
    return up(st_vis, st_weight, d, weight)


def _match_stack_finish(st_vis, st_weight, Ni_s64, Va64):
    """Crosstalk-marginalised deconvolution, batched over frequency.

    ``M = I - V^T Ni V`` is structurally singular (the undetermined
    per-day mean mode); its pinv MUST truncate that mode.  In f32 the
    mode's singular value is roundoff at ~1e-7 sigma_max — ABOVE an
    rcond of 1e-8 — so the pinv would invert it and amplify the mode by
    ~1e7.  M is tiny ([nfreq, nday, nday]) and its inputs live on the
    host in f64 already, so the pinv runs there faithfully; only the
    large vis/weight correction applies on device.
    """
    import numpy as _np

    nday = Va64.shape[-1]
    N_s64 = np.asarray(invert_no_zero(Ni_s64))  # [f, ra]
    V64 = Va64 * N_s64[:, :, None]  # [f, ra, nday]
    M = _np.eye(nday)[None] - _np.einsum(
        "frd,fr,fre->fde", V64, Ni_s64, V64
    )
    A64 = _np.linalg.pinv(M, rcond=1e-8)

    global _match_stack_finish_jit
    try:
        fin = _match_stack_finish_jit
    except NameError:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def fin(sv, sw, Ni_s, N_s, V, A):
            Vc = V.astype(sv.dtype)
            X = jnp.einsum("fsr,frd->fsd", sv, Vc)
            Y = jnp.einsum("fde,fse->fds", A.astype(sv.dtype), X)
            sv = sv * N_s[:, None, :] + jnp.einsum("frd,fds->fsr", Vc, Y)
            sw = invert_no_zero(sw) * (Ni_s**2)[:, None, :]
            return sv, sw

        _match_stack_finish_jit = fin
    import jax.numpy as jnp

    return fin(
        st_vis,
        st_weight,
        jnp.asarray(Ni_s64.astype(np.float32)),
        jnp.asarray(N_s64.astype(np.float32)),
        jnp.asarray(V64.astype(np.float32)),
        jnp.asarray(A64.astype(np.float32)),
    )


class SiderealStackerMatch(ContainerTask):
    """Wiener-matched stacking marginalising per-day crosstalk.

    (reference sidereal.py:1082-1250): each day's unknown time-mean is
    treated as extra noise; the final deconvolution fixes the undetermined
    mean mode by zeroing the 24h median.
    """

    tag = config.str_prop("stack")

    stack = None
    lsd_list = None
    count = 0

    def _begin(self, sdata):
        """Fresh zeroed stack plus the per-day mode bookkeeping."""
        self.log.info("Starting new stack.")
        self.stack = empty_like(sdata)
        for ds in self.stack.datasets.values():
            ds[:] = np.zeros(ds.shape, dtype=ds.dtype)
        nfreq, _, nra = sdata.weight.shape
        self.Ni_s = np.zeros((nfreq, nra), dtype=np.float64)
        self.Vm = []
        self.lsd_list = []
        self.count = 0

    def process(self, sdata):
        if self.stack is None:
            self._begin(sdata)
        elif not isinstance(sdata, type(self.stack)):
            raise TypeError(
                f"Stacker input {type(sdata)} differs from the existing "
                f"stack type {type(self.stack)}."
            )

        label = sdata.attrs.get("tag", f"stream_{self.count}")
        self.log.info(f"Adding {label} to stack.")

        # Device-resident running state: per-day mean-marginalised
        # accumulation runs as one donated jitted program (see
        # SiderealStacker); only the small [freq, ra] mode vectors come
        # back per day for the final deconvolution.
        if getattr(self, "_dev", None) is None:
            import jax.numpy as jnp

            self._dev = {
                "vis": ops_tools.as_device(
                    np.zeros(self.stack.vis.shape, dtype=np.complex64)
                ),
                "weight": jnp.zeros(self.stack.weight.shape, jnp.float32),
            }

        d_dev = ops_tools.as_device(np.asarray(sdata.vis[:]))
        w_dev = ops_tools.as_device(
            np.asarray(sdata.weight[:]).astype(np.float32)
        )
        out = _match_stack_update(
            self._dev["vis"], self._dev["weight"], d_dev, w_dev
        )
        self._dev["vis"], self._dev["weight"], Ni_d_dev, v_dev = out
        Ni_d = np.asarray(Ni_d_dev, dtype=np.float64)
        v = np.asarray(v_dev, dtype=np.float64)

        self.Ni_s += Ni_d
        self.Vm.append(v)

        # Track effective RA bin centres through the stack (reference
        # sidereal.py:1168-1177, with the broadcasting written out: the
        # reference multiplies [freq, ra] against [freq, stack, ra]
        # directly, which only works when nfreq == nstack).  The running
        # weight sum is mirrored on the host so the per-day update never
        # fetches the device accumulator.
        if "effective_ra" in sdata.datasets:
            w_day = np.asarray(sdata.weight[:], dtype=np.float64)
            if "effective_ra" not in self.stack.datasets:
                self.stack.add_dataset("effective_ra")
                self.stack.datasets["effective_ra"][:] = 0.0
                self._wsum_host = np.zeros(w_day.shape, np.float64)
            self._wsum_host += invert_no_zero(w_day) * (
                Ni_d[:, None, :] ** 2
            )
            era = np.asarray(
                self.stack.datasets["effective_ra"][:], dtype=np.float64
            )
            delta = Ni_d[:, None, :] * (
                np.asarray(sdata.datasets["effective_ra"][:]) - era
            )
            sum_weight = invert_no_zero(self._wsum_host) * (
                self.Ni_s[:, None, :] ** 2
            )
            era += delta * invert_no_zero(sum_weight.mean(axis=1))[:, None, :]
            self.stack.datasets["effective_ra"][:] = era.astype(np.float32)

        self.lsd_list.extend(
            _ensure_list(sdata.attrs.get("lsd", sdata.attrs.get("csd", -1)))
        )
        self.count += 1

    def process_finish(self):
        self.stack.attrs["tag"] = self.tag
        Va = np.array(self.Vm).transpose(1, 2, 0)  # [freq, ra, nday]

        # batched deconvolution over all frequencies at once (the
        # reference runs a per-frequency host pinv loop)
        sv_dev, sw_dev = _match_stack_finish(
            self._dev["vis"], self._dev["weight"], self.Ni_s, Va
        )
        self._dev = None
        sv = ops_tools.device_to_numpy(sv_dev)
        sw = np.asarray(sw_dev)

        stack_median = np.median(sv.real, axis=2) + 1.0j * np.median(sv.imag, axis=2)
        sv = sv - stack_median[:, :, np.newaxis]
        self.stack.vis[:] = sv.astype(self.stack.vis.dtype)
        self.stack.weight[:] = sw.astype(self.stack.weight.dtype)
        self.stack.attrs["lsd"] = np.array(self.lsd_list)
        return self.stack
