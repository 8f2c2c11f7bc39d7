"""Delay-space spectrum estimation and filtering tasks.

Re-provides reference ``draco/analysis/delay.py`` (DelayFilter:29,
DelayFilterBase:156, DelayTransformBase:347, container mixins :675-873,
DelaySpectrumBase:874, DelaySpectrumFFT:960, DelaySpectrumWienerFilter:982,
DelaySpectrumToPowerSpectrum:1061, DelayPowerSpectrumBase:1114,
DelayPowerSpectrumGibbs:1218, DelayPowerSpectrumNRML:1270,
DelayCrossPowerSpectrumEstimator:1304).

Device design: when the retained frequency mask is uniform across baselines
(the common case after MaskFreq-style flagging) the Gibbs chains of every
baseline advance together in a single batched device kernel
(:func:`draco_tpu.ops.delay.delay_power_spectrum_gibbs_batched`); ragged
masks fall back to the per-baseline path.
"""

from __future__ import annotations

import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask, RandomTask
from ..ops import filters
from ..ops import tools
from ..ops.delay import (
    _inv_move_front,
    _move_front,
    _take_view,
    delay_power_spectrum_gibbs,
    delay_power_spectrum_gibbs_batched,
    delay_spectrum_fft,
    delay_spectrum_gibbs_cross,
    delay_spectrum_gibbs_cross_batched,
    delay_spectrum_wiener_filter,
    flatten_axes,
    match_axes,
)
from .delayopt import delay_power_spectrum_maxpost

C_US = 299.792458  # m / us (c such that baseline[m] / C_US is in us)


def _mode_count(bandwidth: float, cut_us: float) -> int:
    """Fourier modes spanned by a delay cut over a bandwidth (>= 1)."""
    return max(int(4.0 * bandwidth * cut_us + 0.5), 1)


# Per-container defaults for the generic filter: (loop axis, dataset)
_FILTER_DEFAULTS = (
    (containers.SiderealStream, "stack", "vis"),
    (containers.HybridVisMModes, "m", "vis"),
    (containers.RingMap, "el", "map"),
    (containers.GridBeam, "theta", "beam"),
)


def _filter_defaults_for(ss):
    for cls, ax, dset in _FILTER_DEFAULTS:
        if isinstance(ss, cls):
            return ax, dset
    raise ValueError(f"No default filter axes known for {type(ss)}.")


# ---------------------
# Delay filter classes
# ---------------------


class DelayFilter(ContainerTask):
    """Project out delays below a cut (reference delay.py:29-153).

    Attributes
    ----------
    delay_cut : float
        Delay cut in microseconds.
    za_cut : float
        Sine of max zenith angle for the baseline-dependent cut.
    extra_cut : float
        Additional delay threshold beyond the baseline term.
    weight_tol : float
        (Kept for API parity.)
    telescope_orientation : 'NS' | 'EW' | 'none'
        Baseline component used for the baseline-dependent cut.
    window : bool
        Apply the window function while filtering.
    """

    delay_cut = config.float_prop(0.1)
    za_cut = config.float_prop(1.0)
    extra_cut = config.float_prop(0.0)
    weight_tol = config.float_prop(1e-4)
    telescope_orientation = config.enum(["NS", "EW", "none"], default="NS")
    window = config.bool_prop(False)

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def _horizon_cuts(self, ss):
        """Per-stack delay cuts in microseconds from the array geometry."""
        pairs = ss.prodstack
        pos = self.telescope.feedpositions
        sep = (
            pos[pairs["input_a"].astype(int)]
            - pos[pairs["input_b"].astype(int)]
        )
        component = {
            "NS": lambda s: np.abs(s[:, 1]),
            "EW": lambda s: np.abs(s[:, 0]),
            "none": lambda s: np.linalg.norm(s, axis=1),
        }[self.telescope_orientation]
        horizon = self.za_cut * component(sep) / C_US + self.extra_cut
        return np.maximum(horizon, self.delay_cut)

    def process(self, ss):
        freq = ss.freq[:]
        bandwidth = np.ptp(freq)
        cuts = self._horizon_cuts(ss)

        vis = np.array(ss.vis[:])
        wgt = np.array(ss.weight[:])
        live = wgt > 0.0

        # Keep only channels sampled as often as the best channel of each
        # stack, and only times sampled as often as each stack's best time
        per_chan = live.sum(axis=2)
        chan_keep = (per_chan == per_chan.max(axis=0, keepdims=True)) * 1.0
        per_time = live.sum(axis=0)
        time_keep = (per_time == per_time.max(axis=1, keepdims=True)) * 1.0

        # Redundant arrays share baseline lengths and flag patterns:
        # build ONE null-space projector per unique (cut, channel-mask)
        # group and apply it as a batched matmul, instead of the
        # reference's per-baseline SVD loop (reference delay.py:100-140)
        groups: dict = {}
        for bi in range(vis.shape[1]):
            key = (float(cuts[bi]), chan_keep[:, bi].tobytes())
            groups.setdefault(key, []).append(bi)
        self.log.debug(
            "DelayFilter: %d baselines in %d filter groups",
            vis.shape[1], len(groups),
        )
        for (cut, _), members in groups.items():
            proj = filters.null_filter(
                freq,
                cut,
                chan_keep[:, members[0]],
                num_modes=_mode_count(bandwidth, cut),
                window=self.window,
            )
            sel = np.asarray(members)
            vis[:, sel] = np.einsum("fg,gbt->fbt", proj, vis[:, sel])
        wgt *= chan_keep[:, :, np.newaxis] * time_keep[np.newaxis, :, :]

        ss.vis[:] = vis.astype(ss.vis.dtype)
        ss.weight[:] = wgt.astype(ss.weight.dtype)
        return ss


class DelayFilterBase(ContainerTask):
    """Delay filter over a configurable axis/dataset (reference delay.py:156).

    Attributes
    ----------
    delay_cut : float
        Delay cut in microseconds.
    window : bool
        Apply the window function while filtering.
    axis, dataset : str
        Axis to iterate over and dataset to filter (container defaults).
    """

    delay_cut = config.float_prop(0.1)
    window = config.bool_prop(False)
    axis = config.str_prop(None)
    dataset = config.str_prop(None)

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def _delay_cut(self, ss, axis: str, ind: int) -> float:
        """Delay cut in microseconds for one element of the loop axis."""
        return self.delay_cut

    def _filter_slice(self, vis_2d, wgt_2d, freq, cut, bandwidth):
        """Filter one [freq, flat-rest] slice; returns (filtered, mask)."""
        chan_keep = _best_sampled_mask(wgt_2d, axis=1)
        time_keep = _best_sampled_mask(wgt_2d, axis=0)
        proj = filters.null_filter(
            freq,
            cut,
            chan_keep,
            num_modes=_mode_count(bandwidth, cut),
            window=self.window,
        )
        mask = np.outer(chan_keep, time_keep)
        return proj @ vis_2d, mask

    def process(self, ss):
        if not isinstance(ss, containers.FreqContainer):
            raise TypeError(
                f"A FreqContainer subclass is required here, not {type(ss)}."
            )
        default_ax, default_ds = (
            _filter_defaults_for(ss)
            if self.axis is None or self.dataset is None
            else (None, None)
        )
        loop_axis = self.axis or default_ax
        dset_name = self.dataset or default_ds

        freq = ss.freq[:]
        bandwidth = np.ptp(freq)

        target = ss.datasets[dset_name]
        values = np.array(target[:])
        wgt_full = np.broadcast_to(match_axes(target, ss.weight), values.shape)
        keep_full = np.ones(values.shape, dtype=np.float64)

        layout = list(target.axes)
        loop_pos = layout.index(loop_axis)
        freq_pos = layout.index("freq")
        inner_freq_pos = freq_pos - (1 if freq_pos > loop_pos else 0)

        for bi in range(values.shape[loop_pos]):
            block = _take_view(values, bi, loop_pos)
            block_2d = _move_front(block, inner_freq_pos, block.shape)
            w_block = _take_view(wgt_full, bi, loop_pos)
            w_2d = _move_front(
                np.ascontiguousarray(w_block), inner_freq_pos, w_block.shape
            )
            filtered, mask = self._filter_slice(
                block_2d, w_2d, freq, self._delay_cut(ss, loop_axis, bi),
                bandwidth,
            )
            block[:] = _inv_move_front(filtered, inner_freq_pos, block.shape)
            keep_block = _take_view(keep_full, bi, loop_pos)
            keep_block[:] = _inv_move_front(
                mask, inner_freq_pos, keep_block.shape
            )

        target[:] = values.astype(target.dtype)
        # Reduce the combined mask onto the weight axes and apply it
        waxes = set(ss.weight.axes)
        extra = tuple(i for i, ax in enumerate(layout) if ax not in waxes)
        keep_w = keep_full.min(axis=extra) if extra else keep_full
        ss.weight[:] = (np.asarray(ss.weight[:]) * keep_w).astype(
            ss.weight.dtype
        )
        return ss


def _best_sampled_mask(weight_2d, axis):
    """1.0 where a row/column is sampled as often as the best one."""
    counts = (weight_2d > 0.0).sum(axis=axis)
    return (counts == counts.max()) * 1.0


# -----------------------------
# Delay transform base classes
# -----------------------------


def _spectral_grid(freq, *, zero, spacing, nchan, skip_nyquist, complex_td):
    """(delay axis [us], effective channel indices) for a frequency axis.

    Infers the underlying regular channel grid the samples sit on
    (reference delay.py:461 semantics).
    """
    if complex_td:
        n = len(freq)
        return (
            np.fft.fftshift(np.fft.fftfreq(n, d=spacing)),
            np.arange(n),
        )
    chans = (np.abs(freq - zero) / spacing).astype(np.int64)
    if nchan is None:
        nchan = int(chans[-1]) + 1 + (1 if skip_nyquist else 0)
    ntap = 2 * (nchan - 1)
    return np.fft.fftshift(np.fft.fftfreq(ntap, d=spacing)), chans


class DelayTransformBase(ContainerTask):
    """Base class for frequency -> delay transforms (reference delay.py:347).

    See the reference docstring for the full attribute list; semantics are
    preserved (freq_zero/freq_spacing/nfreq channel-grid inference, window
    choice, complex_timedomain, weight_boost, freq/time pruning fractions,
    mean removal, frequency scaling).
    """

    freq_zero = config.float_prop(None)
    freq_spacing = config.float_prop(None)
    nfreq = config.int_prop(None)
    skip_nyquist = config.bool_prop(True)
    apply_window = config.bool_prop(True)
    window = config.enum(
        [
            "uniform",
            "hann",
            "hanning",
            "hamming",
            "blackman",
            "nuttall",
            "blackman_nuttall",
            "blackman_harris",
        ],
        default="nuttall",
    )
    complex_timedomain = config.bool_prop(False)
    use_average_weights = config.bool_prop(True)
    weight_boost = config.float_prop(1.0)
    freq_frac = config.float_prop(0.0)
    time_frac = config.float_prop(0.0)
    remove_mean = config.bool_prop(True)
    scale_freq = config.bool_prop(False)

    # window name actually applied (recorded in output attrs)
    @property
    def _window_name(self):
        return self.window if self.apply_window else None

    def process(self, ss):
        """Estimate the delay spectrum or power spectrum of the input."""
        delays, chans = self._spectral_axis(ss)
        rows, wrows, coords = self._gather_rows(ss)
        out = self._blank_output(ss, delays, coords)
        out.attrs["window_los"] = str(self._window_name)
        return self._fill_output(rows, wrows, out, delays, chans)

    def _spectral_axis(self, ss):
        """Delay grid + effective channel indices (reference delay.py:461)."""
        if isinstance(ss, containers.FreqContainer):
            freq = ss.freq
        elif len(ss) > 0:
            freq = ss[0].freq
        else:
            raise TypeError("The input carries no freq axis to transform.")
        return _spectral_grid(
            freq,
            zero=freq[0] if self.freq_zero is None else self.freq_zero,
            spacing=(
                np.abs(np.diff(freq)).min()
                if self.freq_spacing is None
                else self.freq_spacing
            ),
            nchan=len(freq) if self.complex_timedomain else self.nfreq,
            skip_nyquist=self.skip_nyquist,
            complex_td=self.complex_timedomain,
        )

    def _trim_block(self, data, weight):
        """Prune dead channels/times + clean data (reference delay.py:516).

        Returns (data, weight, kept_freq, kept_time) or None when nothing
        usable remains.
        """
        ntime, nchan = data.shape[-2:]
        live = weight > 0
        if not live.any():
            return None
        t_occ = live.mean(axis=-1).reshape(-1, ntime).mean(axis=0)
        t_keep = t_occ > self.time_frac
        live = np.compress(t_keep, live, axis=-2)
        f_occ = live.mean(axis=-2).reshape(-1, nchan).mean(axis=0)
        f_keep = f_occ > self.freq_frac
        if not f_keep.any():
            return None
        data = np.compress(f_keep, np.compress(t_keep, data, axis=-2), axis=-1)
        weight = np.compress(
            f_keep, np.compress(t_keep, weight, axis=-2), axis=-1
        )
        if self.remove_mean:
            data = data - data.mean(axis=-2, keepdims=True)
        if not data.any():
            return None
        if self.scale_freq:
            per_chan = data.std(axis=-2)[..., np.newaxis, :]
            overall = data.std(axis=(-1, -2))[..., np.newaxis, np.newaxis]
            data = data * np.asarray(tools.invert_no_zero(per_chan / overall))
        if self.use_average_weights:
            weight = weight.mean(axis=-2)
        return data, weight * self.weight_boost, f_keep, t_keep

    # subclass hooks ---------------------------------------------------
    def _gather_rows(self, ss):
        raise NotImplementedError()

    def _fill_output(self, rows, wrows, out, delays, chans):
        raise NotImplementedError()

    def _blank_output(self, ss, delays, coords):
        raise NotImplementedError()


def _attach_coords(out, source, coords):
    """Copy the flattened coordinate index maps onto an output container."""
    for ax in coords:
        out.create_index_map(ax, source.index_map[ax])
    out.attrs["baseline_axes"] = coords


def _flat_row_count(source, coords) -> int:
    n = 1
    for ax in coords:
        n *= len(source.index_map[ax])
    return n


class GeneralInputContainerMixin:
    """Flatten all non-(sample, freq) axes into a baseline axis.

    (reference delay.py:675)
    """

    dataset = config.str_prop(None)
    sample_axis = config.str_prop("ra")

    def _gather_rows(self, ss):
        ss.redistribute("freq")
        if self.dataset is None:
            target = ss.data
        elif self.dataset in ss.datasets:
            target = ss[self.dataset]
        else:
            raise ValueError(
                f"Specified dataset to delay transform ({self.dataset}) "
                f"missing from container type {type(ss)}."
            )
        if (
            self.sample_axis not in ss.axes_spec()
            or self.sample_axis not in target.axes
        ):
            raise ValueError(
                f"{type(ss)} has no axis named {self.sample_axis!r} "
                f"to average over."
            )
        keep = [self.sample_axis, "freq"]
        rows, coords = flatten_axes(target, keep)
        wrows, _ = flatten_axes(ss.weight, keep, match_dset=target)
        return rows, wrows, coords


class DelayPowerSpectrumContainerMixin(GeneralInputContainerMixin):
    """Create DelaySpectrum outputs (reference delay.py:744)."""

    nsamp = config.int_prop(1)
    save_samples = config.bool_prop(False)
    save_spectrum_mask = config.bool_prop(False)

    def _blank_output(self, ss, delays, coords):
        if isinstance(coords, np.ndarray):
            baseline = coords
        elif len(coords) == 1:
            baseline = ss.index_map[coords[0]]
        else:
            baseline = np.arange(_flat_row_count(ss, coords))
        out = containers.DelaySpectrum(
            baseline=baseline,
            delay=delays,
            sample=self.nsamp,
            attrs_from=ss,
        )
        out.spectrum[:] = 0.0
        if isinstance(coords, list):
            _attach_coords(out, ss, coords)
        for name, wanted in (
            ("spectrum_samples", self.save_samples),
            ("spectrum_mask", self.save_spectrum_mask),
        ):
            if wanted:
                out.add_dataset(name)
        out.attrs["freq"] = ss.freq
        return out


class DelaySpectrumContainerMixin(GeneralInputContainerMixin):
    """Create DelayTransform outputs (reference delay.py:821)."""

    save_spectrum_mask = config.bool_prop(False)

    def _blank_output(self, ss, delays, coords):
        out = containers.DelayTransform(
            baseline=np.arange(_flat_row_count(ss, coords)),
            sample=ss.index_map[self.sample_axis],
            delay=delays,
            attrs_from=ss,
            weight_boost=self.weight_boost,
        )
        out.spectrum[:] = 0.0
        _attach_coords(out, ss, coords)
        if self.save_spectrum_mask:
            out.add_dataset("spectrum_mask")
        out.attrs["freq"] = ss.freq
        return out


# -------------------------------------
# Delay spectrum (transform) tasks
# -------------------------------------


class DelaySpectrumBase(DelaySpectrumContainerMixin, DelayTransformBase):
    """Base for per-baseline delay transforms (reference delay.py:874)."""

    def _fill_output(self, rows, wrows, out, delays, chans):
        nrow = out.spectrum.shape[0]
        priors = self._initial_spectra(nrow, len(delays), delays.dtype)

        spectrum = np.asarray(out.spectrum[:])
        mask_ds = (
            np.asarray(out.datasets["spectrum_mask"][:])
            if self.save_spectrum_mask
            else None
        )
        for bi in range(nrow):
            trimmed = self._trim_block(rows[bi], wrows[bi])
            if trimmed is None:
                if mask_ds is not None:
                    mask_ds[bi] = True
                continue
            block, w, f_keep, t_keep = trimmed
            spectrum[bi, t_keep] = self._row_spectrum(
                block, w, priors[bi], len(delays), chans[f_keep]
            )
            if mask_ds is not None:
                mask_ds[bi][~t_keep] = True

        out.spectrum[:] = spectrum
        if mask_ds is not None:
            out.datasets["spectrum_mask"][:] = mask_ds
        return out

    def _initial_spectra(self, nrow, ndelay, dtype):
        return [None] * nrow

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        raise NotImplementedError()


class DelaySpectrumFFT(DelaySpectrumBase):
    """Delay spectrum via inverse FFT (reference delay.py:960)."""

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        return np.fft.fftshift(
            delay_spectrum_fft(block, ndelay, self._window_name), axes=-1
        )


class DelaySpectrumWienerFilter(DelaySpectrumBase):
    """Delay spectrum via Wiener filtering (reference delay.py:982).

    See arXiv:2202.01242 Eq. A6.
    """

    def setup(self, dps=None):
        self.dps = dps

    def _initial_spectra(self, nrow, ndelay, dtype):
        return np.asarray(self.dps.spectrum[:])

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        filtered = delay_spectrum_wiener_filter(
            np.fft.fftshift(prior),
            block,
            ndelay,
            w,
            window=self._window_name,
            fsel=chans,
            complex_timedomain=self.complex_timedomain,
        )
        return np.fft.fftshift(filtered, axes=-1)


class DelaySpectrumWienerFilterIteratePS(DelaySpectrumWienerFilter):
    """Wiener filter with a per-cycle power spectrum (reference delay.py:1027)."""

    def process(self, ss, dps):
        self.dps = dps
        return super().process(ss)


class DelaySpectrumToPowerSpectrum(ContainerTask):
    """Delay power spectrum = variance of a delay spectrum over samples.

    (reference delay.py:1061)
    """

    def process(self, dspec: containers.DelayTransform) -> containers.DelaySpectrum:
        pspec = containers.DelaySpectrum(attrs_from=dspec, axes_from=dspec)
        ds = np.asarray(dspec.spectrum[:])
        if "spectrum_mask" in dspec.datasets:
            w = ~np.asarray(dspec.datasets["spectrum_mask"][:])[..., np.newaxis]
            pspec.add_dataset("spectrum_mask")
        else:
            w = None
        ps = np.var(ds, axis=1, where=w) if w is not None else np.var(ds, axis=1)
        if w is not None:
            nans = np.isnan(ps)
            ps[nans] = 0.0
            pspec.datasets["spectrum_mask"][:] = np.any(nans, axis=-1)
        pspec.spectrum[:] = ps.real
        return pspec


# ---------------------------------------------------
# Direct delay power spectrum tasks
# ---------------------------------------------------


class DelayPowerSpectrumBase(DelayPowerSpectrumContainerMixin, DelayTransformBase):
    """Base for direct power spectrum estimation (reference delay.py:1114)."""

    def _fill_output(self, rows, wrows, out, delays, chans, subset=None):
        nrow = out.spectrum.shape[0]
        ndelay = len(delays)
        priors = self._initial_spectra(nrow, ndelay, delays.dtype)

        spectrum = np.asarray(out.spectrum[:])
        mask_ds = (
            np.asarray(out.datasets["spectrum_mask"][:])
            if self.save_spectrum_mask
            else None
        )
        samples_ds = (
            np.asarray(out.datasets["spectrum_samples"][:])
            if self.save_samples
            else None
        )

        for bi in range(nrow) if subset is None else subset:
            trimmed = self._trim_block(rows[bi], wrows[bi])
            if trimmed is None:
                if mask_ds is not None:
                    mask_ds[bi] = True
                continue
            block, w, f_keep, _ = trimmed
            spec, draws, converged = self._row_spectrum(
                block, w, priors[bi], ndelay, chans[f_keep]
            )
            spectrum[bi] = spec
            if mask_ds is not None and not converged:
                mask_ds[bi] = True
            if samples_ds is not None and draws:
                samples_ds[:, bi] = 0.0
                samples_ds[-len(draws):, bi] = np.array(
                    [np.fft.fftshift(s) for s in draws]
                )

        out.spectrum[:] = spectrum
        if mask_ds is not None:
            out.datasets["spectrum_mask"][:] = mask_ds
            n_conv = nrow - mask_ds.sum()
            self.log.debug(f"Gibbs converged on {n_conv} of {nrow} valid baselines.")
        if samples_ds is not None:
            out.datasets["spectrum_samples"][:] = samples_ds
        return out

    def _initial_spectra(self, nrow, ndelay, dtype):
        raise NotImplementedError()

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        raise NotImplementedError()


class DelayPowerSpectrumGibbs(DelayPowerSpectrumBase, RandomTask):
    """Gibbs-sampled delay power spectrum (reference delay.py:1218).

    Attributes
    ----------
    initial_amplitude : float
        Flat initial power spectrum amplitude.
    median_frac : float
        Return the median over this final fraction of samples.
    """

    initial_amplitude = config.float_prop(10.0)
    median_frac = config.float_prop(0.5)

    def _initial_spectra(self, nrow, ndelay, dtype):
        return np.full((nrow, ndelay), self.initial_amplitude, dtype=dtype)

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        draws, converged = delay_power_spectrum_gibbs(
            block,
            ndelay,
            w,
            prior,
            window=self._window_name,
            fsel=chans,
            niter=self.nsamp,
            rng=self.rng,
            complex_timedomain=self.complex_timedomain,
        )
        keep = int(self.nsamp * self.median_frac)
        if not draws:
            return prior, draws, False
        spec = np.fft.fftshift(np.median(draws[-keep:], axis=0))
        return spec, draws, converged


def _batch_cut_masks(wmask, time_frac, freq_frac):
    """Batch analogue of ``_trim_block``'s pruning, shared by the batched
    Gibbs estimators: common dead-time pruning, then the per-baseline
    retained-channel criterion against the batch union.

    wmask : bool [nbase, ..., ntime, nfreq] (any number of middle axes).
    Returns (non_zero_time, freq_ok, uniform) or None when nothing
    survives (callers fall back to the per-baseline sampler).
    """
    ntime = wmask.shape[-2]
    non_zero_time = (
        wmask.mean(axis=-1).reshape(-1, ntime).mean(axis=0) > time_frac
    )
    if not non_zero_time.any():
        return None
    wmask_t = wmask[..., non_zero_time, :]
    axes = tuple(range(1, wmask_t.ndim - 1))
    fmask = wmask_t.mean(axis=axes) > freq_frac  # [nbase, nfreq]
    freq_ok = fmask.any(axis=0)
    uniform = (fmask == freq_ok).all(axis=-1) & wmask_t.reshape(
        wmask_t.shape[0], -1
    ).any(axis=-1)
    if not freq_ok.any() or not uniform.any():
        return None
    return non_zero_time, freq_ok, uniform


class DelayPowerSpectrumGibbsBatched(DelayPowerSpectrumGibbs):
    """Batched-Gibbs power spectrum: all chains advance on device together.

    The device fast path: requires the retained frequency mask to be
    identical across baselines (which per-baseline trimming would
    otherwise vary); baselines failing that fall back to the per-baseline
    sampler of the parent class.
    """

    def _fill_output(self, rows, wrows, out, delays, chans):
        if self.scale_freq or not self.use_average_weights:
            # per-baseline semantics that do not batch
            self.log.info(
                "scale_freq / use_average_weights=False configured: "
                "taking the per-baseline sampler."
            )
            return super()._fill_output(rows, wrows, out, delays, chans)

        ndelay = len(delays)

        # Mirror the per-baseline trimming across the batch: common
        # dead-time pruning, then the per-baseline retained-channel
        # criterion — the batch takes the rows whose mask equals the union
        masks = _batch_cut_masks(wrows > 0, self.time_frac, self.freq_frac)
        if masks is None:
            return super()._fill_output(rows, wrows, out, delays, chans)
        non_zero_time, freq_ok, uniform = masks

        # Baselines with their own frequency mask go through the
        # per-baseline sampler (previously they were silently left at
        # zero whenever at least one baseline was batchable)
        rest = np.flatnonzero(~uniform)
        if len(rest):
            self.log.info(
                f"{len(rest)} baselines have non-uniform frequency masks; "
                "sampling them per baseline."
            )
            super()._fill_output(rows, wrows, out, delays, chans, subset=rest)

        sel = np.flatnonzero(uniform)
        data = rows[sel][..., non_zero_time, :][..., freq_ok]
        weight = wrows[sel][..., non_zero_time, :][..., freq_ok]
        if self.remove_mean:
            data = data - data.mean(axis=-2, keepdims=True)
        w = weight.mean(axis=-2) * self.weight_boost

        priors = self._initial_spectra(len(sel), ndelay, delays.dtype)
        draws = delay_power_spectrum_gibbs_batched(
            data,
            ndelay,
            w,
            priors,
            window=self._window_name,
            fsel=chans[freq_ok],
            niter=self.nsamp,
            key=self.next_key(),
            complex_timedomain=self.complex_timedomain,
        )  # [niter, nbase_sel, ndelay]
        keep = int(self.nsamp * self.median_frac)
        spec = np.fft.fftshift(np.median(draws[-keep:], axis=0), axes=-1)

        # jnp.linalg.cholesky does NOT raise on a non-PD system (unlike
        # the scipy path) — it returns NaN.  Detect poisoned chains and
        # mask them instead of writing garbage spectra.
        bad = ~np.isfinite(spec).all(axis=-1)
        bad |= (data.reshape(len(sel), -1) == 0).all(axis=-1)
        if bad.any():
            self.log.warning(
                f"{int(bad.sum())} batched Gibbs chains produced "
                "non-finite spectra; masking them."
            )
            spec = np.where(bad[:, None], 0.0, spec)

        spectrum = np.asarray(out.spectrum[:])
        spectrum[sel] = spec
        out.spectrum[:] = spectrum

        if self.save_samples:
            sd = np.asarray(out.datasets["spectrum_samples"][:])
            sd[-len(draws):, sel] = np.fft.fftshift(draws, axes=-1)
            out.datasets["spectrum_samples"][:] = sd
        if self.save_spectrum_mask:
            md = np.asarray(out.datasets["spectrum_mask"][:])
            md[sel] = bad
            out.datasets["spectrum_mask"][:] = md
        return out


class DelayPowerSpectrumNRML(DelayPowerSpectrumBase):
    """Maximum-likelihood (NRML) power spectrum (reference delay.py:1270)."""

    maxpost_tol = config.float_prop(1e-3)
    nsamp = config.int_prop(100)

    def _initial_spectra(self, nrow, ndelay, dtype):
        return [None] * nrow

    def _row_spectrum(self, block, w, prior, ndelay, chans):
        draws, converged = delay_power_spectrum_maxpost(
            block,
            ndelay,
            w,
            prior,
            window=self._window_name,
            fsel=chans,
            maxiter=self.nsamp,
            tol=self.maxpost_tol,
        )
        return np.fft.fftshift(draws[-1]), draws, converged


class DelayCrossPowerSpectrumEstimator(DelayPowerSpectrumGibbs):
    """Pairwise delay cross-power spectra (reference delay.py:1304)."""

    def _gather_rows(self, sslist):
        if not isinstance(sslist, (list, tuple)):
            sslist = [sslist]
        if len(sslist) == 0:
            raise ValueError("No datasets passed.")
        freq_ref = sslist[0].freq
        all_rows, all_wrows = [], []
        coords = None
        for ss in sslist:
            # ANY mismatched channel invalidates the cross-correlation
            # (a .all() here would pass partially-overlapping axes)
            if len(ss.freq) != len(freq_ref) or (ss.freq != freq_ref).any():
                raise ValueError(
                    "Cross-spectrum inputs disagree on the frequency axis."
                )
            rows, wrows, ca = GeneralInputContainerMixin._gather_rows(self, ss)
            if coords is not None and coords != ca:
                raise ValueError(
                    "Cross-spectrum inputs disagree on their axis layout."
                )
            all_rows.append(rows)
            all_wrows.append(wrows)
            coords = ca
        return all_rows, all_wrows, coords

    def _spectral_axis(self, ss):
        if isinstance(ss, (list, tuple)):
            ss = ss[0]
        return super()._spectral_axis(ss)

    def _blank_output(self, ss, delays, coords):
        first = ss[0] if isinstance(ss, (list, tuple)) else ss
        nstream = len(ss) if isinstance(ss, (list, tuple)) else 1
        baseline = (
            first.index_map[coords[0]]
            if len(coords) == 1
            else np.arange(_flat_row_count(first, coords))
        )
        out = containers.DelayCrossSpectrum(
            baseline=baseline,
            dataset=np.arange(nstream),
            delay=delays,
            sample=self.nsamp,
            attrs_from=first,
        )
        out.spectrum[:] = 0.0
        _attach_coords(out, first, coords)
        if self.save_samples:
            out.add_dataset("spectrum_samples")
        out.attrs["freq"] = first.freq
        return out

    def _fill_output(self, rows, wrows, out, delays, chans, subset=None):
        nstream = len(rows)
        ndelay = len(delays)
        nrow = out.spectrum.shape[-2]
        priors = self._initial_spectra(nrow, ndelay, delays.dtype)
        priors = (
            np.identity(nstream)[np.newaxis, ..., np.newaxis]
            * priors[:, np.newaxis, np.newaxis]
        )

        spectrum = np.asarray(out.spectrum[:])
        samples_ds = (
            np.asarray(out.datasets["spectrum_samples"][:])
            if self.save_samples
            else None
        )

        for bi in range(nrow) if subset is None else subset:
            block = np.array([r[bi] for r in rows])
            w_block = np.array([w[bi] for w in wrows])
            trimmed = self._trim_block(block, w_block)
            if trimmed is None:
                continue
            block, w, f_keep, _ = trimmed
            draws = delay_spectrum_gibbs_cross(
                block,
                ndelay,
                w,
                priors[bi],
                window=self._window_name,
                fsel=chans[f_keep],
                niter=self.nsamp,
                rng=self.rng,
            )
            middle = np.median(draws[-(self.nsamp // 2):], axis=0)
            spectrum[..., bi, :] = np.fft.fftshift(middle.real, axes=-1)
            if samples_ds is not None:
                samples_ds[..., bi, :] = np.fft.fftshift(
                    np.array(draws).real, axes=-1
                )

        out.spectrum[:] = spectrum
        if samples_ds is not None:
            out.datasets["spectrum_samples"][:] = samples_ds
        return out

    def process(self, *sslist):
        """Estimate the cross power spectra of several containers."""
        sslist = list(sslist)
        delays, chans = self._spectral_axis(sslist)
        rows, wrows, coords = self._gather_rows(sslist)
        out = self._blank_output(sslist, delays, coords)
        out.attrs["window_los"] = str(self._window_name)
        return self._fill_output(rows, wrows, out, delays, chans)


class DelayCrossPowerSpectrumEstimatorBatched(DelayCrossPowerSpectrumEstimator):
    """Batched cross-PS Gibbs: all baselines' chains advance on device.

    The device fast path for the cross estimator, mirroring
    :class:`DelayPowerSpectrumGibbsBatched`: baselines whose retained
    frequency mask equals the batch union run as one batched device
    chain (chunked complex Cholesky over the coupled ``nd*N`` system);
    the rest fall back to the per-baseline host sampler.

    Attributes
    ----------
    bchunk : int
        Baselines per device batch (bounds the Cholesky workspace).
    """

    bchunk = config.int_prop(32)

    def _fill_output(self, rows, wrows, out, delays, chans):
        if self.scale_freq or not self.use_average_weights:
            self.log.info(
                "scale_freq / use_average_weights=False configured: "
                "taking the per-baseline sampler."
            )
            return super()._fill_output(rows, wrows, out, delays, chans)

        ndelay = len(delays)
        dv = np.stack(rows, axis=1)  # [nbase, nd, nsample, nfreq]
        wv = np.stack(wrows, axis=1)
        nstream = dv.shape[1]

        # Mirror the per-baseline trimming across the batch (common
        # dead-time pruning, union frequency mask), shared with the auto
        # batched estimator
        masks = _batch_cut_masks(wv > 0, self.time_frac, self.freq_frac)
        if masks is None:
            return super()._fill_output(rows, wrows, out, delays, chans)
        non_zero_time, freq_ok, uniform = masks

        rest = np.flatnonzero(~uniform)
        if len(rest):
            self.log.info(
                f"{len(rest)} baselines have non-uniform frequency masks; "
                "sampling them per baseline."
            )
            super()._fill_output(rows, wrows, out, delays, chans, subset=rest)

        sel = np.flatnonzero(uniform)
        data = dv[sel][..., non_zero_time, :][..., freq_ok]
        weight = wv[sel][..., non_zero_time, :][..., freq_ok]
        if self.remove_mean:
            data = data - data.mean(axis=-2, keepdims=True)
        w = weight.mean(axis=-2) * self.weight_boost  # [bsel, nd, nfreq']

        priors = self._initial_spectra(len(sel), ndelay, delays.dtype)
        coupled = (
            np.identity(nstream)[np.newaxis, ..., np.newaxis]
            * priors[:, np.newaxis, np.newaxis]
        )
        draws = delay_spectrum_gibbs_cross_batched(
            data,
            ndelay,
            w,
            coupled,
            window=self._window_name,
            fsel=chans[freq_ok],
            niter=self.nsamp,
            key=self.next_key(),
            bchunk=self.bchunk,
        )  # [niter, bsel, nd, nd, ndelay]

        keep = int(self.nsamp * self.median_frac)
        spec = np.fft.fftshift(
            np.median(draws[-keep:], axis=0).real, axes=-1
        )  # [bsel, nd, nd, ndelay]

        # The coupled system's condition number is ~1 + S_prior x nfreq
        # x Ni; past ~1e7 it exceeds what an f32 Cholesky can factor
        # (breakdown, surfacing as NaNs — device linalg does not raise).
        # Send those chains through the f64 host sampler instead.
        bad = ~np.isfinite(spec).all(axis=(-3, -2, -1))
        if bad.any():
            self.log.info(
                f"{int(bad.sum())} chains exceed f32 conditioning; "
                "sampling them per baseline in f64."
            )
            spec = np.where(bad[:, None, None, None], 0.0, spec)

        spectrum = np.asarray(out.spectrum[:])
        spectrum[..., sel, :] = np.moveaxis(spec, 0, -2)
        out.spectrum[:] = spectrum

        if self.save_samples:
            good = sel[~bad]
            sd = np.asarray(out.datasets["spectrum_samples"][:])
            sd[-len(draws):][..., good, :] = np.fft.fftshift(
                np.moveaxis(draws.real, 1, -2), axes=-1
            )[..., ~bad, :]
            out.datasets["spectrum_samples"][:] = sd

        if bad.any():
            # the fallback overwrites the zeroed spectra (and samples)
            # of the chains the f32 factorisation could not handle
            super()._fill_output(
                rows, wrows, out, delays, chans, subset=sel[bad]
            )
        return out


class DelayPowerSpectrumStokesIEstimator(DelayPowerSpectrumGibbs):
    """Deprecated (reference delay.py:1451)."""

    def setup(self, requires=None):
        """Raise a deprecation warning."""
        raise DeprecationWarning(
            "DelayPowerSpectrumStokesIEstimator is retained only for "
            "compatibility: form Stokes I explicitly "
            "Use `transform.StokesIVis` to generate Stokes I visibilities, "
            "and run DelayPowerSpectrumGibbs or DelayPowerSpectrumNRML."
        )


class DelayPowerSpectrumGeneralEstimator(DelayPowerSpectrumGibbs):
    """Deprecated (reference delay.py:1464)."""

    def setup(self, requires=None):
        """Raise a deprecation warning."""
        raise DeprecationWarning(
            "DelayPowerSpectrumGeneralEstimator is retained only for "
            "compatibility; prefer DelayPowerSpectrumGibbs or "
            "DelayPowerSpectrumNRML."
        )
