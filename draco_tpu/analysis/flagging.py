"""Flagging of bad or unwanted data: day masks, baseline masks, RFI excision.

Re-provides reference ``draco/analysis/flagging.py`` (3846 LoC — DayMask:33,
MaskMModeData:113, MaskBaselines:176, FindBeamformedOutliers:345,
RadiometerWeight:552, SanitizeWeights:614, NegativeAutosMask:666,
SmoothVisWeight:702, ThresholdVisWeightFrequency:763 /Baseline:835,
CollapseBaselineMask:985, RFISensitivityMask:1808, RFIMask:2120,
ApplyTimeFreqMask:2222, ApplyGenericMask:2380, GeneralCombineMasks:2442,
CombineMasks:2521, ApplyTaper:2542, MaskFreq:2894, BlendStack:3046, and the
mad:3231 / tv_channels_flag:3316 / destripe:3404 helpers).

Masking convention: True marks contaminated samples.
"""

from __future__ import annotations

import re
import warnings
from typing import ClassVar

import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import filters, median, rfi
from ..ops.tools import extract_diagonal, invert_no_zero
from ..ops import tools as ops_tools

STELLAR_S = 86164.0905 / 86400.0


def _pct(mask) -> float:
    """Percentage of True samples in a boolean array."""
    return 100.0 * float(np.mean(mask))


def _rfi_mask_for(stream, by_pol: bool = False):
    """An (optionally per-pol) RFI-mask container on the stream's axes.

    Picks the sidereal variant when the stream carries an ``ra`` axis.
    """
    sid = "ra" in stream.index_map
    if by_pol:
        cls = containers.SiderealRFIMaskByPol if sid else containers.RFIMaskByPol
    else:
        cls = containers.SiderealRFIMask if sid else containers.RFIMask
    return cls(axes_from=stream, attrs_from=stream)


def _writable_copy(data, share: str):
    """The container a weight-editing task should write into.

    ``share="all"`` edits in place; ``"none"`` deep-copies; any other
    value copies with that dataset shared.
    """
    if share == "all":
        return data
    return data.copy() if share == "none" else data.copy(shared=(share,))


def _align_to(arr, src_axes, dst_axes):
    """Reorder ``arr`` (axis names ``src_axes``) to broadcast over ``dst_axes``.

    Transposes the source axes into destination order and inserts
    length-1 dimensions for destination axes the source lacks.
    """
    src_axes = list(src_axes)
    order = tuple(src_axes.index(ax) for ax in dst_axes if ax in src_axes)
    grow = tuple(slice(None) if ax in src_axes else None for ax in dst_axes)
    return arr.transpose(order)[grow]


def _sample_unix_times(stream, observer=None):
    """UNIX timestamps of each sample of a time- or sidereal-stream.

    Sidereal streams need an ``observer`` for the LSD -> unix mapping and
    an ``lsd``/``csd`` day attribute.  Returns ``(times, spans_days)``.
    """
    if "ra" not in stream.index_map:
        return np.asarray(stream.time), False
    if observer is None:
        raise RuntimeError(
            "For sidereal streams, must provide telescope object during setup."
        )
    day = stream.attrs.get("lsd", stream.attrs.get("csd"))
    if day is None:
        raise ValueError(
            "Cannot find a day number (`lsd`/`csd` attribute) on the data."
        )
    many = not np.isscalar(day)
    if many:
        day = np.floor(np.mean(day))
    return observer.lsd_to_unix(day + np.asarray(stream.ra) / 360.0), many


class DayMask(ContainerTask):
    """Mask out a daytime RA band with smooth transitions.

    (reference flagging.py:33-110)
    """

    start = config.float_prop(90.0)
    end = config.float_prop(270.0)
    width = config.float_prop(60.0)
    zero_data = config.bool_prop(True)
    remove_average = config.bool_prop(True)

    @staticmethod
    def _half_cosine(x, width):
        return 0.5 * (1 + np.cos(np.pi * x / width))

    def process(self, sstream):
        sstream.redistribute("freq")
        # angles measured from the band start, so the band is [0, span]
        phase = (sstream.ra[:] - self.start) % 360.0
        span = (self.end - self.start) % 360.0

        is_night = phase > span
        taper = np.where(
            phase < self.width,
            self._half_cosine(phase, self.width),
            is_night,
        )
        leaving = (phase > span - self.width) & (phase <= span)
        taper = np.where(
            leaving, self._half_cosine(phase - span, self.width), taper
        )

        vis = np.asarray(sstream.vis[:])
        if self.remove_average:
            night_only = np.where(is_night, 1.0, np.nan)
            nanvis = vis * night_only[np.newaxis, np.newaxis, :]
            vis = vis - complex_med(nanvis, axis=-1)[:, :, np.newaxis]
        if self.zero_data:
            vis = vis * taper
        sstream.vis[:] = vis.astype(sstream.vis.dtype)
        sstream.weight[:] = (np.asarray(sstream.weight[:]) * taper**2).astype(
            sstream.weight.dtype
        )
        return sstream


class MaskMModeData(ContainerTask):
    """Mask m-mode data ahead of map making (reference flagging.py:113-173)."""

    auto_correlations = config.bool_prop(False)
    m_zero = config.bool_prop(False)
    positive_m = config.bool_prop(True)
    negative_m = config.bool_prop(True)
    mask_low_m = config.int_prop(None)

    def process(self, mmodes):
        mmodes.redistribute("freq")
        mw = np.asarray(mmodes.weight[:]).copy()

        if not self.auto_correlations:
            pairs = mmodes.prodstack
            mw[..., pairs["input_a"] == pairs["input_b"]] = 0.0
        # zero out the configured m / msign regions
        regions = [
            (not self.m_zero, np.s_[0]),
            (not self.positive_m, np.s_[1:, 0]),
            (not self.negative_m, np.s_[1:, 1]),
            (bool(self.mask_low_m), np.s_[: self.mask_low_m]),
        ]
        for enabled, slot in regions:
            if enabled:
                mw[slot] = 0.0

        mmodes.weight[:] = mw.astype(mmodes.weight.dtype)
        return mmodes


# Alias (reference flagging.py:3228)
MaskData = MaskMModeData


class MaskBaselines(ContainerTask):
    """Mask out baselines by length/polarisation/weight (reference flagging.py:176).

    Criteria combine with logical OR (or AND); see the reference docstring
    for the parameter list.
    """

    mask_long_ns = config.float_prop(None)
    mask_short = config.float_prop(None)
    mask_short_ew = config.float_prop(None)
    mask_short_ns = config.float_prop(None)
    mask_pol = config.list_prop(None)
    weight_threshold = config.float_prop(None)
    missing_threshold = config.float_prop(None)
    zero_data = config.bool_prop(False)
    share = config.enum(["none", "vis", "all"], default="all")
    combine_method = config.enum(["and", "or"], default="or")

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)
        if self.zero_data and self.share == "vis":
            raise RuntimeError("Refusing to zero a shared visibility dataset.")

    def process(self, ss):
        ss.redistribute("freq")
        ew, ns = self.telescope.baselines.T
        weight = np.asarray(ss.weight[:])

        # Each enabled criterion contributes one boolean slab; they are
        # then folded together with the configured AND/OR rule.  Most
        # criteria are per-baseline [nstack]; the weight criteria are
        # [nstack, nsample] / [nstack].
        slabs = []
        if self.mask_long_ns is not None:
            slabs.append(np.abs(ns) > self.mask_long_ns)
        if self.mask_short is not None:
            slabs.append(np.hypot(ew, ns) < self.mask_short)
        if self.mask_short_ew is not None:
            slabs.append(np.abs(ew) < self.mask_short_ew)
        if self.mask_short_ns is not None:
            slabs.append(np.abs(ns) < self.mask_short_ns)
        if self.weight_threshold is not None:
            per_sample = weight.sum(axis=0)
            slabs.append(per_sample < self.weight_threshold * len(ss.freq))
        if self.missing_threshold is not None:
            nsamp = np.count_nonzero(weight, axis=-1).sum(axis=0)
            slabs.append(1 - nsamp / nsamp.max() > self.missing_threshold)
        if self.mask_pol is not None:
            names = np.char.array(self.telescope.polarisation)[
                self.telescope.uniquepairs
            ]
            names = names[:, 0] + names[:, 1]
            slabs.extend(names == p for p in self.mask_pol)

        fold = np.logical_or if self.combine_method == "or" else np.logical_and
        mask = np.full(weight.shape[1:], self.combine_method != "or")
        for slab in slabs:
            mask = fold(mask, slab if slab.ndim > 1 else slab[:, np.newaxis])
        mask = np.broadcast_to(mask[np.newaxis], weight.shape)

        out = _writable_copy(ss, self.share)
        out.weight[:] = np.where(mask, 0.0, np.asarray(out.weight[:]))
        if self.zero_data:
            out.vis[:] = np.where(mask, 0.0, np.asarray(out.vis[:]))
        return out


class FindBeamformedOutliers(ContainerTask):
    """Flag beamformed visibilities deviating from the noise expectation.

    (reference flagging.py:345): flag |data| * sqrt(weight) > nsigma, with
    an optional window to widen the mask along given axes.
    """

    nsigma = config.float_prop(3.0)
    window = config.list_prop(None)

    def process(self, data):
        axes = list(data.data.axes)
        z = np.abs(np.asarray(data.data[:])) * np.sqrt(
            np.abs(np.asarray(data.weight[:]))
        )
        mask = z > self.nsigma

        if self.window is not None:
            from scipy.ndimage import maximum_filter

            # reference semantics (flagging.py:411-440): the list gives
            # the mask-extension width of the TRAILING len(window) axes
            # (e.g. [nha] for FormedBeamHA), leading axes untouched
            size = [1] * (mask.ndim - len(self.window)) + [
                int(w) for w in self.window
            ]
            mask = maximum_filter(mask.astype(np.uint8), size=size).astype(bool)

        if isinstance(data, containers.FormedBeamHA):
            out = containers.FormedBeamHAMask(axes_from=data, attrs_from=data)
        elif isinstance(data, containers.FormedBeam):
            out = containers.FormedBeamMask(axes_from=data, attrs_from=data)
        else:
            raise TypeError(f"No mask container known for {type(data)}")
        out.mask[:] = mask
        return out


class RadiometerWeight(ContainerTask):
    r"""Set weights from the radiometer equation.

    weight_ij = nsamp / (V_ii V_jj)  (reference flagging.py:552-611)
    """

    replace = config.bool_prop(True)

    @staticmethod
    def _integration_time(stream):
        """Median sample integration time in seconds."""
        if isinstance(stream, containers.SiderealStream):
            # 240 s of solar time per sidereal degree
            return np.median(np.abs(np.diff(stream.ra))) * 240 * STELLAR_S
        return np.median(np.abs(np.diff(stream.time)))

    def process(self, stream):
        stream.redistribute("freq")
        ninput = len(stream.index_map["input"])
        if len(stream.index_map["prod"]) != (ninput * (ninput + 1) // 2):
            raise RuntimeError(
                "This task needs the full (unstacked) correlation triangle."
            )
        freq_width = np.median(stream.index_map["freq"]["width"])
        int_time = self._integration_time(stream)

        if self.replace:
            stream.weight[:] = np.ones(stream.weight.shape, dtype=np.float32)

        nsamp = 1e6 * freq_width * int_time
        autos = ops_tools.device_to_numpy(
            extract_diagonal(np.asarray(stream.vis[:]))
        ).real
        weight_fac = nsamp**0.5 * invert_no_zero(autos)
        w = ops_tools.apply_gain(
            np.asarray(stream.weight[:]), np.asarray(weight_fac), axis=1
        )
        stream.weight[:] = np.asarray(w).real.astype(stream.weight.dtype)
        return stream


class SanitizeWeights(ContainerTask):
    """Zero weights outside a valid range (reference flagging.py:614-663)."""

    max_thresh = config.float_prop(1e30)
    min_thresh = config.float_prop(1e-30)

    def _finalise_config(self):
        if self.min_thresh >= self.max_thresh:
            raise ValueError("threshold_min exceeds threshold_max.")

    def process(self, data):
        data.redistribute("freq")
        weight = np.asarray(data.weight[:]).copy()
        weight[weight > self.max_thresh] = 0.0
        weight[weight < self.min_thresh] = 0.0
        data.weight[:] = weight
        return data


class NegativeAutosMask(ContainerTask):
    """Flag (freq, time) samples with any negative autocorrelation.

    (reference flagging.py:666-699)
    """

    def process(self, data):
        data.redistribute("freq")
        ps = data.prodstack
        autos = np.asarray(data.vis[:])[:, ps["input_a"] == ps["input_b"]].real
        out = _rfi_mask_for(data)
        out.mask[:] = (autos < 0.0).any(axis=1)
        self.log.debug(
            f"Negative autocorrelations flagged {_pct(out.mask[:]):.2f}% of the data."
        )
        return out


class SmoothVisWeight(ContainerTask):
    """Median-smooth the visibility weights in time (reference flagging.py:702)."""

    kernel_size = config.int_prop(31)
    mask_zeros = config.bool_prop(False)

    def process(self, data):
        data.redistribute("freq")
        weight = np.asarray(data.weight[:]).copy()
        for i in range(weight.shape[0]):
            zeromask = weight[i] == 0.0
            mask = zeromask if self.mask_zeros else np.zeros_like(zeromask)
            weight[i] = filters.medfilt(weight[i], mask, size=(1, self.kernel_size))
            weight[i][zeromask] = 0.0
        data.weight[:] = weight.astype(data.weight.dtype)
        return data


class ThresholdVisWeightFrequency(ContainerTask):
    """Mask frequencies with weights below a per-frequency threshold.

    (reference flagging.py:763-832)
    """

    absolute_threshold = config.float_prop(1e-7)
    relative_threshold = config.float_prop(0.9)

    def process(self, stream):
        stream.redistribute("freq")
        if not (
            "ra" in stream.index_map or "time" in stream.index_map
        ):
            raise TypeError(
                f"Need a TimeStream or SiderealStream here, not {type(stream)}"
            )

        # mean over baselines [freq, 1, nsample], then over the samples
        # where it clears the absolute floor
        over_bl = np.asarray(stream.weight[:]).mean(axis=1, keepdims=True)
        valid = np.where(over_bl > self.absolute_threshold, over_bl, np.nan)
        with warnings.catch_warnings():
            warnings.filterwarnings(action="ignore", message="Mean of empty slice")
            per_freq = np.nanmean(valid, axis=2, keepdims=True)

        cut = np.fmax(per_freq * self.relative_threshold, self.absolute_threshold)
        out = _rfi_mask_for(stream)
        out.mask[:] = ~(over_bl > cut)[:, 0, :]
        self.log.info(f"weight cut drops {_pct(out.mask[:]):0.5f}% of the data")
        return out


class ThresholdVisWeightBaseline(ContainerTask):
    """Baseline-dependent low-weight mask (reference flagging.py:835-982)."""

    average_type = config.enum(["median", "mean"], default="median")
    absolute_threshold = config.float_prop(1e-7)
    relative_threshold = config.float_prop(1e-6)
    ignore_absolute_threshold = config.float_prop(0.0)
    pols_to_flag = config.enum(["all", "copol"], default="all")

    def setup(self, telescope):
        self.telescope = io.get_telescope(telescope)

    def process(self, stream):
        if "ra" in stream.index_map:
            out = containers.SiderealBaselineMask(
                axes_from=stream, attrs_from=stream
            )
        elif "time" in stream.index_map:
            out = containers.BaselineMask(axes_from=stream, attrs_from=stream)
        else:
            raise TypeError(
                f"Task requires TimeStream or SiderealStream. Got {type(stream)}"
            )

        weight = np.asarray(stream.weight[:])
        # per-baseline typical weight over all (freq, sample) cells that
        # clear the ignore floor
        rows = np.moveaxis(weight, 1, 0).reshape(weight.shape[1], -1)
        live = rows > self.ignore_absolute_threshold
        if self.average_type == "mean":
            typical = (rows * live).sum(axis=-1) * invert_no_zero(
                live.sum(axis=-1)
            )
        else:
            typical = np.array(
                [np.median(r[s]) if s.any() else 0.0 for r, s in zip(rows, live)]
            )

        cut = np.maximum(
            self.absolute_threshold, self.relative_threshold * typical
        )[np.newaxis, :, np.newaxis]
        mask = (weight < cut) & (weight > self.ignore_absolute_threshold)

        if self.pols_to_flag == "copol":
            inputs = stream.prod[stream.stack["prod"]]
            pols = self.telescope.polarisation
            copol = (
                pols[inputs["input_a"].astype(int)]
                == pols[inputs["input_b"].astype(int)]
            )
            mask &= copol[np.newaxis, :, np.newaxis]

        self.log.info(f"weight cut drops {_pct(mask):.5f} of the data")
        out.mask[:] = mask
        return out


class CollapseBaselineMask(ContainerTask):
    """Collapse a baseline mask over the baseline axis (reference flagging.py:985)."""

    def process(self, baseline_mask):
        out = _rfi_mask_for(baseline_mask)
        out.mask[:] = np.asarray(baseline_mask.mask[:]).any(axis=1)
        self.log.info(
            f"weight cut after collapsing baselines drops "
            f"{_pct(out.mask[:]):.1f}%% of the data"
        )
        return out


class RFISensitivityMask(ContainerTask):
    """RFI mask from deviations of system sensitivity from radiometer noise.

    Full algorithm of reference flagging.py:1808-2118: an optional 1-D
    static mask from per-channel time quantiles (``_mask_1d``), then
    ``niter`` rounds of threshold reduction in which the background is
    re-estimated with a 2-D rolling weighted median (``base_size``), the
    noise with a rolling median absolute deviation (``mad_size``), and
    samples are flagged by MAD / TV-channel / SumThreshold tests; the
    MAD and SumThreshold masks are blended by the ``_combine_st_mad_hook``
    (MAD around bright transits, SumThreshold elsewhere), and the final
    OR over polarisations may be widened with the scale-invariant rank
    operator.
    """

    mask_type = config.enum(["mad", "sumthreshold", "combine"], default="combine")
    include_pol = config.list_type(str, default=None)

    nsigma_1d = config.float_prop(5.0)
    quantile_1d = config.float_prop(0.15)
    win_f_1d = config.int_prop(191)

    nsigma = config.float_prop(5.0)
    niter = config.int_prop(5)
    rho = config.float_prop(1.5)

    base_size = config.list_type(int, length=2, default=(37, 181))
    mad_size = config.list_type(int, length=2, default=(101, 31))
    tv_fraction = config.float_prop(0.5)
    max_m = config.int_prop(64)

    sir = config.bool_prop(False)
    eta = config.float_prop(0.2)
    only_time = config.bool_prop(False)

    # Convert MAD to RMS (reference flagging.py:1885)
    MAD_TO_RMS = 1.4826

    def setup(self):
        """Threshold schedule: nsigma * rho**(niter-1) ... nsigma."""
        self.threshold = self.nsigma * self.rho ** np.arange(self.niter)[::-1]

    def process(self, sensitivity):
        """Derive an RFI mask from a SystemSensitivity container."""
        pol = [
            p.decode() if isinstance(p, bytes) else str(p)
            for p in sensitivity.index_map["pol"]
        ]
        npol = len(pol)

        measured = np.asarray(sensitivity.measured[:])
        radio = np.asarray(sensitivity.radiometer[:])
        sens_weight = np.asarray(sensitivity.weight[:])

        # Radiometer test metric [freq, pol, time]
        metric = measured * np.asarray(invert_no_zero(radio))
        flag = sens_weight == 0.0

        freq = sensitivity.freq
        times = np.asarray(sensitivity.time)
        static_flag = ~self._static_rfi_mask_hook(freq, times[0])

        if self.mask_type == "combine":
            madtimes = self._combine_st_mad_hook(times, freq)

        per_pol = []
        for pi in range(npol):
            if self.include_pol and pol[pi] not in self.include_pol:
                continue
            per_pol.append(
                self._flag_one_pol(
                    metric[:, pi, :],
                    flag[:, pi, :] | static_flag[:, None],
                    freq,
                    madtimes if self.mask_type == "combine" else None,
                )
            )

        finalmask = np.logical_or.reduce(per_pol) if per_pol else (
            np.zeros(metric.shape[::2], dtype=bool)
        )
        self.log.info(
            f"RFISensitivityMask masks {_pct(finalmask):0.2f} percent of the data."
        )

        if self.sir:
            finalmask = self._apply_sir(finalmask, static_flag[:, None])
            self.log.info(
                f"After SIR dilation {_pct(finalmask):0.2f} percent "
                "of the data is masked."
            )

        out = containers.RFIMask(axes_from=sensitivity, attrs_from=sensitivity)
        out.mask[:] = finalmask
        return out

    def _flag_one_pol(self, y, flagged, freq, madtimes):
        """Run the iterated threshold schedule on one polarisation.

        ``y`` is the radiometer metric [freq, time]; ``flagged`` the
        starting mask; ``madtimes`` selects the MAD mask over the
        SumThreshold one (combine mode only).
        """
        # Static per-channel mask from the time quantile
        if self.nsigma_1d is not None:
            bad_channels, channel_level = self._mask_1d(y, flagged)
            flagged = flagged | bad_channels[:, None]
            y = y - channel_level[:, None]

        # Slowly reduce the threshold, re-estimating background and
        # deviation with the current mask each round
        for nsig in self.threshold:
            resid = y - filters.medfilt(y, flagged, tuple(self.base_size))
            noise = self.MAD_TO_RMS * filters.medfilt(
                np.abs(resid), flagged, tuple(self.mad_size)
            )
            significance = np.abs(resid) * np.asarray(invert_no_zero(noise))

            tv_bands = tv_channels_flag(
                significance, freq, sigma=nsig, f=self.tv_fraction
            )
            by_mad = (significance > nsig) | tv_bands

            if self.mask_type == "mad":
                flagged = flagged | by_mad
                continue

            by_st = rfi.sumthreshold(
                resid,
                self.max_m,
                start_flag=flagged | tv_bands,
                threshold1=nsig,
                remove_median=False,
                correct_for_missing=True,
                rho=1.0,
                variance=noise**2,
            )

            if self.mask_type == "sumthreshold":
                flagged = flagged | by_st
                continue

            # combine: MAD around transits, SumThreshold elsewhere
            blended = np.where(madtimes, by_mad, by_st)
            if not self.sir:
                # Extend the sumthreshold mask in time across the
                # transits if SIR will not run on the final mask
                widened = rfi.scale_invariant_rank(blended, eta=0.2, axis=-1)
                blended = np.where(madtimes, widened, blended)
            flagged = flagged | blended

        return flagged

    def _combine_st_mad_hook(self, times, freq):
        """Blending mask between SumThreshold and MAD flagged data.

        Override to use MAD around bright source transits (where
        SumThreshold removes real signal).  True selects the MAD mask.
        (reference flagging.py:2045)
        """
        return np.ones((freq.size, times.size), dtype=bool)

    def _static_rfi_mask_hook(self, freq, timestamp=None):
        """Static RFI mask; True keeps a channel (reference flagging.py:2066)."""
        return np.ones_like(freq, dtype=bool)

    def _mask_1d(self, rad, mask):
        """Mask channels whose time quantile deviates from the rolling
        frequency median by more than ``nsigma_1d`` MADs
        (reference flagging.py:2084)."""
        good = np.ascontiguousarray((~mask).astype(np.float64))

        # per-channel time quantile, then its deviation from a (rolling)
        # median over frequency in MAD units
        channel = median.quantile(
            np.ascontiguousarray(rad.astype(np.float64)), good, self.quantile_1d
        )
        alive = (good > 0).any(axis=-1).astype(np.float64)

        def freq_median(x):
            if self.win_f_1d is None:
                return median.weighted_median(x, alive)
            return median.moving_weighted_median(x, alive, self.win_f_1d)

        excess = np.abs(channel - freq_median(channel))
        scale = self.MAD_TO_RMS * freq_median(excess)
        return excess > (self.nsigma_1d * scale), channel

    def _apply_sir(self, mask, baseflag, eta=None):
        """Expand the mask with SIR, excluding the static flag
        (reference flagging.py:2105).  ``eta`` defaults to the task's
        configured value."""
        eta = self.eta if eta is None else eta
        dynamic = mask & ~np.broadcast_to(baseflag, mask.shape)
        axes = (-1,) if self.only_time else (0, -1)
        return rfi.scale_invariant_rank(dynamic, eta=eta, axis=axes) | mask


class RFIMask(ContainerTask):
    """MAD + TV-channel RFI masking on a single stack (reference flagging.py:2120)."""

    sigma = config.float_prop(5.0)
    tv_fraction = config.float_prop(0.5)
    stack_ind = config.int_prop(0)

    def process(self, sstream):
        vis = np.asarray(sstream.vis[:])[:, self.stack_ind]
        wgt = np.asarray(sstream.weight[:])[:, self.stack_ind]

        # deviation in MAD units, with unestimable cells treated as bad
        low_weight = wgt < 1e-4 * wgt.mean()
        dev = mad(vis, low_weight)
        dev = np.where(np.isnan(dev), 2 * self.sigma, dev)

        tv_bands = tv_channels_flag(
            dev, sstream.freq, sigma=self.sigma, f=self.tv_fraction
        )
        out = _rfi_mask_for(sstream)
        out.mask[:] = tv_bands | (dev > self.sigma)
        self.log.info(f"RFI cut removes {_pct(out.mask[:]):0.2f}% of the data.")
        return out


class ApplyTimeFreqMask(ContainerTask):
    """Zero weights at masked (freq, time) samples (reference flagging.py:2222)."""

    share = config.enum(["none", "vis", "map", "all"], default="all")
    collapse_pol = config.bool_prop(False)
    match_axes = config.bool_prop(True)

    #: mask container family -> (required stream axis, sample-axis getter)
    _family = (
        ((containers.RFIMask, containers.RFIMaskByPol), "time"),
        (
            (containers.SiderealRFIMask, containers.SiderealRFIMaskByPol),
            "ra",
        ),
    )

    def process(self, tstream, rfimask):
        for classes, ax in self._family:
            if isinstance(rfimask, classes):
                tax = ax
                break
        else:
            raise TypeError(
                f"The mask must be an RFIMask or SiderealRFIMask, not {type(rfimask)}."
            )
        if tax not in tstream.index_map:
            kind = "time" if tax == "time" else "sidereal"
            raise TypeError(
                f"A {kind}-like container is needed; received {type(tstream)}."
            )
        stream_samples = tstream.index_map[tax]
        mask_samples = rfimask.index_map[tax]

        if not np.array_equal(tstream.freq, rfimask.freq):
            raise ValueError("Stream and mask disagree on the freq axis.")

        if self.match_axes:
            if not np.array_equal(stream_samples, mask_samples):
                raise ValueError("Stream and mask disagree on the time-like axis.")
            pick_stream = pick_mask = slice(None)
        else:
            pick_stream = np.isin(stream_samples, mask_samples)
            pick_mask = np.isin(mask_samples, stream_samples)
            if not pick_stream.any():
                raise ValueError("The stream and mask time axes do not overlap.")

        tstream.redistribute("freq")
        waxes = list(tstream.weight.axes)
        maxes = list(rfimask.mask.axes)
        mask = np.asarray(rfimask.mask[:])

        if "pol" in maxes:
            if self.collapse_pol or "pol" not in waxes:
                mask = mask.any(axis=maxes.index("pol"))
                maxes.remove("pol")
            elif not np.array_equal(
                tstream.index_map["pol"], rfimask.index_map["pol"]
            ):
                raise ValueError("Stream and mask disagree on the pol axis.")

        grow = [slice(None) if ax in maxes else np.newaxis for ax in waxes]
        grow[waxes.index(tax)] = pick_mask
        into = [slice(None)] * len(waxes)
        into[waxes.index(tax)] = pick_stream

        out = _writable_copy(tstream, self.share)
        w = np.asarray(out.weight[:]).copy()
        w[tuple(into)] *= ~mask[tuple(grow)]
        out.weight[:] = w
        return out


# Compatibility alias (reference flagging.py:3227)
ApplyRFIMask = ApplyTimeFreqMask


class ApplyGenericMask(ContainerTask):
    """Apply a mask container to any dataset sharing its axes.

    (reference flagging.py:2380)
    """

    def process(self, data, mask):
        daxes = list(data.weight.axes)
        maxes = list(mask.mask.axes)
        missing = [ax for ax in maxes if ax not in daxes]
        if missing:
            raise NameError(
                f"Mask has axes {missing} which are not found in data."
                f"\naxes of the data: {daxes}\naxes of the mask: {maxes}"
            )
        keep = ~_align_to(np.asarray(mask.mask[:]), maxes, daxes)
        data.weight[:] = np.asarray(data.weight[:]) * keep.astype(
            data.weight.dtype
        )
        return data


MaskBeamformedOutliers = ApplyGenericMask


class GeneralCombineMasks(ContainerTask):
    """Combine masks with a logical expression over A..Z (reference flagging.py:2442)."""

    expression = config.str_prop("A")

    _dataset_name = "mask"
    _operators: ClassVar[set] = set("&|~^()")

    def process(self, masks):
        if not isinstance(masks, (list, tuple)):
            masks = [masks]
        if len(masks) > 26:
            raise ValueError("At most 26 masks (letters A-Z) can be combined.")
        if any(type(m) is not type(masks[0]) for m in masks[1:]):
            raise TypeError("Every mask in the combination must share one container type.")
        pattern = self._build_allowed_pattern()
        if not re.match(pattern, self.expression):
            raise ValueError(
                f"Cannot parse '{self.expression}': only the letters A-Z, digits, "
                f"spaces and {''.join(sorted(self._operators))} are allowed."
            )
        namespace = {
            chr(ord("A") + i): np.asarray(m.datasets[self._dataset_name][:])
            for i, m in enumerate(masks)
        }
        self.log.info(f"Combining masks via '{self.expression}'")
        result = eval(self.expression, {}, namespace)  # noqa: S307 - validated above
        combined = masks[0].copy()
        combined.datasets[self._dataset_name][:] = result
        return combined

    def _build_allowed_pattern(self):
        escaped = [re.escape(op) for op in self._operators]
        return rf"^[A-Z0-9\s{''.join(escaped)}]+$"


class CombineMasks(GeneralCombineMasks):
    """Logical OR of a list of masks (reference flagging.py:2521)."""

    def process(self, masks):
        if not isinstance(masks, (list, tuple)):
            masks = [masks]
        self.expression = " | ".join([chr(ord("A") + i) for i in range(len(masks))])
        return super().process(masks)


class ApplyTaper(ContainerTask):
    """Multiply a taper container into a dataset (reference flagging.py:2542)."""

    update_weight = config.bool_prop(False)

    def process(self, data, taper):
        daxes = list(data.data.axes)
        taxes = list(taper.taper.axes)
        missing = [ax for ax in taxes if ax not in daxes]
        if missing:
            raise NameError(f"Taper has axes {missing} not found in data.")
        t = np.asarray(taper.taper[:])
        data.data[:] = (
            np.asarray(data.data[:]) * _align_to(t, taxes, daxes)
        ).astype(data.data.dtype)
        if self.update_weight:
            tw = _align_to(t, taxes, list(data.weight.axes))
            data.weight[:] = (
                np.asarray(data.weight[:]) * invert_no_zero(tw**2)
            ).astype(data.weight.dtype)
        return data


class MaskFreq(ContainerTask):
    """Make a frequency(-time) mask (reference flagging.py:2894-3043)."""

    bad_freq_ind = config.list_prop(None)
    factorize = config.bool_prop(False)
    all_time = config.bool_prop(False)
    mask_missing_data = config.bool_prop(False)
    freq_frac = config.float_prop(None)

    def process(self, data):
        data.redistribute("freq")

        # count of unmasked cells per (freq, sample), collapsing every
        # other weight axis
        waxes = list(data.weight.axes)
        collapse = tuple(
            ii for ii, ax in enumerate(waxes) if ax not in ("freq", "time", "ra")
        )
        live = np.count_nonzero(np.asarray(data.weight[:]) > 0, axis=collapse)

        mask = live < live.max() if self.mask_missing_data else live == 0
        if self.mask_missing_data:
            self.log.info(f"All-baseline requirement: mask at {_pct(mask):.2f}%.")
        else:
            self.log.info(f"Starting mask covers {_pct(mask):.2f}%.")

        if self.bad_freq_ind is not None:
            mask |= self._bad_freq_mask(len(data.freq))[:, np.newaxis]
            self.log.info(f"Channel cut: mask at {_pct(mask):.2f}%.")
        if self.freq_frac is not None:
            mostly_gone = mask.mean(axis=1) > (1.0 - self.freq_frac)
            mask |= mostly_gone[:, np.newaxis]
            self.log.info(f"Fraction cut: mask at {_pct(mask):.2f}%.")
        if self.all_time:
            mask |= mask.any(axis=1)[:, np.newaxis]
            self.log.info(f"Fully-masked-channel cut: mask at {_pct(mask):.2f}%.")
        elif self.factorize:
            mask = self._optimal_mask(mask)
            self.log.info(f"Factorisation: mask at {_pct(mask):.2f}%.")

        out = _rfi_mask_for(data)
        out.mask[:] = mask
        return out

    def _bad_freq_mask(self, nfreq):
        mask = np.zeros(nfreq, dtype=bool)
        for entry in self.bad_freq_ind:
            if isinstance(entry, int):
                if entry < nfreq:
                    mask[entry] = True
            elif isinstance(entry, (tuple, list)) and len(entry) == 2:
                lo, hi = entry
                mask[lo:hi] = True
            else:
                raise ValueError(
                    "Each `bad_freq_ind` entry must be an int or a 2-tuple. "
                    f"Got {type(entry)}."
                )
        return mask

    def _optimal_mask(self, mask):
        from scipy.optimize import minimize_scalar

        def factorised(threshold):
            # times over-threshold are masked whole; remaining bad
            # samples promote their whole frequency row
            bad_time = mask.mean(axis=0) > threshold
            bad_freq = mask[:, ~bad_time].any(axis=1)
            return bad_time[np.newaxis, :] | bad_freq[:, np.newaxis]

        res = minimize_scalar(
            fun=lambda f: factorised(f).mean(),
            bounds=(0, 1),
            method="bounded",
            options={"maxiter": 20, "xatol": 1e-4},
        )
        if not res.success:
            self.log.debug("Fit did not formally converge (common here; continuing).")
        return factorised(res.x)


class BlendStack(ContainerTask):
    """Blend a stack into daily data to regularise RFI gaps.

    (reference flagging.py:3046-3223)
    """

    frac = config.float_prop(1e-4)
    match_median = config.bool_prop(True)
    subtract = config.bool_prop(False)
    mask_freq = config.bool_prop(False)

    def setup(self, data_stack):
        self.data_stack = data_stack

    def process(self, data):
        if "effective_ra" in data.datasets:
            raise TypeError(
                "Blending uncorrected rebinned data not supported. Apply "
                "sidereal.RebinGradientCorrection first."
            )
        if not isinstance(data, type(self.data_stack)):
            raise TypeError(
                f"type(data) (={type(data)}) must match "
                f"type(data_stack) (={type(self.data_stack)})"
            )
        _supported = (
            containers.SiderealStream,
            containers.RingMap,
            containers.HybridVisStream,
        )
        if not isinstance(data, _supported):
            raise TypeError(f"Only {_supported} supported. Got {type(data)}.")

        ref = np.asarray(self.data_stack.data[:])
        day = np.asarray(data.data[:]).copy()
        if ref.shape != day.shape:
            raise ValueError(
                f"Shape mismatch between the input ({day.shape}) and the "
                f"stack being blended ({ref.shape})"
            )

        dax = list(data.data.axes)
        wax = list(data.weight.axes)
        grow = tuple(slice(None) if ax in wax else np.newaxis for ax in dax)
        wref = np.asarray(self.data_stack.weight[:])[grow].astype(np.float64)
        wday = np.asarray(data.weight[:])[grow].astype(np.float64).copy()

        if self.match_median:
            # per-(everything but RA) median offset over mutually valid
            # samples, so the blend doesn't drag the daily level around
            ra_ax = dax.index("ra")
            both = np.broadcast_to(
                np.moveaxis((wday > 0) & (wref > 0), ra_ax, -1),
                np.moveaxis(ref, ra_ax, -1).shape,
            )

            def ra_median(arr):
                arr = np.moveaxis(arr, ra_ax, -1)
                return complex_med(np.where(both, arr, np.nan), axis=-1)

            offset = np.nan_to_num(ra_median(day) - ra_median(ref))
            offset = np.moveaxis(offset[..., np.newaxis], -1, ra_ax)
        else:
            offset = 0

        if self.mask_freq:
            others = tuple(ii for ii, ax in enumerate(dax) if ax != "freq")
            has_any = np.any(wday, axis=others, keepdims=True)
            wref = wref * has_any.astype(np.float64)

        if self.subtract:
            day -= ref + offset
            day *= (wday > 0).astype(np.float32)
            wday = np.asarray(invert_no_zero(wday + wref)) * wday
            wday += (wday == 0) * self.frac
            wday *= wref
        else:
            day *= wday
            day += wref * self.frac * (ref + offset)
            wday += wref * self.frac
            day *= np.asarray(invert_no_zero(wday))

        data.data[:] = day.astype(data.data.dtype)
        # reduce the weight back to its own axes
        shrink = tuple(0 if s is np.newaxis else slice(None) for s in grow)
        data.weight[:] = wday[shrink].astype(data.weight.dtype)
        return data


# ---------------------------------------------------------------------------
# Helper functions (reference flagging.py:3231-3430)
# ---------------------------------------------------------------------------


def mad(x, mask, base_size=(11, 3), mad_size=(21, 21), debug=False, sigma=True):
    """MAD deviation of freq-time data (reference flagging.py:3231)."""
    smooth = filters.medfilt(x, mask, size=base_size)
    dev = np.abs(x - smooth)
    spread = filters.medfilt(dev, mask, size=mad_size)
    if sigma:
        spread = spread * 1.4826  # MAD -> rms for a Gaussian
    with np.errstate(divide="ignore", invalid="ignore"):
        significance = dev / spread
    return (significance, dev, spread) if debug else significance


def inverse_binom_cdf_prob(k, N, F):
    """Trial probability with binomial CDF F at (k, N) (reference flagging.py:3274)."""
    from scipy.special import betaincinv

    return betaincinv(k + 1, N - k, 1 - F)


def sigma_to_p(sigma):
    """Two-tailed Gaussian excursion probability (reference flagging.py:3302)."""
    import scipy.stats as ss

    return 2 * ss.norm.sf(sigma)


def p_to_sigma(p):
    """Sigma exceeded with two-tailed probability p (reference flagging.py:3309)."""
    import scipy.stats as ss

    return ss.norm.isf(p / 2)


#: North-American TV broadcast bands: 67 stations of 6 MHz from 398 MHz
_TV_BAND_EDGES = 398.0 + 6.0 * np.arange(68)


def tv_channels_flag(x, freq, sigma=5, f=0.5, debug=False):
    """Flag whole TV-station bands whose bad-sample fraction exceeds ``f``.

    Within each 6 MHz broadcast band the per-band significance threshold
    is set so a fraction ``f`` of the band's channels exceeding it is a
    ``sigma``-level event under the binomial null; any band where the
    observed fraction tops ``f`` is masked in full.  Semantics of
    reference flagging.py:3316-3381.
    """
    x = np.asarray(x)
    null_p = sigma_to_p(sigma)
    half_ch = 0.5 * np.median(np.abs(np.diff(freq)))
    # ones init: channels outside every TV band keep frac = 1 and are
    # masked — reference-parity behaviour (reference flagging.py:3344;
    # benign for bands fully inside [398, 800] MHz, surprising outside)
    bad_frac = np.ones_like(x, dtype=np.float32)

    for band_lo, band_hi in zip(_TV_BAND_EDGES[:-1], _TV_BAND_EDGES[1:]):
        members = np.flatnonzero(
            (freq + half_ch >= band_lo) & (freq - half_ch <= band_hi)
        )
        if members.size == 0:
            continue
        n = members.size
        level = p_to_sigma(
            inverse_binom_cdf_prob(int(f * n), n, 1 - null_p)
        )
        bad_frac[members] = np.mean(x[members] > level, axis=0)

    mask = bad_frac > f
    return (mask, bad_frac) if debug else mask


def complex_med(x, *args, **kwargs):
    """Complex median via the real/imag parts (reference flagging.py:3384)."""
    re = np.nanmedian(x.real, *args, **kwargs)
    im = np.nanmedian(x.imag, *args, **kwargs)
    return re + 1j * im


def destripe(x, w, axis=1):
    """Subtract the unmasked median along an axis (reference flagging.py:3404)."""
    stripe = np.nan_to_num(complex_med(np.where(w, x, np.nan), axis=axis))
    return x - np.expand_dims(stripe, axis)


# ---------------------------------------------------------------------------
# Gain / beamformed-weight masks (reference flagging.py:457-550)
# ---------------------------------------------------------------------------


class MaskBadGains(ContainerTask):
    """Mask regions with bad gain (reference flagging.py:457).

    Assumes bad gains are set to 1.

    Attributes
    ----------
    threshold, threshold_tol : float
        Gains <= threshold (+tol) across all inputs are flagged.
    """

    threshold = config.float_prop(1.0)
    threshold_tol = config.float_prop(1e-5)

    def process(self, data):
        """Generate a time-frequency mask from the gain dataset."""
        mask = np.all(
            np.asarray(data.datasets["gain"][:]).real
            <= self.threshold + self.threshold_tol,
            axis=1,
        )
        mask_cont = containers.RFIMask(axes_from=data)
        mask_cont.mask[:] = mask
        return mask_cont


class MaskBeamformedWeights(ContainerTask):
    """Zero anomalously large beamformed weights (reference flagging.py:493).

    Attributes
    ----------
    nmed : float
        Weights above ``nmed`` times the per-pol median are zeroed.
    """

    nmed = config.float_prop(8.0)

    def process(self, data):
        """Mask large weights in a FormedBeam container."""
        w = np.asarray(data.weight[:])
        npol = len(data.pol)
        med_weight = np.zeros(npol, dtype=np.float32)
        for pp in range(npol):
            wp = w[:, pp]
            med_weight[pp] = np.median(wp[wp > 0]) if (wp > 0).any() else 0.0
            self.log.info(
                f"Pol {data.pol[pp]} median weight {med_weight[pp]:0.2e}"
            )

        flag = w < (self.nmed * med_weight[np.newaxis, :, np.newaxis])
        data.weight[:] = (w * flag).astype(data.weight.dtype)
        return data


# ---------------------------------------------------------------------------
# Visibility-space RFI masks (reference flagging.py:1042-1423)
# ---------------------------------------------------------------------------


class RFIVisMask(ContainerTask):
    """Base class for RFI flagging on visibilities (reference flagging.py:1042).

    Attributes
    ----------
    stokes_i : bool
        Flag on Stokes-I-combined visibilities (factor ~4 fewer baselines).
    """

    stokes_i = config.bool_prop(True)

    def setup(self, telescope):
        """Set the telescope object."""
        self.telescope = io.get_telescope(telescope)

    def process(self, stream):
        """Build a time-frequency mask from the data."""
        from . import transform

        if "time" not in stream.index_map and "ra" not in stream.index_map:
            raise TypeError(
                f"A `time` or `ra` axis is required; {type(stream)} has neither."
            )
        times, _ = _sample_unix_times(stream, self.telescope)
        out = _rfi_mask_for(stream)
        freq = np.asarray(stream.freq)

        if self.stokes_i:
            vis, weight, baselines = transform.stokes_I(stream, self.telescope)
            vis = np.asarray(vis)
            weight = np.asarray(weight)
        else:
            vis = np.asarray(stream.vis[:])
            weight = np.asarray(stream.weight[:])
            baselines = self.telescope.baselines

        seed = (weight == 0).all(axis=1)
        seed |= self._static_rfi_mask_hook(freq, times[0])[:, np.newaxis]
        self.log.debug(f"{_pct(seed):.2f}% of data initially flagged.")

        out.mask[:] = self.generate_mask(vis, weight, seed, freq, baselines, times)
        self.log.debug(f"{_pct(out.mask[:]):.2f}% of data flagged.")
        return out

    def generate_mask(self, vis, weight, mask, freq, baselines, times):
        """Generate a (freq, time) mask; subclass responsibility."""
        raise NotImplementedError

    def _static_rfi_mask_hook(self, freq, timestamp=None):
        """Override to mask entire frequency channels."""
        return np.zeros_like(freq, dtype=bool)


class RFITransientVisMask(RFIVisMask):
    """Flag transient RFI via high-pass + beamform + MAD filter.

    (reference flagging.py:1191-1277)

    Attributes
    ----------
    mad_base_size, mad_dev_size : [int, int]
        MAD filter window sizes.
    sigma_high, sigma_low : float
        Hysteresis thresholds in MAD units.
    frac_samples : float
        Fraction of flagged beams above which the time sample is masked.
    """

    mad_base_size = config.list_type(int, length=2, default=[1, 101])
    mad_dev_size = config.list_type(int, length=2, default=[1, 51])
    sigma_high = config.float_prop(8.0)
    sigma_low = config.float_prop(2.0)
    frac_samples = config.float_prop(0.01)

    def generate_mask(self, vis, weight, mask, freq, baselines, times):
        """Flag isolated transient RFI events."""
        ra = (
            np.unwrap(self.telescope.unix_to_lsa(times), period=360.0)
            * np.pi
            / 180.0
        )

        dec = np.deg2rad(self.telescope.latitude)
        lambda_inv = freq.min() * 1e6 / 299792458.0
        hpf_cut = lambda_inv * np.abs(baselines[:, 0]).max() / np.cos(dec)

        finalmask = mask[:, np.newaxis] | np.zeros(vis.shape, dtype=bool)

        for ii in range(vis.shape[0]):
            if np.all(mask[ii]):
                continue
            vhpf = np.asarray(
                filters.highpass_weighted_convolution_filter(
                    vis[ii], weight[ii], ra, hpf_cut, axis=-1
                )
            )
            vfft = np.abs(np.fft.fft(vhpf, axis=0))
            mad_ = mad(vfft, finalmask[ii], self.mad_base_size, self.mad_dev_size)
            finalmask[ii] |= ops_tools.apply_hysteresis_threshold(
                mad_, self.sigma_low, self.sigma_high
            )

        # Scale-invariant rank operator over (freq, time); don't extend
        # anything that was originally masked
        finalmask |= rfi.scale_invariant_rank(
            finalmask & ~mask[:, np.newaxis], eta=(0.1, 0.2), axis=(0, -1)
        )

        return finalmask.mean(axis=1) > self.frac_samples


class RFIInverseRedundancyChisqFreqMask(RFIVisMask):
    """Flag time-constant narrowband RFI from a chi-squared metric.

    (reference flagging.py:1280-1391): a MAD filter on the time-median of
    the chi-squared, then a high-sensitivity MAD filter on the ratio to a
    smoothed background.

    Attributes
    ----------
    nsigma : float
        Starting MAD threshold.
    winsize : tuple
        Median filter window for the smooth background.
    """

    nsigma = config.float_prop(15.0)
    winsize = config.Property(proptype=tuple, default=(15, 11))

    def generate_mask(self, vis, weight, mask, freq, baselines, times):
        """Mask narrowband RFI."""
        from ..ops import median as median_ops

        vis = np.asarray(vis).real[:, 0]
        weight = np.asarray(weight)[:, 0]
        mask = np.asarray(mask)

        def _masked_median(x, m, axis=-1, keepdims=True, winsize=None):
            x = np.abs(x).astype(np.float64)
            w = (~m).astype(np.float64)
            if winsize is not None:
                med = median_ops.moving_weighted_median(x, w, size=winsize)
            else:
                med = median_ops.weighted_median(x, w, axis=axis)
                if keepdims:
                    med = np.expand_dims(med, axis)
            return med

        def _mad1d(spectrum, m, axis=-1):
            baseline = ops_tools.IarPLS_1d(
                np.squeeze(spectrum, axis=-1), np.squeeze(m, axis=-1), lam=5e1
            )
            dev = np.abs(spectrum - baseline[..., np.newaxis])
            med = 1.4826 * _masked_median(dev, m, axis=0)
            return dev * np.asarray(invert_no_zero(med))

        def _mask1d(x, m, thresh_low, thresh_high):
            spectrum = _masked_median(x, m, axis=-1)
            mi = np.all(m, axis=-1, keepdims=True)
            m1d = _mad1d(spectrum, mi, axis=0)
            return ops_tools.apply_hysteresis_threshold(
                m1d, thresh_low, thresh_high
            )

        tslc = self._day_flag_hook(times)

        vi = vis[..., tslc]
        mi = mask[..., tslc].copy()

        mi |= _mask1d(vi, mi, self.nsigma / 2, self.nsigma)

        bg = np.asarray(filters.medfilt(vi, mi, size=self.winsize)) * ~mi
        ratio = vi * np.asarray(invert_no_zero(bg))

        mi |= _mask1d(ratio, mi, self.nsigma / 4, self.nsigma / 2)

        mask = mask | (mi & ~mask[..., tslc]).any(axis=-1, keepdims=True)
        return mask

    def _day_flag_hook(self, times):
        """Override to restrict to nighttime; default uses all times."""
        return np.ones(times.size, dtype=bool)


from ..core.task import group_tasks as _group_tasks  # noqa: E402
from .transform import ReduceChisqInverseRedundancy as _RCIR  # noqa: E402


class RFIStaticVisMask(
    _group_tasks(MaskBaselines, _RCIR, RFIInverseRedundancyChisqFreqMask)
):
    """Grouped narrowband RFI flagging pipeline (reference flagging.py:1394)."""


class RFIMaskChisqHighDelay(ContainerTask):
    """Mask anomalous chi-squared test statistics (reference flagging.py:1425).

    Attributes
    ----------
    flag_ew : array
        Optional per-EW-baseline flag applied before collapsing.
    reg_arpls, nsigma_1d : float
        Baseline regularisation and 1D threshold.
    win_t, win_f : int
        Moving-median window sizes (time, freq).
    nsigma_2d : float
        2D deviation threshold in expected standard deviations.
    estimate_var, only_positive, separate_pol : bool
        Variance estimation / one-sided masking / per-pol masks.
    mask_type : "mad" | "sumthreshold"
    niter, rho, max_m
        SumThreshold iteration controls.
    """

    flag_ew = config.Property(proptype=np.array, default=None)

    reg_arpls = config.float_prop(1e5)
    nsigma_1d = config.float_prop(5.0)

    win_t = config.int_prop(601)
    win_f = config.int_prop(1)
    nsigma_2d = config.float_prop(5.0)
    estimate_var = config.bool_prop(False)
    only_positive = config.bool_prop(False)
    separate_pol = config.bool_prop(False)

    mask_type = config.enum(["mad", "sumthreshold"], default="mad")
    niter = config.int_prop(5)
    rho = config.float_prop(1.5)
    max_m = config.int_prop(32)

    def setup(self, telescope=None):
        """Optionally save the telescope (needed for sidereal streams)."""
        self.telescope = None if telescope is None else io.get_telescope(telescope)
        if self.mask_type == "sumthreshold":
            self.threshold = self.nsigma_2d * self.rho ** np.arange(self.niter)[::-1]

    def process(self, stream):
        """Generate a time/freq mask from a chi-squared-like dataset."""
        freq = np.asarray(stream.freq)
        when, spans_days = _sample_unix_times(stream, self.telescope)

        dax = list(stream.data.attrs["axis"])
        wax = list(stream.weight.attrs["axis"])

        by_pol = self.separate_pol and "pol" in dax
        keep = ("freq", "time", "ra", "pol") if by_pol else ("freq", "time", "ra")
        collapse = tuple(ii for ii, ax in enumerate(dax) if ax not in keep)

        stat = np.asarray(stream.data[:]).real
        wgt = _align_to(np.asarray(stream.weight[:]), wax, dax)
        if self.flag_ew is not None and "ew" in dax:
            wgt = wgt * _align_to(np.asarray(self.flag_ew), ["ew"], dax)

        # summing the BROADCAST weight already counts each missing-axis
        # element once (the reference reaches the same total as
        # wfactor * sum(unbroadcast weight), flagging.py:1578);
        # multiplying by wfactor on top would double-count and shrink
        # the reported chisq deviations by sqrt(wfactor)
        wgt = np.broadcast_to(wgt, stat.shape)
        wtot = wgt.sum(axis=collapse)
        stat = (wgt * stat).sum(axis=collapse) * np.asarray(
            invert_no_zero(wtot)
        )

        missing = wtot == 0.0
        daytime = (
            np.zeros(when.size, dtype=bool)
            if spans_days
            else self._day_flag_hook(when)
        )
        transits = self._source_flag_hook(when, freq)

        output = _rfi_mask_for(stream, by_pol=by_pol)
        flagged = np.zeros(output.mask.shape, dtype=bool)

        slabs = (
            np.arange(len(stream.index_map["pol"]))
            if by_pol
            else [slice(None)]
        )
        for sl in slabs:
            known_bad = missing[sl] | transits

            if self.nsigma_1d > 0.0:
                bad_channels = self._flag_channels(
                    stat[sl], known_bad | daytime
                )[:, np.newaxis]
                known_bad = known_bad | bad_channels
                flagged[sl] |= bad_channels

            if self.nsigma_2d > 0.0:
                w2d = ~known_bad * wtot[sl] / 2.0
                flag2d = (
                    self._flag_local_mad(stat[sl], w2d)
                    if self.mask_type == "mad"
                    else self._flag_sumthreshold(stat[sl], w2d)
                )
                flagged[sl] |= flag2d & ~daytime

        output.mask[:] = flagged
        return output

    def _flag_channels(self, stat, bad):
        """Flag channels whose time-median deviates from the baseline."""
        from ..ops import median as median_ops

        good = (~bad).astype(np.float64)
        level = median_ops.weighted_median(stat.astype(np.float64), good)
        dead = bad.all(axis=-1)
        alive = (~dead).astype(np.float64)

        smooth = ops_tools.arPLS_1d(level, mask=dead, lam=self.reg_arpls)
        excess = np.where(dead, 0.0, np.abs(level - smooth))
        # 1.48625 (not the usual 1.4826): deliberate reference parity
        # (reference flagging.py:1665,1702,1754 uses this constant here)
        scale = 1.48625 * median_ops.weighted_median(excess, alive)

        return excess > (self.nsigma_1d * scale)

    def _local_deviation(self, stat, w, win):
        """(stat - rolling median) * sqrt(w), optionally MAD-normalised."""
        from ..ops import median as median_ops

        background = median_ops.moving_weighted_median(stat, w, win)
        dev = (stat - background) * np.sqrt(w)
        if self.estimate_var:
            counted = (w > 0.0).astype(np.float64)
            scale = 1.48625 * median_ops.moving_weighted_median(
                np.abs(dev), counted, win
            )
            return dev * np.asarray(invert_no_zero(scale)), scale
        return dev, None

    def _flag_local_mad(self, stat, w):
        """Flag samples deviating from a local moving median."""
        dev, _ = self._local_deviation(
            stat.astype(np.float64), w.astype(np.float64), (self.win_f, self.win_t)
        )
        if not self.only_positive:
            dev = np.abs(dev)
        return dev > self.nsigma_2d

    def _flag_sumthreshold(self, stat, w):
        """Iterative SumThreshold masking of the chi-squared."""
        from ..ops import median as median_ops

        stat = np.ascontiguousarray(stat, dtype=np.float64)
        win = (self.win_f, self.win_t)

        flag = w == 0.0
        for nsigma in self.threshold:
            live = (~flag * w).astype(np.float64)
            background = median_ops.moving_weighted_median(stat, live, win)
            dev = (stat - background) * np.sqrt(w)
            if self.estimate_var:
                counted = (live > 0.0).astype(np.float64)
                scale = 1.48625 * median_ops.moving_weighted_median(
                    np.abs(dev), counted, win
                )
                var = scale**2
            else:
                var = np.ones_like(stat)

            flag |= rfi.sumthreshold(
                dev,
                self.max_m,
                start_flag=flag,
                threshold1=nsigma,
                remove_median=False,
                correct_for_missing=True,
                rho=1.0,
                variance=var,
                only_positive=self.only_positive,
            )

        return flag

    def _source_flag_hook(self, times, freq):
        """Override to mask bright sources."""
        return np.zeros((freq.size, times.size), dtype=bool)

    def _day_flag_hook(self, times):
        """Override to mask daytime."""
        return np.zeros(times.size, dtype=bool)


# ---------------------------------------------------------------------------
# Taper combination / conversion (reference flagging.py:2617-2808)
# ---------------------------------------------------------------------------


class GeneralCombineTapers(GeneralCombineMasks):
    """Combine tapers with an arithmetic expression (reference flagging.py:2617)."""

    _dataset_name = "taper"
    _operators: ClassVar[set] = set("+-*/()")


class CombineTapers(GeneralCombineTapers):
    """Product of an arbitrary number of tapers (reference flagging.py:2640)."""

    def process(self, tapers):
        """Multiply all input tapers together."""
        if not isinstance(tapers, (list, tuple)):
            tapers = [tapers]
        self.expression = " * ".join(
            [chr(ord("A") + i) for i in range(len(tapers))]
        )
        return super().process(tapers)


class MaskFromTaper(ContainerTask):
    """Threshold a RingMapTaper into a RingMapMask (reference flagging.py:2661).

    Attributes
    ----------
    outer : bool
        Mask where taper < 1 (True) or taper == 0 (False).
    """

    outer = config.bool_prop(False)

    def process(self, taper):
        """Generate the boolean mask from the taper."""
        out = containers.RingMapMask(axes_from=taper, attrs_from=taper)
        t = np.asarray(taper.taper[:])
        out.mask[:] = (t < 1.0) if self.outer else (t == 0.0)
        return out


class TaperDelayTransform(ContainerTask):
    """Apply a freq-collapsed taper/mask to a DelayTransform.

    (reference flagging.py:2711-2799)

    Attributes
    ----------
    update_weight : bool
        Scale the weights by 1/taper^2 in unmasked regions.
    """

    update_weight = config.bool_prop(False)

    def process(self, data, apply):
        """Apply the taper or mask in place."""
        if isinstance(apply, containers.RingMapTaper):
            taper = np.mean(np.asarray(apply.taper[:]), axis=1).transpose(0, 2, 1)
        else:
            taper = np.all(~np.asarray(apply.mask[:]), axis=1).transpose(0, 2, 1)

        _, _, nra = taper.shape

        for dax, tax in [("sample", "ra"), ("el", "el")]:
            if not np.array_equal(
                np.asarray(data.index_map[dax]), np.asarray(apply.index_map[tax])
            ):
                raise ValueError(
                    f"Mismatch between {dax} axis of delay transform and "
                    f"{tax} axis of taper/mask."
                )

        bax = list(data.attrs["baseline_axes"])
        shp = (*[len(data.index_map[ax]) for ax in bax], nra)
        bcast = tuple(
            slice(None) if ax in ["pol", "el"] else None for ax in bax
        )

        taper_expanded = np.ones(shp, dtype=float)
        taper_expanded *= taper[bcast].astype(float)
        taper_collapsed = taper_expanded.reshape(-1, nra, 1)

        data.spectrum[:] = (
            np.asarray(data.spectrum[:]) * taper_collapsed
        ).astype(data.spectrum.dtype)

        if self.update_weight:
            if "weight" in data.datasets:
                data.weight[:] = (
                    np.asarray(data.weight[:])
                    * np.asarray(invert_no_zero(taper_collapsed)) ** 2
                ).astype(data.weight.dtype)
            else:
                self.log.warning(
                    "Delay transform does not contain a weight dataset.  "
                    "Skipping application of mask/taper."
                )

        return data


class ApplyBaselineMask(ContainerTask):
    """Apply a baseline-dependent mask (reference flagging.py:2802).

    No broadcasting: the data and mask must share axes.

    Attributes
    ----------
    share : "all" | "none" | "vis" | "map"
        Dataset sharing with the input container.
    """

    share = config.enum(["none", "vis", "map", "all"], default="all")

    def process(self, data, mask):
        """Zero the weights where the mask is True."""
        if isinstance(mask, containers.BaselineMask):
            if not hasattr(data, "time"):
                raise TypeError(
                    f"A time-like container is needed; received {type(data)}."
                )
        elif isinstance(mask, containers.SiderealBaselineMask):
            if not hasattr(data, "ra"):
                raise TypeError(
                    f"A sidereal-like container is needed; received {type(data)}."
                )
        else:
            raise TypeError(
                f"Require a BaselineMask or SiderealBaselineMask. "
                f"Got {type(mask)}."
            )

        if not np.array_equal(np.asarray(data.stack), np.asarray(mask.stack)):
            raise ValueError("Data and mask disagree on the baseline axis.")

        out = _writable_copy(data, self.share)
        out.weight[:] = (
            np.asarray(out.weight[:])
            * (~np.asarray(mask.mask[:])).astype(np.float32)
        ).astype(out.weight.dtype)
        return out


# ---------------------------------------------------------------------------
# Mask axis conversion / reduction (reference flagging.py:3433-3846)
# ---------------------------------------------------------------------------


class RFIMaskSiderealRegridderNearest(ContainerTask):
    """Convert an RFI mask's time axis to RA (reference flagging.py:3433).

    Attributes
    ----------
    spread_factor : float
        Conservative spreading width in RA bins.
    npix : int
        RA bins covering [0, 360).
    single_CSD : bool
        Keep only the main CSD of the input.
    """

    spread_factor = config.float_prop(1)
    npix = config.int_prop(4096)
    single_CSD = config.bool_prop(True)

    def setup(self, manager):
        """Set the observer used for the time -> LSA mapping."""
        self.observer = io.get_telescope(manager)

    def process(self, rfimask):
        """Regrid the mask onto the RA axis."""
        if isinstance(rfimask, containers.LocalizedRFIMask):
            to_type = containers.LocalizedSiderealRFIMask
        elif isinstance(rfimask, containers.RFIMask):
            to_type = containers.SiderealRFIMask
        else:
            raise TypeError(
                f"Expected LocalizedRFIMask or RFIMask input. "
                f"Got {type(rfimask)}."
            )

        from_ax = self.observer.unix_to_lsa(np.asarray(rfimask.time))

        if self.single_CSD:
            # LSA wraps at day boundaries: two wraps bracket one full day
            wraps = np.flatnonzero(np.diff(from_ax) < 0)
            if len(wraps) < 2:
                raise ValueError("The input does not span one whole sidereal day.")
            if len(wraps) > 2:
                raise ValueError("The input spans multiple sidereal days; expected one.")
            from_ax = from_ax.copy()
            from_ax[: wraps[0]] = -1
            from_ax[wraps[1] + 1 :] = -1

        return _convert_axis_nearest_interpolation(
            stream=rfimask,
            to_type=to_type,
            from_ax_name="time",
            to_ax_name="ra",
            from_ax=from_ax,
            to_ax=np.linspace(0, 360, self.npix, endpoint=False),
            spread_factor=self.spread_factor,
        )


class RFIMaskTimeRegridderNearest(ContainerTask):
    """Align an RFI mask's time axis to a target stream's.

    (reference flagging.py:3518)

    Attributes
    ----------
    spread_factor : float
        Conservative spreading width in time-resolution units.
    """

    spread_factor = config.float_prop(1.0)

    def setup(self, tstream):
        """Save the target time axis."""
        try:
            self.target_time = np.asarray(tstream.time)
        except AttributeError as exc:
            raise TypeError(
                f"Expected a time-like stream for reference time. "
                f"Got {type(tstream)}."
            ) from exc

    def process(self, rfimask):
        """Regrid the mask onto the target time axis."""
        return _convert_axis_nearest_interpolation(
            stream=rfimask,
            to_type=type(rfimask),
            from_ax_name="time",
            to_ax_name="time",
            from_ax=np.asarray(rfimask.time),
            to_ax=self.target_time,
            spread_factor=self.spread_factor,
        )


class ReduceMaskEl(ContainerTask):
    """Collapse the el axis of a localized RFI mask (reference flagging.py:3573).

    Attributes
    ----------
    el_threshold : int
        Minimum number of flagged el samples to flag the output.
    """

    el_threshold = config.int_prop(1)

    def process(self, rfimask):
        """Produce the el-collapsed RFI mask."""
        if not isinstance(
            rfimask,
            (containers.LocalizedRFIMask, containers.LocalizedSiderealRFIMask),
        ):
            raise ValueError(
                "Input class must be LocalizedRFIMask or "
                f"LocalizedSiderealRFIMask. Got {type(rfimask)}."
            )

        mask = np.asarray(rfimask.mask[:])
        el_axis = list(rfimask.mask.attrs["axis"]).index("el")
        freq_map = rfimask.index_map["freq"]

        reduced_mask = np.sum(mask, axis=el_axis) >= self.el_threshold

        if isinstance(rfimask, containers.LocalizedRFIMask):
            output = containers.RFIMask(
                freq=freq_map, time=np.asarray(rfimask.time)
            )
        else:
            output = containers.SiderealRFIMask(
                freq=freq_map, ra=np.asarray(rfimask.ra)
            )

        output.mask[:] = reduced_mask
        return output


class ApplyLocalizedRFIMask(ContainerTask):
    """Apply an el-sensitive RFI mask to a RingMap (reference flagging.py:3640).

    Attributes
    ----------
    share : "all" | "none" | "map"
        Dataset sharing with the input container.
    """

    share = config.enum(["none", "map", "all"], default="all")

    def process(self, tstream, rfimask):
        """Zero the weights in overlapping (freq, ra, el) regions."""
        if not isinstance(tstream, containers.RingMap):
            raise TypeError(f"A RingMap is needed here, not {type(tstream)}.")
        if not isinstance(rfimask, containers.LocalizedSiderealRFIMask):
            raise TypeError(
                f"The mask must be a LocalizedSiderealRFIMask, not {type(rfimask)}."
            )

        if not np.array_equal(np.asarray(tstream.freq), np.asarray(rfimask.freq)):
            raise ValueError("Stream and mask disagree on the freq axis.")

        def overlap(name, a, b):
            _, ia, ib = np.intersect1d(
                np.asarray(a), np.asarray(b), return_indices=True
            )
            if ia.size == 0:
                raise ValueError(
                    f"The stream and mask {name} ranges do not overlap."
                )
            return ia, ib

        s_ra, m_ra = overlap("RA", tstream.ra, rfimask.ra)
        s_el, m_el = overlap(
            "el", tstream.index_map["el"], rfimask.index_map["el"]
        )

        mask = np.asarray(rfimask.mask[:])[np.newaxis]  # [1, freq, ra, el]
        nfreq = mask.shape[1]
        npol = tstream.weight.shape[0]
        every_freq = np.arange(nfreq)

        out = _writable_copy(tstream, self.share)
        w = np.asarray(out.weight[:])
        w[np.ix_(np.arange(npol), every_freq, s_ra, s_el)] *= (
            ~mask[np.ix_([0], every_freq, m_ra, m_el)]
        ).astype(np.float32)
        out.weight[:] = w
        return out


def _convert_axis_nearest_interpolation(
    stream, to_type, from_ax_name, to_ax_name, from_ax, to_ax, spread_factor
):
    """Generic axis conversion by nearest-neighbour interpolation.

    (reference flagging.py:3731-3846).  Boolean datasets spread
    conservatively (OR over the window); numeric datasets average.
    """
    from .sidereal import _search_nearest

    res_to = np.median(np.abs(np.diff(to_ax)))
    res_from = np.median(np.abs(np.diff(from_ax)))

    upsampling = res_to < res_from
    nearest_indices = (
        _search_nearest(from_ax, to_ax)
        if upsampling
        else np.arange(len(from_ax))
    )

    dist = np.abs(to_ax[:, np.newaxis] - from_ax[nearest_indices][np.newaxis, :])

    if np.all(np.diag(dist) == 0):
        spread_factor = 0

    resolution = np.median(np.abs(np.diff(from_ax)))
    # Inclusive: with exactly-aligned axes (spread_factor forced to 0
    # above) the window must keep the zero-distance diagonal — the
    # documented nearest-neighbour pass-through.  A strict < (as in the
    # reference implementation, contradicting its own docstring) makes
    # the window all-False and silently erases every dataset.
    window = dist <= spread_factor * resolution

    axes = {}
    for ax in to_type.axes_spec():
        name = ax
        if ax == to_ax_name:
            axes[name] = to_ax
        elif ax in stream.index_map:
            axes[name] = np.asarray(stream.index_map[ax])
    out = to_type(attrs_from=stream, **axes)

    for dname in list(stream.datasets):
        ds = stream.datasets[dname]
        data = np.array(ds[:])
        ax_idx = list(ds.attrs["axis"]).index(from_ax_name)
        data = np.moveaxis(data, ax_idx, 0)

        if data.dtype == np.bool_:
            converted = (
                np.tensordot(window, data[nearest_indices], axes=([1], [0])) > 0
            )
        else:
            fwin = window.astype(np.float32)
            numerator = np.tensordot(
                fwin, data[nearest_indices], axes=([1], [0])
            )
            denominator = np.sum(fwin, axis=-1).reshape(
                (-1,) + (1,) * (numerator.ndim - 1)
            )
            converted = numerator * np.asarray(invert_no_zero(denominator))

        if dname not in out.datasets:
            out.add_dataset(dname)

        ax_idx = list(out.datasets[dname].attrs["axis"]).index(to_ax_name)
        converted = np.moveaxis(converted, 0, ax_idx)
        out[dname][:] = converted.astype(out.datasets[dname].dtype)

    return out
