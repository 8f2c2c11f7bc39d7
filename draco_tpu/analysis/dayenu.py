"""DAYENU delay and m-mode filtering tasks (arXiv:2004.11397).

Re-provides reference ``draco/analysis/dayenu.py`` (DayenuDelayFilter:20,
DayenuDelayFilterFixedCutoff:195, DayenuDelayFilterHybridVis:407,
ApplyDelayFilterHybridVis:575, ApplyDelayFilterHybridVisSingleSource:742,
DayenuDelayFilterMap:776, DayenuMFilter:977).

Device-first restructuring: the reference loops over baselines / times / els
and pinvs one masked covariance per step on the host.  Here the host only
does the grouping — rows sharing a (cutoff, mask) pattern are collected and
ALL their filters are built in one batched device ``jnp.linalg.pinv``; the
filter application is a batched device matmul per group.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import dayenu as dayenu_ops
from ..ops.tools import invert_no_zero
from . import transform

C_LIGHT = 299792458.0


def _atten_flag(NF, threshold):
    """Low-attenuation frequency flag from a filter diagonal.

    (reference dayenu.py:149-155)
    """
    diag = np.abs(np.diag(NF))
    nz = diag > 0.0
    if not np.any(nz):
        return np.zeros_like(diag, dtype=bool)
    med = np.median(diag[nz])
    return diag > (threshold * med)


def _grouped_highpass_filters(freq, cuts, masks, epsilon):
    """Batched filter construction for unique (cut, mask) pairs.

    Parameters
    ----------
    freq : [nfreq]
    cuts : [nrow] delay cutoffs (microseconds)
    masks : [nrow, nfreq] bool valid-frequency masks
    epsilon : stop-band rejection

    Returns
    -------
    NF : np.ndarray[nuniq, nfreq, nfreq]
    gid : np.ndarray[nrow] mapping each row to its filter
    """
    keys = {}
    gid = np.zeros(len(cuts), dtype=int)
    uniq = []
    for i, (c, m) in enumerate(zip(np.round(cuts, 6), masks)):
        k = (c, m.tobytes())
        if k not in keys:
            keys[k] = len(uniq)
            uniq.append((c, m))
        gid[i] = keys[k]

    dfreq = freq[:, None] - freq[None, :]
    nfreq = freq.size
    ucov = np.empty((len(uniq), nfreq, nfreq), dtype=np.float64)
    for g, (c, m) in enumerate(uniq):
        cov = np.eye(nfreq) + np.sinc(2.0 * c * dfreq) / epsilon
        mask2 = np.outer(m, m)
        ucov[g] = cov * mask2

    pinv = np.array(dayenu_ops.hermitian_pinv_batched(ucov))
    for g, (_, m) in enumerate(uniq):
        pinv[g] *= np.outer(m, m)

    return pinv, gid



@jax.jit
def _apply_m_filter_core(F_re, F_im, v_re, v_im):
    out = jnp.einsum(
        "rt,bt->br", jax.lax.complex(F_re, F_im), jax.lax.complex(v_re, v_im)
    )
    return out.real, out.imag


def _apply_m_filter(F, v):
    """Apply an m-mode filter matrix to a block of complex time series.

    Complex operands move as float pairs and combine inside the jit.
    """
    F = np.asarray(F)
    v = np.asarray(v)
    re, im = _apply_m_filter_core(
        jnp.asarray(np.ascontiguousarray(F.real)),
        jnp.asarray(np.ascontiguousarray(F.imag)),
        jnp.asarray(np.ascontiguousarray(v.real)),
        jnp.asarray(np.ascontiguousarray(v.imag)),
    )
    return np.asarray(re) + 1j * np.asarray(im)


class DayenuDelayFilter(ContainerTask):
    """Apply a DAYENU high-pass delay filter to visibility data.

    (reference dayenu.py:20-192)

    Attributes
    ----------
    za_cut : float
        Sine of the max zenith angle in the baseline-dependent delay cut
        (1 = horizon; 0 disables the baseline term).
    telescope_orientation : "NS" | "EW" | "none"
        Baseline component used for the cut.
    epsilon : float
        Stop-band rejection.  Default 1e-12.
    tauw : float
        Instrumental delay cut in microseconds.  Default 0.1.
    single_mask : bool
        Use one frequency mask for all times (frequencies valid at every
        time).  Otherwise build a filter per unique single-time mask.
    atten_threshold : float
        Mask frequencies whose filter diagonal is below this fraction of
        the median (0 disables).
    """

    za_cut = config.float_prop(1.0)
    telescope_orientation = config.enum(["NS", "EW", "none"], default="NS")
    epsilon = config.float_prop(1e-12)
    tauw = config.float_prop(0.100)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    def setup(self, telescope):
        """Set the telescope used to obtain baselines."""
        self.telescope = io.get_telescope(telescope)
        self.log.info(f"Using an instrumental delay width of {self.tauw:.3f} us.")

    def process(self, stream):
        """Filter delays from a SiderealStream or TimeStream in place."""
        freq = np.asarray(stream.freq)
        prod = stream.prodstack
        cutoff = self._get_cut(prod)

        vis = np.asarray(stream.vis[:])
        weight = np.asarray(stream.weight[:])
        nprod = vis.shape[1]

        if self.single_mask:
            # One mask per baseline: frequencies valid at ALL times
            masks = np.all(weight > 0.0, axis=-1).T  # [nprod, nfreq]
            weight *= masks.T[:, :, np.newaxis]

            valid = np.flatnonzero(np.any(masks, axis=-1))
            if valid.size:
                NF, gid = _grouped_highpass_filters(
                    freq, cutoff[valid], masks[valid], self.epsilon
                )
                var = invert_no_zero(weight)
                for g in range(NF.shape[0]):
                    rows = valid[np.flatnonzero(gid == g)]
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF[g], vis[:, rows], var[:, rows]
                    )
                    vis[:, rows] = np.asarray(fv)
                    weight[:, rows] = np.asarray(fw)
                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(NF[g], self.atten_threshold)
                        weight[:, rows] *= fl[:, np.newaxis, np.newaxis]
        else:
            var = invert_no_zero(weight)
            for bb in range(nprod):
                flag = weight[:, bb, :] > 0.0
                if not np.any(flag):
                    continue
                self.log.debug(
                    f"Filter baseline {bb} of {nprod}. "
                    f"[{cutoff[bb]:0.3f} micro-sec]"
                )
                try:
                    NF, index = dayenu_ops.highpass_delay_filter(
                        freq, cutoff[bb], flag, epsilon=self.epsilon
                    )
                except np.linalg.LinAlgError as exc:
                    self.log.error(
                        f"Failed to converge on baseline {bb}: {exc}"
                    )
                    weight[:, bb] = 0.0
                    continue
                for ii, ind in enumerate(index):
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF[ii], vis[:, bb, ind], var[:, bb, ind]
                    )
                    vis[:, bb, ind] = np.asarray(fv)
                    weight[:, bb, ind] = np.asarray(fw)
                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(NF[ii], self.atten_threshold)
                        weight[:, bb, ind] *= fl[:, np.newaxis]

        stream.vis[:] = vis.astype(stream.vis.dtype)
        stream.weight[:] = weight.astype(stream.weight.dtype)
        return stream

    def _get_cut(self, prod):
        """Baseline-dependent delay cutoff (reference dayenu.py:177)."""
        baselines = (
            self.telescope.feedpositions[prod["input_a"], :]
            - self.telescope.feedpositions[prod["input_b"], :]
        )
        if self.telescope_orientation == "NS":
            baselines = abs(baselines[:, 1])
        elif self.telescope_orientation == "EW":
            baselines = abs(baselines[:, 0])
        else:
            baselines = np.sqrt(np.sum(baselines**2, axis=-1))

        return 1e6 * self.za_cut * baselines / C_LIGHT + self.tauw


class DayenuDelayFilterFixedCutoff(transform.ReduceChisq):
    """DAYENU high-pass with one cutoff for all baselines.

    (reference dayenu.py:195-404).  Groups times by their frequency mask so
    all filters build in one batched pinv; optionally reduces over the
    stack axis to a chi-squared-per-dof statistic.

    Attributes
    ----------
    epsilon, tauw, single_mask, atten_threshold
        As in :class:`DayenuDelayFilter` (tauw default 0.45 microseconds).
    reduce_baseline : bool
        Return chi-squared per dof over baselines after filtering.
    mask_short : float
        Mask baselines shorter than this many metres (needs a telescope).
    """

    epsilon = config.float_prop(1e-12)
    tauw = config.float_prop(0.450)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    reduce_baseline = config.bool_prop(False)
    mask_short = config.float_prop(None)

    dataset = "vis"
    axes = ("stack",)

    def setup(self, telescope=None):
        """Set the telescope model (only needed to mask short baselines)."""
        self.tel = None if telescope is None else io.get_telescope(telescope)
        if self.tel is None and self.mask_short is not None:
            raise RuntimeError(
                "Short-baseline masking needs a telescope model at setup."
            )

    def process(self, stream):
        """Filter delays below the cutoff; optionally reduce over stack."""
        freq = np.asarray(stream.freq)

        vis = np.asarray(stream.vis[:])
        weight = np.asarray(stream.weight[:])
        ntime = vis.shape[2]

        if self.reduce_baseline:
            out = self._make_output_container(stream)
            out.add_dataset(self.dataset)
            for dset in out.datasets.values():
                dset[:] = np.zeros(dset.shape, dtype=dset.dtype)
            ovis = np.asarray(out.vis[:])
            oweight = np.asarray(out.weight[:])
        else:
            out = stream
            ovis = vis
            oweight = weight

        baseline_flag = np.any(weight > 0.0, axis=(0, 2))
        if self.mask_short is not None:
            baseline_flag &= (
                np.sqrt(np.sum(self.tel.baselines**2, axis=1)) >= self.mask_short
            )
        if not np.any(baseline_flag):
            self.log.error("No valid baselines remain after flagging.")
            return None

        valid = np.flatnonzero(baseline_flag)
        if not self.reduce_baseline:
            oweight[:, np.flatnonzero(~baseline_flag), :] = 0.0

        var = invert_no_zero(weight)

        if self.single_mask:
            # [ntime, nfreq] masks: frequencies valid for ALL valid baselines
            masks = np.all(weight[:, valid, :] > 0.0, axis=1).T
            good_t = np.flatnonzero(np.any(masks, axis=-1))
            if not self.reduce_baseline:
                oweight[:, :, np.flatnonzero(~np.any(masks, axis=-1))] = 0.0
            if good_t.size:
                NF, gid = _grouped_highpass_filters(
                    freq,
                    np.full(good_t.size, self.tauw),
                    masks[good_t],
                    self.epsilon,
                )
                for g in range(NF.shape[0]):
                    tind = good_t[np.flatnonzero(gid == g)]
                    sel = np.ix_(
                        range(vis.shape[0]), valid, tind
                    )
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF[g], vis[sel], var[sel]
                    )
                    from ..ops.tools import device_to_numpy

                    fv, fw = device_to_numpy(fv), np.asarray(fw)
                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(NF[g], self.atten_threshold)
                        fw *= fl[:, np.newaxis, np.newaxis]
                    if self.reduce_baseline:
                        rv, rw = self.reduction_device(fv, fw, 1)
                        ovis[:, :, tind] = device_to_numpy(rv)
                        oweight[:, :, tind] = device_to_numpy(rw)
                    else:
                        ovis[sel] = fv
                        oweight[sel] = fw
        else:
            for tt in range(ntime):
                tweight = weight[:, valid, tt]
                flag = tweight > 0.0
                if not np.any(flag):
                    oweight[:, :, tt] = 0.0
                    continue
                try:
                    NF, index = dayenu_ops.highpass_delay_filter(
                        freq, self.tauw, flag, epsilon=self.epsilon
                    )
                except np.linalg.LinAlgError as exc:
                    self.log.error(f"Failed to converge at time {tt}: {exc}")
                    oweight[:, :, tt] = 0.0
                    continue

                tvis = vis[:, valid, tt]
                tvar = var[:, valid, tt]
                tempv = np.zeros_like(tvis)
                tempw = np.zeros_like(tweight)
                for ii, ind in enumerate(index):
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF[ii], tvis[:, ind], tvar[:, ind]
                    )
                    fv, fw = np.asarray(fv), np.asarray(fw)
                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(NF[ii], self.atten_threshold)
                        fw *= fl[:, np.newaxis]
                    tempv[:, ind] = fv
                    tempw[:, ind] = fw

                if self.reduce_baseline:
                    rv, rw = self.reduction(tempv, tempw, 1)
                    ovis[:, :, tt] = rv
                    oweight[:, :, tt] = rw
                else:
                    ovis[:, valid, tt] = tempv
                    oweight[:, valid, tt] = tempw

        out.vis[:] = ovis.astype(out.vis.dtype)
        out.weight[:] = oweight.astype(out.weight.dtype)
        return out


class DayenuDelayFilterHybridVis(ContainerTask):
    """DAYENU high-pass filter for hybrid beamformed visibilities.

    (reference dayenu.py:407-572)

    Attributes
    ----------
    tauw, tauc, epsilon : float or [nstopband] lists
        Stop-band half-width / centre (microseconds) and rejection.
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    apply_filter, save_filter, calculate_cov : bool
        Apply the filter / store it in the container / store the
        freq-freq noise covariance.
    """

    tauw = config.Property(proptype=np.atleast_1d, default=0.4)
    tauc = config.Property(proptype=np.atleast_1d, default=0.0)
    epsilon = config.Property(proptype=np.atleast_1d, default=1e-12)

    atten_threshold = config.float_prop(0.0)
    apply_filter = config.bool_prop(True)
    save_filter = config.bool_prop(False)
    calculate_cov = config.bool_prop(False)

    def setup(self):
        """Validate the apply/save combination."""
        if not self.apply_filter and not self.save_filter:
            raise RuntimeError(
                "Enable `save_filter`, `apply_filter`, or both — not neither."
            )

    def process(self, stream):
        """Filter a HybridVisStream in place."""
        is_complex = np.any(np.abs(self.tauc) > 0.0)

        if self.save_filter:
            name = "complex_filter" if is_complex else "filter"
            if name not in stream.datasets:
                stream.add_dataset(name)
            stream.filter[:] = np.zeros(
                stream.filter.shape, dtype=stream.filter.dtype
            )
        if self.calculate_cov:
            name = "complex_freq_cov" if is_complex else "freq_cov"
            if name not in stream.datasets:
                stream.add_dataset(name)
            stream.freq_cov[:] = np.zeros(
                stream.freq_cov.shape, dtype=stream.freq_cov.dtype
            )

        freq = np.asarray(stream.freq)

        vis = np.asarray(stream.vis[:])
        weight = np.asarray(stream.weight[:])
        filt = np.asarray(stream.filter[:]) if self.save_filter else None
        fcov = np.asarray(stream.freq_cov[:]) if self.calculate_cov else None

        npol, _, new, _, ntime = vis.shape

        # One filter build for ALL (ew, time) cells: delay_filter groups
        # identical flag patterns internally, so the typical stream (a
        # handful of distinct masks) gets a few batched device eigh
        # calls instead of new * ntime sequential ones.
        flag_all = np.all(weight > 0.0, axis=0)  # [nfreq, new, ntime]
        flag_cols = flag_all.reshape(len(freq), -1)
        any_valid = flag_cols.any(axis=0)
        NF, index = dayenu_ops.delay_filter(
            freq,
            flag_cols[:, any_valid] if any_valid.any() else flag_cols[:, :1],
            tau_width=self.tauw,
            tau_centre=self.tauc,
            epsilon=self.epsilon,
        )
        col_of = np.flatnonzero(any_valid)
        group_of = np.full(flag_cols.shape[1], -1)
        for g, cols in enumerate(index):
            group_of[col_of[cols]] = g

        for tt in range(ntime):
            for xx in range(new):
                g = group_of[xx * ntime + tt]
                if g < 0:
                    continue

                for pp in range(npol):
                    if self.save_filter:
                        filt[pp, :, :, xx, tt] = NF[g]
                    if not self.apply_filter:
                        continue

                    tvar = invert_no_zero(weight[pp, :, xx, tt])
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF[g], vis[pp, :, xx, :, tt], tvar
                    )
                    vis[pp, :, xx, :, tt] = np.asarray(fv)
                    weight[pp, :, xx, tt] = np.asarray(fw)

                    if self.calculate_cov:
                        fcov[pp, :, :, xx, tt] = np.matmul(
                            NF[g] * tvar, NF[g].T.conj()
                        )

                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(NF[g], self.atten_threshold)
                        weight[pp, :, xx, tt] *= fl.astype(weight.dtype)

        stream.vis[:] = vis.astype(stream.vis.dtype)
        stream.weight[:] = weight.astype(stream.weight.dtype)
        if self.save_filter:
            stream.filter[:] = filt.astype(stream.filter.dtype)
        if self.calculate_cov:
            stream.freq_cov[:] = fcov.astype(stream.freq_cov.dtype)
        return stream


class ApplyDelayFilterHybridVis(ContainerTask):
    """Apply a previously saved DAYENU filter to hybrid visibilities.

    (reference dayenu.py:575-739).  Used to push the foreground filter
    through a 21-cm simulation.

    Attributes
    ----------
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    calculate_cov : bool
        Store the freq-freq noise covariance.
    copy_weight : bool
        Copy weights from the filter container instead of propagating.
    copy_tag : bool
        Copy the tag from the filter container.
    """

    atten_threshold = config.float_prop(0.0)
    calculate_cov = config.bool_prop(False)
    copy_weight = config.bool_prop(False)
    copy_tag = config.bool_prop(False)

    def process(self, hv, source):
        """Apply ``source``'s filter to ``hv``."""
        for axis, get in [
            ("freq", lambda c: c.freq),
            ("el", lambda c: c.index_map["el"]),
            ("ew", lambda c: c.index_map["ew"]),
            ("pol", lambda c: c.index_map["pol"]),
            ("ra", lambda c: c.ra),
        ]:
            if not np.array_equal(np.asarray(get(source)), np.asarray(get(hv))):
                raise ValueError(
                    f"{axis} axes do not match for hybrid visibilities."
                )

        if self.copy_tag:
            hv.attrs["tag"] = source.attrs["tag"]

        if self.calculate_cov:
            # dtype check only — materialising the full filter array
            # here would read tens of GB just to inspect its kind
            name = (
                "complex_freq_cov"
                if source.filter.dtype.kind == "c"
                else "freq_cov"
            )
            if name not in hv.datasets:
                hv.add_dataset(name)
            hv.freq_cov[:] = np.zeros(hv.freq_cov.shape, dtype=hv.freq_cov.dtype)

        vis = np.asarray(hv.vis[:])
        weight = np.asarray(hv.weight[:])
        filt = np.asarray(source.filter[:])
        fcov = np.asarray(hv.freq_cov[:]) if self.calculate_cov else None

        npol, _, new, _, ntime = vis.shape

        for tt in range(ntime):
            for xx in range(new):
                for pp in range(npol):
                    flag = weight[pp, :, xx, tt] > 0.0
                    if not np.any(flag):
                        continue

                    NF = filt[pp, :, :, xx, tt]
                    valid_freq_flag = np.any(np.abs(NF) > 0.0, axis=0)
                    if not np.any(valid_freq_flag):
                        weight[pp, :, xx, tt] = 0.0
                        continue

                    missing = np.flatnonzero(valid_freq_flag & ~flag)
                    if missing.size > 0:
                        self.log.warning(
                            "Missing frequencies assumed valid during filter "
                            f"generation: {missing}"
                        )
                        weight[pp, :, xx, tt] = 0.0
                        continue

                    tvar = invert_no_zero(weight[pp, :, xx, tt])
                    fv, fw = dayenu_ops.apply_filter_freq(
                        NF, vis[pp, :, xx, :, tt], tvar
                    )
                    vis[pp, :, xx, :, tt] = np.asarray(fv)

                    if not self.copy_weight:
                        weight[pp, :, xx, tt] = np.asarray(fw)
                        if self.calculate_cov:
                            fcov[pp, :, :, xx, tt] = np.matmul(
                                NF * tvar, NF.T.conj()
                            )
                        if self.atten_threshold > 0.0:
                            fl = _atten_flag(NF, self.atten_threshold)
                            weight[pp, :, xx, tt] *= fl.astype(weight.dtype)

        if self.copy_weight:
            weight[:] = np.asarray(source.weight[:])
            if self.calculate_cov:
                fcov[:] = np.asarray(source.freq_cov[:])

        hv.vis[:] = vis.astype(hv.vis.dtype)
        hv.weight[:] = weight.astype(hv.weight.dtype)
        if self.calculate_cov:
            hv.freq_cov[:] = fcov.astype(hv.freq_cov.dtype)
        return hv


class ApplyDelayFilterHybridVisSingleSource(ApplyDelayFilterHybridVis):
    """Apply ONE saved filter to multiple datasets (reference dayenu.py:742)."""

    def setup(self, source):
        """Set the filter container."""
        self.source = source

    def process(self, hv):
        """Apply the stored filter to ``hv``."""
        return super().process(hv, self.source)


class DayenuDelayFilterMap(ContainerTask):
    """DAYENU high-pass delay filter for ring maps.

    (reference dayenu.py:776-974).  The delay cutoff may vary with map
    elevation via a DelayCutoff file; (pol, el) cells sharing a
    (cutoff, mask) pattern are filtered with one batched device matmul.

    Attributes
    ----------
    epsilon : float
        Stop-band rejection.
    filename : str
        Optional DelayCutoff container; its cutoff dataset is interpolated
        in el.
    tauw : float
        Cutoff in microseconds (fallback / out-of-range value).
    single_mask : bool
        One frequency mask for all RAs.
    atten_threshold : float
        Low-attenuation frequency masking threshold.
    """

    epsilon = config.float_prop(1e-12)
    filename = config.str_prop(None)
    tauw = config.float_prop(0.100)
    single_mask = config.bool_prop(True)
    atten_threshold = config.float_prop(0.0)

    def setup(self):
        """Build the el -> cutoff interpolator if a file was given."""
        if self.filename is not None:
            import scipy.interpolate

            fcut = containers.DelayCutoff.from_file(self.filename)
            kind = fcut.attrs.get("kind", "linear")
            self._cut_interpolator = {}
            for pp, pol in enumerate(fcut.pol):
                self._cut_interpolator[pol] = scipy.interpolate.interp1d(
                    fcut.el,
                    np.asarray(fcut.cutoff[:])[pp],
                    kind=kind,
                    bounds_error=False,
                    fill_value=self.tauw,
                )
        else:
            self._cut_interpolator = None

    def process(self, ringmap):
        """Filter delays from a RingMap in place."""
        freq = np.asarray(ringmap.freq)
        rm = np.asarray(ringmap.map[:])
        weight = np.asarray(ringmap.weight[:])

        axes = list(ringmap.map.attrs["axis"])
        # map: [beam, pol, freq, ra, el]; weight: [pol, freq, ra, el]
        npol = rm.shape[1]
        nel = rm.shape[-1]
        els = np.asarray(ringmap.index_map["el"])
        pols = np.asarray(ringmap.index_map["pol"])

        if self.single_mask:
            cells, cuts, masks = [], [], []
            for pp in range(npol):
                for ee in range(nel):
                    flag = np.all(weight[pp, :, :, ee] > 0.0, axis=-1)
                    weight[pp, :, :, ee] *= flag[:, np.newaxis]
                    if not np.any(flag):
                        continue
                    cells.append((pp, ee))
                    cuts.append(self._get_cut(els[ee], pol=_polname(pols[pp])))
                    masks.append(flag)

            if cells:
                NF, gid = _grouped_highpass_filters(
                    freq, np.asarray(cuts), np.asarray(masks), self.epsilon
                )
                var = invert_no_zero(weight)
                for ci, (pp, ee) in enumerate(cells):
                    nf = NF[gid[ci]]
                    fv, fw = dayenu_ops.apply_filter_freq(
                        nf,
                        np.moveaxis(rm[:, pp, :, :, ee], 1, 0),
                        var[pp, :, :, ee],
                    )
                    # ring maps are real; the real filter leaves a zero
                    # imaginary part on the complex transport dtype
                    rm[:, pp, :, :, ee] = np.moveaxis(np.asarray(fv).real, 0, 1)
                    fw = np.asarray(fw)
                    if self.atten_threshold > 0.0:
                        fl = _atten_flag(nf, self.atten_threshold)
                        fw *= fl[:, np.newaxis]
                    weight[pp, :, :, ee] = fw
        else:
            var = invert_no_zero(weight)
            for pp in range(npol):
                for ee in range(nel):
                    flag = weight[pp, :, :, ee] > 0.0
                    if not np.any(flag):
                        continue
                    ecut = self._get_cut(els[ee], pol=_polname(pols[pp]))
                    try:
                        NF, index = dayenu_ops.highpass_delay_filter(
                            freq, ecut, flag, epsilon=self.epsilon
                        )
                    except np.linalg.LinAlgError as exc:
                        self.log.error(
                            f"Failed to converge at el {els[ee]:0.3f}: {exc}"
                        )
                        weight[pp, :, :, ee] = 0.0
                        continue
                    for ii, rr in enumerate(index):
                        ind = rr[0] if isinstance(rr, tuple) else rr
                        # [beam, freq, nra_i] view -> [freq, beam, nra_i]
                        arr = np.moveaxis(rm[:, pp, :, :, ee][:, :, ind], 1, 0)
                        fv, fw = dayenu_ops.apply_filter_freq(
                            NF[ii], arr, var[pp, :, :, ee][:, ind]
                        )
                        fv = np.asarray(fv).real  # [freq, beam, nra_i]
                        rm[:, pp, :, :, ee][:, :, ind] = np.moveaxis(fv, 0, 1)
                        fw = np.asarray(fw)
                        if self.atten_threshold > 0.0:
                            fl = _atten_flag(NF[ii], self.atten_threshold)
                            fw *= fl[:, np.newaxis]
                        weight[pp, :, :, ee][:, ind] = fw

        ringmap.map[:] = rm.astype(ringmap.map.dtype)
        ringmap.weight[:] = weight.astype(ringmap.weight.dtype)
        return ringmap

    def _get_cut(self, el, pol=None, **kwargs):
        """Delay cutoff in microseconds (reference dayenu.py:964)."""
        if self._cut_interpolator is None:
            return self.tauw
        if pol in self._cut_interpolator:
            return float(self._cut_interpolator[pol](el))
        return float(
            np.max([func(el) for func in self._cut_interpolator.values()])
        )


def _polname(p):
    return p.decode() if isinstance(p, bytes) else str(p)


class DayenuMFilter(ContainerTask):
    """DAYENU bandpass m-mode filter (reference dayenu.py:977-1122).

    Keeps m-modes around the fringe rate of a source at declination
    ``dec``; intercylinder baselines are mixed down before low-pass
    filtering.

    Attributes
    ----------
    dec : float
        Declination (degrees) setting the pass-band centre.
    epsilon : float
        Stop-band rejection.  Default 1e-10.
    fkeep_intra, fkeep_inter : float
        Pass-band widths as fractions of the cylinder-width fringe rate.
    """

    dec = config.float_prop(40.0)
    epsilon = config.float_prop(1e-10)
    fkeep_intra = config.float_prop(0.75)
    fkeep_inter = config.float_prop(0.75)

    def setup(self, telescope):
        """Set the telescope used to obtain baselines."""
        self.telescope = io.get_telescope(telescope)

    def process(self, stream):
        """Filter m-modes from a SiderealStream in place."""
        ra = np.radians(np.asarray(stream.ra))
        freq = np.asarray(stream.freq)
        nfreq = freq.size

        prod = stream.prodstack
        baselines = (
            self.telescope.feedpositions[prod["input_a"], 0]
            - self.telescope.feedpositions[prod["input_b"], 0]
        )
        baselines = (
            np.round(baselines / self.telescope.cylinder_spacing)
            * self.telescope.cylinder_spacing
        )
        uniqb, indexb = np.unique(baselines, return_inverse=True)
        db = 0.5 * self.telescope.cylinder_spacing

        vis = np.asarray(stream.vis[:])
        weight = np.asarray(stream.weight[:])

        for ff, nu in enumerate(freq):
            flag = weight[ff, :, :] > 0.0
            gb = np.flatnonzero(np.any(flag, axis=-1))
            if gb.size == 0:
                continue

            # Mask RAs where >10% of valid baselines are masked
            flag = np.sum(flag[gb, :], axis=0, keepdims=True) > (
                0.90 * float(gb.size)
            )
            weight[ff] *= flag.astype(weight.dtype)
            if not np.any(flag):
                continue

            self.log.debug(f"DAYENU pass on channel {ff:d}/{nfreq:d}.")

            m_cut = np.abs(self._get_cut(nu, db))
            m_center_intra = 0.5 * (2.0 - self.fkeep_intra) * m_cut
            m_cut_intra = 0.5 * self.fkeep_intra * m_cut
            m_cut_inter = self.fkeep_inter * m_cut

            INTRA, _ = dayenu_ops.bandpass_mmode_filter(
                ra, m_center_intra, m_cut_intra, flag, epsilon=self.epsilon
            )
            INTER, _ = dayenu_ops.lowpass_mmode_filter(
                ra, m_cut_inter, flag, epsilon=self.epsilon
            )

            for uu, ub in enumerate(uniqb):
                iub = np.flatnonzero(indexb == uu)
                visfb = vis[ff, iub]

                if np.abs(ub) < db:
                    vis[ff, iub, :] = _apply_m_filter(INTRA[0], visfb)
                else:
                    m_center = self._get_cut(nu, ub)
                    mixer = np.exp(-1.0j * m_center * ra)[np.newaxis, :]
                    filtered = _apply_m_filter(INTER[0], visfb * mixer)
                    vis[ff, iub, :] = filtered * mixer.conj()

        stream.vis[:] = vis.astype(stream.vis.dtype)
        stream.weight[:] = weight.astype(stream.weight.dtype)
        return stream

    def _get_cut(self, freq, xsep):
        """Fringe-rate m of a source at ``self.dec`` (reference dayenu.py:1117)."""
        lmbda = C_LIGHT / (freq * 1e6)
        u = xsep / lmbda
        return dayenu_ops.instantaneous_m(
            0.0, np.radians(self.telescope.latitude), np.radians(self.dec), u, 0.0
        )
