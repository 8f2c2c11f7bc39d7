"""HyFoReS bandpass gain correction.

Re-provides reference ``draco/analysis/hyforesbandpass.py``
(DelayFilterHyFoReSBandpassHybridVis:51,
DelayFilterHyFoReSBandpassHybridVisMask:346, HyFoReSBandpassHybridVis:589,
HyFoReSBandpassHybridVisMask:747,
HyFoReSBandpassHybridVisMaskKeepSource:915,
DelayFilterHyFoReSBandpassHybridVisClean:1092).

HyFoReS cross-correlates unfiltered (foreground-dominated) visibilities
with delay-filtered (signal-dominated) visibilities to estimate residual
bandpass gain errors and their window matrix; the Clean task pseudo-inverts
the window and subtracts the residuals.

Device-first: the reference's triple loops over (pol, freq/time, ew) with
per-slice vdots and matmuls (hyforesbandpass.py:212-282) collapse into
three device einsums over the full containers; the delay-filter
application is one batched einsum as well.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops.tools import as_device, device_to_numpy, invert_no_zero
from .ringmapmaker import find_grid_indices

C_LIGHT = 299792458.0


def _validate_axes(a, b):
    for axis, get in [
        ("freq", lambda c: np.asarray(c.freq)),
        ("el", lambda c: np.asarray(c.index_map["el"])),
        ("ew", lambda c: np.asarray(c.index_map["ew"])),
        ("pol", lambda c: np.asarray(c.index_map["pol"])),
        ("ra", lambda c: np.asarray(c.ra)),
    ]:
        if not np.array_equal(get(a), get(b)):
            raise ValueError(
                f"{axis} does not match for hybrid visibilities."
            )

def _get_delay_filter(hv, pf_hv):
    """The delay-filter dataset, from whichever container carries it.

    The DAYENU task stores `filter` on the stream it FILTERED (pf_hv);
    reading it from the raw input (the old behaviour) raised KeyError in
    standard pipelines.  Axis consistency is validated either way.
    """
    _validate_axes(hv, pf_hv)
    for c in (pf_hv, hv):
        try:
            return np.asarray(c.filter[:])
        except (KeyError, AttributeError):
            continue
    raise KeyError(
        "Neither input carries a delay 'filter' dataset; run the DAYENU "
        "delay filter with save_filter: true first."
    )



def _apply_filter_batch(vis, weight, filt, atten_threshold, log):
    """Apply a per-(pol, ew, time) spectral filter; one batched einsum.

    Returns (post_vis, weight) with invalidated samples zero-weighted
    (reference hyforesbandpass.py:137-191).
    """
    flag = weight > 0.0  # [pol, freq, ew, ra]
    valid_freq = np.any(np.abs(filt) > 0.0, axis=1)  # [pol, freq(g), ew, ra]

    # Samples where the filter assumed valid channels that are missing
    missing = np.any(valid_freq & ~flag, axis=1)  # [pol, ew, ra]
    empty = ~np.any(valid_freq, axis=1)
    bad = missing | empty
    if missing.any():
        log.warning(
            f"{missing.sum()} (pol, ew, ra) samples are missing frequencies "
            "that were assumed valid during filter generation."
        )

    weight = weight * ~bad[:, np.newaxis]

    # complex data moves as float pairs and combines inside the jit
    pr, pi = _filter_apply_core(
        jnp.asarray(np.ascontiguousarray(np.asarray(filt).real)),
        jnp.asarray(np.ascontiguousarray(np.asarray(filt).imag)),
        jnp.asarray(np.ascontiguousarray(np.asarray(vis).real)),
        jnp.asarray(np.ascontiguousarray(np.asarray(vis).imag)),
    )
    post_vis = np.asarray(pr) + 1j * np.asarray(pi)
    post_vis *= ~bad[:, np.newaxis, :, np.newaxis, :]

    if atten_threshold > 0.0:
        diag = np.abs(np.einsum("pffxt->pfxt", filt))
        nz = diag > 0.0
        med = np.where(
            np.any(nz, axis=1, keepdims=True),
            np.nanmedian(np.where(nz, diag, np.nan), axis=1, keepdims=True),
            0.0,
        )
        med = np.nan_to_num(med)
        flag_low = diag > (atten_threshold * med)
        weight = weight * flag_low.astype(weight.dtype)
        post_vis = post_vis * flag_low[:, :, :, np.newaxis, :]

    return post_vis, weight


def _estimate_gains_window(vis, post_vis, weight, filt, el_mask):
    """HyFoReS gain + window estimation as three device einsums.

    (reference hyforesbandpass.py:196-294).  Complex inputs/outputs move
    as float pairs; the math runs as one jitted program (dtype follows
    the x64 config: f64 on CPU truth runs, f32 on accelerators).
    """

    def pair(x):
        x = np.asarray(x)
        return (
            jnp.asarray(np.ascontiguousarray(x.real)),
            jnp.asarray(np.ascontiguousarray(x.imag)),
        )

    yr, yi, Wr, Wi = _gains_window_core(
        *pair(vis),
        *pair(post_vis),
        jnp.asarray((np.asarray(weight) > 0.0).astype(np.float64)),
        jnp.asarray(np.asarray(el_mask).astype(np.float64)),
        *pair(filt),
    )
    return (
        np.asarray(yr) + 1j * np.asarray(yi),
        np.asarray(Wr) + 1j * np.asarray(Wi),
    )


@jax.jit
def _freq_cov_core(f_re, f_im, cvar):
    """Filtered frequency-frequency covariance NF C NF^H (fused)."""
    filt = jax.lax.complex(f_re, f_im)
    out = jnp.einsum(
        "pfgxt,pgxt,phgxt->pfhxt", filt, cvar.astype(filt.dtype), filt.conj()
    )
    return out.real, out.imag


@jax.jit
def _filter_apply_core(f_re, f_im, v_re, v_im):
    """One fused spectral-filter application (see transport rules)."""
    out = jnp.einsum(
        "pfgxt,pgxet->pfxet",
        jax.lax.complex(f_re, f_im),
        jax.lax.complex(v_re, v_im),
    )
    return out.real, out.imag


@jax.jit
def _gains_window_core(v_re, v_im, pv_re, pv_im, wm, el, f_re, f_im):
    v = jax.lax.complex(v_re, v_im)
    pv = jax.lax.complex(pv_re, pv_im)
    filt = jax.lax.complex(f_re, f_im)

    m = wm[:, :, :, None, :] * el[None, None, None, :, None]
    pv_m = pv * m.astype(pv.dtype)
    fg = v * m.astype(v.dtype) - pv_m

    yN = jnp.einsum("pfxet,pfxet->pxf", fg.conj(), pv_m)
    D = jnp.einsum("pfxet,pfxet->pxf", fg.conj(), fg)
    N = jnp.einsum("pfxet,pgxet,pfgxt->pxfg", fg.conj(), fg, filt)

    y = yN * invert_no_zero(D)
    W = N * invert_no_zero(D)[:, :, :, None]
    return y.real, y.imag, W.real, W.imag


class DelayFilterHyFoReSBandpassHybridVis(ContainerTask):
    """Estimate bandpass gains + window from unfiltered hybrid vis.

    (reference hyforesbandpass.py:51-343).  Applies the stored DAYENU
    filter, then cross-correlates the filtered and unfiltered data.

    Attributes
    ----------
    atten_threshold : float
        Mask channels whose filter diagonal is below this fraction of the
        median (0 disables).
    """

    atten_threshold = config.float_prop(0.0)

    def setup(self, manager):
        """Extract the minimum NS baseline separation (for alias masking)."""
        telescope = io.get_telescope(manager)
        index = find_grid_indices(telescope.baselines)
        self.min_ysep = index[3]

    def process(self, hv, source):
        """Apply the DAYENU filter then estimate the gains and window."""
        _validate_axes(source, hv)

        vis = np.asarray(hv.vis[:])
        weight = np.asarray(hv.weight[:]).copy()
        filt = np.asarray(source.filter[:])

        post_vis, weight = _apply_filter_batch(
            vis, weight, filt, self.atten_threshold, self.log
        )

        el_mask = self.aliased_el_mask(hv)
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, el_mask)

        return self._pack(hv, y, W)

    def _pack(self, hv, y, W):
        bp_gain_win = containers.VisBandpassWindowBaseline(
            pol=hv.index_map["pol"],
            ew=hv.index_map["ew"],
            freq=hv.index_map["freq"],
        )
        bp_gain_win.bandpass[:] = y
        bp_gain_win.window[:] = W
        return bp_gain_win

    def aliased_el_mask(self, hv):
        """Mask |sin(za)| beyond the aliased horizon (reference :307)."""
        freq = np.max(np.asarray(hv.freq))
        horizon_limit = self.get_horizon_limit(freq)
        el = np.asarray(hv.index_map["el"])
        return np.abs(el) < horizon_limit

    def get_horizon_limit(self, freq):
        """sin(za) where the southern horizon aliases (reference :328)."""
        return C_LIGHT / (freq * 1e6 * self.min_ysep) - 1.0


class DelayFilterHyFoReSBandpassHybridVisMask(DelayFilterHyFoReSBandpassHybridVis):
    """As the base task, with a sidelobe pixel mask.

    (reference hyforesbandpass.py:346-586)
    """

    def process(self, hv, source, maskf):
        """Apply the pixel mask, the DAYENU filter, then HyFoReS."""
        _validate_axes(source, hv)

        vis = np.asarray(hv.vis[:]).copy()
        weight = np.asarray(hv.weight[:]).copy()
        filt = np.asarray(source.filter[:])

        post_vis, weight = _apply_filter_batch(
            vis, weight, filt, self.atten_threshold, self.log
        )

        # RingMapMask is (pol, freq, ra, el): swap to (pol, freq, el, ra)
        mask = np.swapaxes(np.asarray(maskf.mask[:]), -1, -2)
        keep = ~mask[:, :, np.newaxis, :, :]
        post_vis = post_vis * keep
        vis = vis * keep

        el_mask = self.aliased_el_mask(hv)
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, el_mask)
        return self._pack(hv, y, W)


class HyFoReSBandpassHybridVis(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS on pre-filtered inputs (no internal delay filter).

    (reference hyforesbandpass.py:589-744)
    """

    def process(self, hv, pf_hv):
        """Estimate the gains and window from (pre, post)-filtered data."""
        vis = np.asarray(hv.vis[:])
        post_vis = np.asarray(pf_hv.vis[:])
        weight = np.asarray(pf_hv.weight[:])
        filt = _get_delay_filter(hv, pf_hv)

        el_mask = self.aliased_el_mask(hv)
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, el_mask)
        return self._pack(hv, y, W)


class HyFoReSBandpassHybridVisMask(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS on pre-filtered inputs with a sidelobe pixel mask.

    (reference hyforesbandpass.py:747-912)
    """

    def process(self, hv, pf_hv, maskf):
        """Estimate the gains and window, masking flagged pixels."""
        vis = np.asarray(hv.vis[:]).copy()
        post_vis = np.asarray(pf_hv.vis[:]).copy()
        weight = np.asarray(pf_hv.weight[:])
        filt = _get_delay_filter(hv, pf_hv)

        mask = np.swapaxes(np.asarray(maskf.mask[:]), -1, -2)
        keep = ~mask[:, :, np.newaxis, :, :]
        post_vis = post_vis * keep
        vis = vis * keep

        el_mask = self.aliased_el_mask(hv)
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, el_mask)
        return self._pack(hv, y, W)


class HyFoReSBandpassHybridVisMaskKeepSource(DelayFilterHyFoReSBandpassHybridVis):
    """HyFoReS masking source sidelobes while keeping main lobes.

    (reference hyforesbandpass.py:915-1089)
    """

    def process(self, hv, pf_hv, maskf, masksf):
        """Estimate gains and window keeping source main lobes."""
        vis = np.asarray(hv.vis[:]).copy()
        post_vis = np.asarray(pf_hv.vis[:]).copy()
        weight = np.asarray(pf_hv.weight[:])
        filt = _get_delay_filter(hv, pf_hv)

        mask = np.swapaxes(np.asarray(maskf.mask[:]), -1, -2)
        masks = np.swapaxes(np.asarray(masksf.mask[:]), -1, -2)
        keep = ~np.logical_and(
            mask[:, :, np.newaxis, :, :], ~masks[:, :, np.newaxis, :, :]
        )
        post_vis = post_vis * keep
        vis = vis * keep

        el_mask = self.aliased_el_mask(hv)
        y, W = _estimate_gains_window(vis, post_vis, weight, filt, el_mask)
        return self._pack(hv, y, W)


class DelayFilterHyFoReSBandpassHybridVisClean(ContainerTask):
    """Compensate the bandpass window and subtract foreground residuals.

    (reference hyforesbandpass.py:1092-1292)

    Attributes
    ----------
    cutoff : float
        SVD cutoff when pseudo-inverting the window (0 disables
        compensation).
    atten_threshold : float
        Low-attenuation channel masking threshold.
    calculate_cov : bool
        Store the freq-freq noise covariance.
    """

    cutoff = config.float_prop(1e-1)
    atten_threshold = config.float_prop(0.0)
    calculate_cov = config.bool_prop(False)

    def process(self, hv, source, bp):
        """Apply the gain correction and the DAYENU filter."""
        _validate_axes(source, hv)

        if self.calculate_cov:
            name = (
                "complex_freq_cov"
                if "complex_filter" in source.datasets
                else "freq_cov"
            )
            if name not in hv.datasets:
                hv.add_dataset(name)
            hv.freq_cov[:] = np.zeros(
                hv.freq_cov.shape, dtype=hv.freq_cov.dtype
            )

        npol, nfreq, new = hv.vis.shape[:3]

        y = np.asarray(bp.bandpass[:])
        W = np.asarray(bp.window[:])

        s_val = np.zeros((npol, new, nfreq))
        rank = np.zeros((npol, new))
        g = np.zeros_like(y)

        if self.cutoff == 0.0:
            g = y
            self.log.debug("Window compensation disabled")
        else:
            # Batched SVD pinv on device.
            jW = as_device(W.reshape(-1, nfreq, nfreq))
            u, s, vh = jnp.linalg.svd(jW, full_matrices=False)
            s_val = np.asarray(s).reshape(npol, new, nfreq)
            keep = s > self.cutoff
            sinv = jnp.where(keep, invert_no_zero(s), 0.0)
            W_pinv = jnp.einsum(
                "bij,bj,bjk->bik", vh.conj().swapaxes(1, 2), sinv, u.conj().swapaxes(1, 2)
            )
            rank = np.asarray(jnp.sum(keep, axis=-1)).reshape(npol, new)
            g = device_to_numpy(
                jnp.einsum(
                    "bij,bj->bi", W_pinv, as_device(y.reshape(-1, nfreq))
                )
            ).reshape(npol, new, nfreq)
            self.log.debug("Gain window compensated")

        comp_bandpass = containers.VisBandpassCompensateBaseline(
            pol=hv.index_map["pol"],
            ew=hv.index_map["ew"],
            freq=hv.index_map["freq"],
        )
        comp_bandpass.sval[:] = s_val
        comp_bandpass.comp_bandpass[:] = g
        comp_bandpass.attrs["rank"] = rank
        comp_bandpass.attrs["cutoff"] = self.cutoff

        vis = np.asarray(hv.vis[:])
        weight = np.asarray(hv.weight[:])
        filt = np.asarray(source.filter[:])

        # Gain correction (pol, freq, ew)
        diag_m = 1 - g.transpose(0, 2, 1)  # [pol, freq, ew]
        cvis = vis * diag_m[:, :, :, np.newaxis, np.newaxis]
        cvar = (
            np.asarray(invert_no_zero(weight))
            * np.abs(diag_m[..., np.newaxis]) ** 2
        )

        fvis, new_weight = _apply_filter_batch(
            cvis, weight.copy(), filt, 0.0, self.log
        )
        # Propagate variance through |NF|^2
        fvar = np.asarray(
            jnp.einsum(
                "pfgxt,pgxt->pfxt",
                jnp.abs(as_device(filt)) ** 2,
                jnp.asarray(cvar),
            )
        )
        out_weight = np.asarray(invert_no_zero(fvar)) * (new_weight > 0)

        if self.calculate_cov:
            cr, ci = _freq_cov_core(
                jnp.asarray(np.ascontiguousarray(np.asarray(filt).real)),
                jnp.asarray(np.ascontiguousarray(np.asarray(filt).imag)),
                jnp.asarray(np.asarray(cvar)),
            )
            fcov = np.asarray(cr) + 1j * np.asarray(ci)
            hv.freq_cov[:] = fcov.astype(hv.freq_cov.dtype)

        if self.atten_threshold > 0.0:
            diag = np.abs(np.einsum("pffxt->pfxt", filt))
            nz = diag > 0.0
            med = np.where(
                np.any(nz, axis=1, keepdims=True),
                np.nanmedian(np.where(nz, diag, np.nan), axis=1, keepdims=True),
                0.0,
            )
            med = np.nan_to_num(med)
            flag_low = diag > (self.atten_threshold * med)
            out_weight = out_weight * flag_low.astype(out_weight.dtype)

        hv.vis[:] = fvis.astype(hv.vis.dtype)
        hv.weight[:] = out_weight.astype(hv.weight.dtype)

        return hv, comp_bandpass
