"""DAYENU filter construction (arXiv:2004.11397).

Re-provides reference ``draco/analysis/dayenu.py`` filter builders
(delay_filter:1125, highpass_delay_filter:1205, bandpass_mmode_filter:1235,
lowpass_mmode_filter:1296, highpass_mmode_filter:1349, instantaneous_m:1399).

A DAYENU filter is the pseudo-inverse of a covariance ``I + sum_k
sinc-window_k / eps_k`` restricted to the unmasked samples.  The reference
computes one host pinv per unique flag pattern; here the unique-flag
bookkeeping stays on the host (tiny) and all the pinvs run as ONE batched
device ``jnp.linalg.pinv`` call — the eigendecompositions batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "delay_filter",
    "highpass_delay_filter",
    "bandpass_mmode_filter",
    "lowpass_mmode_filter",
    "highpass_mmode_filter",
    "instantaneous_m",
    "batched_masked_pinv",
]


def hermitian_pinv_batched(ucov):
    """Batched Hermitian pseudo-inverse with numpy's eigenvalue cutoff.

    ``jnp.linalg.pinv(hermitian=True)`` truncates differently on the
    1e12-condition DAYENU covariances (destroying the pass band), so the
    eigendecomposition + reciprocal is done explicitly.

    The factorisation MUST run in f64: these covariances genuinely span
    ~12 decades, so an f32 eigh's cutoff (max|w| * n * eps_f32 ~ 1e7)
    would truncate every O(1) pass-band eigenvalue and turn the filter
    into ~the zero operator.  When jax x64 is off (the pipeline
    default), the eigh runs on the host in numpy instead.
    """
    import jax

    if jax.config.jax_enable_x64:
        ucov = jnp.asarray(ucov)
        w, v = jnp.linalg.eigh(ucov)
        n = ucov.shape[-1]
        cut = (
            jnp.max(jnp.abs(w), axis=-1, keepdims=True)
            * n
            * jnp.finfo(w.dtype).eps
        )
        iw = jnp.where(jnp.abs(w) > cut, 1.0 / w, 0.0)
        return (v * iw[..., None, :].astype(v.dtype)) @ v.conj().swapaxes(
            -1, -2
        )

    ucov = np.asarray(ucov, dtype=np.complex128 if np.iscomplexobj(ucov) else np.float64)
    w, v = np.linalg.eigh(ucov)
    n = ucov.shape[-1]
    cut = np.max(np.abs(w), axis=-1, keepdims=True) * n * np.finfo(w.dtype).eps
    iw = np.where(np.abs(w) > cut, 1.0 / np.where(w == 0, 1.0, w), 0.0)
    return (v * iw[..., None, :].astype(v.dtype)) @ v.conj().swapaxes(-1, -2)


def batched_masked_pinv(cov, uflag):
    """Pseudo-invert ``uflag * cov`` for each flag pattern, batched on device.

    Parameters
    ----------
    cov : np.ndarray[n, n]
        Shared covariance.
    uflag : np.ndarray[nuniq, n] bool
        Unique flag patterns (True = valid sample).

    Returns
    -------
    pinv : np.ndarray[nuniq, n, n]
        ``pinv(outer-mask * cov) * outer-mask`` for each pattern.
    """
    uflag = np.asarray(uflag, dtype=bool)
    mask2 = uflag[:, None, :] & uflag[:, :, None]
    # build on the host in f64/c128: hermitian_pinv_batched needs the
    # full dynamic range BEFORE any device-precision cast
    cov = np.asarray(cov)
    dt = np.complex128 if np.iscomplexobj(cov) else np.float64
    ucov = mask2 * cov.astype(dt)[None]
    return np.asarray(hermitian_pinv_batched(ucov)) * mask2


def delay_filter(freq, flag, tau_width, tau_centre=0.0, epsilon=1e-12):
    """Construct a (possibly multi-stopband) delay filter.

    Attenuates delays within ``[tau_centre - tau_width, tau_centre +
    tau_width]`` for each stopband (reference dayenu.py:1125-1202).

    Parameters
    ----------
    freq : np.ndarray[nfreq] in MHz.
    flag : np.ndarray[nfreq, ntime] bool — valid frequencies per time.
    tau_width, tau_centre, epsilon : scalars or [nstopband] arrays
        Stop-band half-width / centre (microseconds) and rejection.

    Returns
    -------
    pinv : np.ndarray[ntime_uniq, nfreq, nfreq]
    index : list of arrays mapping pinv[i] to the time samples it covers.
    """

    def _ensure(param, n):
        p = np.atleast_1d(param)
        if p.size == 1:
            return np.full(n, p[0])
        assert p.size == n
        return p

    args = [tau_width, tau_centre, epsilon]
    nstopband = max(np.atleast_1d(p).size for p in args)
    tw, tc, eps = (_ensure(p, nstopband) for p in args)

    dtype = np.complex128 if np.any(np.abs(tc) > 0.0) else np.float64

    freq = np.asarray(freq)
    nfreq = freq.size
    flag = np.asarray(flag, dtype=bool)
    assert flag.shape[0] == nfreq and flag.ndim == 2

    dfreq = freq[:, np.newaxis] - freq[np.newaxis, :]
    cov = np.eye(nfreq, dtype=dtype)
    for w, c, e in zip(tw, tc, eps):
        term = np.sinc(2.0 * w * dfreq) / e
        if np.abs(c) > 0.0:
            term = term * np.exp(-2.0j * np.pi * c * dfreq)
        cov += term

    uflag, uindex = np.unique(flag.T, return_inverse=True, axis=0)
    pinv = batched_masked_pinv(cov, uflag)
    index = [np.flatnonzero(uindex == uu) for uu in range(pinv.shape[0])]

    return pinv, index


def highpass_delay_filter(freq, tau_cut, flag, epsilon=1e-12):
    """High-pass delay filter with stop band [-tau_cut, tau_cut].

    (reference dayenu.py:1205-1232)
    """
    return delay_filter(freq, flag, tau_cut, 0.0, epsilon)


def _mmode_filter(ra, cov, flag):
    """Shared unique-flag + batched-pinv logic for the m-mode filters."""
    ishp = flag.shape
    nra = ra.size
    assert ishp[-1] == nra

    uflag, uindex = np.unique(
        np.asarray(flag, dtype=bool).reshape(-1, nra), return_inverse=True, axis=0
    )
    pinv = batched_masked_pinv(cov, uflag)
    index = [
        np.unravel_index(np.flatnonzero(uindex == uu), ishp[:-1])
        for uu in range(pinv.shape[0])
    ]
    return pinv, index


def bandpass_mmode_filter(ra, m_center, m_cut, flag, epsilon=1e-10):
    """Bandpass m filter, pass band [m_center - m_cut, m_center + m_cut].

    (reference dayenu.py:1235-1293)
    """
    ra = np.asarray(ra)
    a = np.median(np.abs(np.diff(ra))) * m_cut / np.pi
    aeps = a * epsilon
    dra = ra[:, np.newaxis] - ra[np.newaxis, :]

    cov = np.eye(ra.size, dtype=np.float64) / aeps
    cov += (
        2 * a * (1.0 - 1.0 / aeps) * np.sinc(m_cut * dra / np.pi) * np.cos(m_center * dra)
    )
    return _mmode_filter(ra, cov, flag)


def lowpass_mmode_filter(ra, m_cut, flag, epsilon=1e-10):
    """Low-pass m filter, pass band [-m_cut, m_cut] (reference dayenu.py:1296)."""
    ra = np.asarray(ra)
    a = np.median(np.abs(np.diff(ra))) * m_cut / np.pi
    aeps = a * epsilon
    dra = ra[:, np.newaxis] - ra[np.newaxis, :]

    cov = np.eye(ra.size, dtype=np.float64) / aeps
    cov += a * (1.0 - 1.0 / aeps) * np.sinc(m_cut * dra / np.pi)
    return _mmode_filter(ra, cov, flag)


def highpass_mmode_filter(ra, m_cut, flag, epsilon=1e-10):
    """High-pass m filter, stop band [-m_cut, m_cut] (reference dayenu.py:1349)."""
    ra = np.asarray(ra)
    dra = ra[:, np.newaxis] - ra[np.newaxis, :]

    cov = np.eye(ra.size, dtype=np.float64)
    cov += np.sinc(m_cut * dra / np.pi) / epsilon
    return _mmode_filter(ra, cov, flag)


def instantaneous_m(ha, lat, dec, u, v, w=0.0):
    """Instantaneous fringe-rate m for a baseline (reference dayenu.py:1399).

    All angles in radians; (u, v, w) in wavelengths.
    """
    deriv = u * (-1 * np.cos(dec) * np.cos(ha))
    deriv += v * (np.sin(lat) * np.cos(dec) * np.sin(ha))
    deriv += w * (-1 * np.cos(lat) * np.cos(dec) * np.sin(ha))
    return 2.0 * np.pi * deriv


def apply_filter_freq(NF, vis, var):
    """Apply an [nfreq, nfreq] filter over a leading freq axis, on device.

    Returns (filtered_vis, filtered_weight) where the weight is the
    propagated inverse variance ``1 / (|NF|^2 @ var)``.  Complex data
    moves as float pairs and combines inside the jit.
    """
    NF = np.asarray(NF)
    vis = np.asarray(vis)
    re, im, fw = _apply_filter_freq_core(
        jnp.asarray(np.ascontiguousarray(NF.real)),
        jnp.asarray(np.ascontiguousarray(NF.imag)),
        jnp.asarray(np.ascontiguousarray(vis.real)),
        jnp.asarray(np.ascontiguousarray(vis.imag)),
        jnp.asarray(np.asarray(var)),
    )
    return np.asarray(re) + 1j * np.asarray(im), np.asarray(fw)


@jax.jit
def _apply_filter_freq_core(NF_re, NF_im, v_re, v_im, var):
    from .tools import invert_no_zero

    NF = jax.lax.complex(NF_re, NF_im)
    vis = jax.lax.complex(v_re, v_im)
    fvis = jnp.tensordot(NF, vis, axes=(1, 0))
    fw = invert_no_zero(jnp.tensordot(jnp.abs(NF) ** 2, var, axes=(1, 0)))
    return fvis.real, fvis.imag, fw
