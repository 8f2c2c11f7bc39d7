"""Weighted convolution, moving-median and Fourier null-space filters.

JAX re-design of reference ``draco/util/filters.py`` (lowpass/
highpass weighted convolution:22/68, medfilt:99, null_filter:133):

* the weighted convolution filters run as zero-padded FFT convolutions on
  device (one forward/inverse FFT pair instead of the reference's
  ``scipy.signal.oaconvolve`` host loop), with the FIR prototype built as
  an explicit flattop-windowed sinc;
* the null filter assembles the masked Fourier-mode matrix and takes its
  SVD on device, selecting retained modes with a mask instead of a
  dynamic slice so the whole projector is a single compiled graph.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.signal import windows as _windows

from . import median
from .tools import invert_no_zero, window_generalised

__all__ = [
    "lowpass_weighted_convolution_filter",
    "highpass_weighted_convolution_filter",
    "medfilt",
    "null_filter",
]


def _flattop_lowpass_fir(cutoff: float, fs: float) -> np.ndarray:
    """Flattop-windowed-sinc low-pass FIR with unit DC gain.

    The prototype matches ``scipy.signal.firwin(order, cutoff,
    window="flattop", fs=fs)`` with the order chosen to span one cutoff
    period (rounded up to odd), which is the reference's kernel choice.
    """
    order = int(np.ceil(fs / cutoff) // 2 * 2 + 1)
    t = np.arange(order, dtype=np.float64) - (order - 1) / 2
    ideal = (2.0 * cutoff / fs) * np.sinc(2.0 * cutoff / fs * t)
    taps = ideal * _windows.flattop(order, sym=True)
    return taps / taps.sum()


@functools.partial(jax.jit, static_argnames=("axis", "klen"))
def _fft_convolve_same(x, taps, axis: int, klen: int):
    """Centred ("same") linear convolution along ``axis`` on device."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    nfull = n + klen - 1
    if jnp.iscomplexobj(x):
        xf = jnp.fft.fft(x, n=nfull, axis=-1)
        kf = jnp.fft.fft(taps, n=nfull).astype(xf.dtype)
        full = jnp.fft.ifft(xf * kf, n=nfull, axis=-1)
    else:
        xf = jnp.fft.rfft(x, n=nfull, axis=-1)
        kf = jnp.fft.rfft(taps, n=nfull)
        full = jnp.fft.irfft(xf * kf, n=nfull, axis=-1)
    start = (klen - 1) // 2
    out = jax.lax.slice_in_dim(full, start, start + n, axis=full.ndim - 1)
    return jnp.moveaxis(out, -1, axis)


@functools.partial(jax.jit, static_argnames=("axis", "klen"))
def _weighted_conv_kernel(d, w, k, *, axis: int, klen: int):
    num = _fft_convolve_same(d * w, k, axis, klen)
    den = _fft_convolve_same(w, k, axis, klen)
    return num * invert_no_zero(den)


def lowpass_weighted_convolution_filter(data, weight, samples, cutoff, axis=-1):
    """Weight-aware low-pass filter along ``axis`` (on device).

    Convolves ``data * weight`` and ``weight`` with a flattop-windowed
    sinc whose length spans one cutoff period, then renormalises — so
    missing (zero-weight) samples do not bias the smooth estimate.
    Semantics of reference ``draco/util/filters.py:22-65``.

    Parameters
    ----------
    data, weight : arrays broadcastable against each other
    samples : 1-D sample positions (only their median spacing matters)
    cutoff : filter cutoff in inverse sample units
    axis : axis to filter along
    """
    fs = 1.0 / np.median(np.abs(np.diff(np.asarray(samples))))
    taps = _flattop_lowpass_fir(float(cutoff), float(fs))

    # ONE jitted program
    from .tools import as_device, device_to_numpy

    data = np.asarray(data)
    d = as_device(data)
    w = jnp.asarray(
        np.ascontiguousarray(np.broadcast_to(np.asarray(weight), data.shape))
    )
    kdt = np.result_type(data.real.dtype, np.float32)
    k = jnp.asarray(taps.astype(kdt))

    ax = axis % data.ndim
    out = _weighted_conv_kernel(d, w, k, axis=ax, klen=taps.size)
    return device_to_numpy(out)


def highpass_weighted_convolution_filter(data, weight, samples, cutoff, axis=-1):
    """Complement of the low-pass filter (reference filters.py:68-96)."""
    low = lowpass_weighted_convolution_filter(data, weight, samples, cutoff, axis)
    return np.asarray(data) - low


def medfilt(x, mask, size, method: str = "split"):
    """Moving median of masked data (reference filters.py:99-130).

    Masked samples carry zero weight in the moving weighted median.
    ``method`` selects the tie convention; only the "split" convention
    (average of the two straddling values) is provided.
    """
    if method != "split":
        raise ValueError(
            f"medfilt: unsupported tie method {method!r}; only 'split' "
            "is available."
        )
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return medfilt(x.real, mask, size, method=method) + 1.0j * medfilt(
            x.imag, mask, size, method=method
        )
    xc = np.ascontiguousarray(x.astype(np.float64))
    wc = np.ascontiguousarray((~np.asarray(mask, dtype=bool)).astype(np.float64))
    return median.moving_weighted_median(xc, wc, size)


@functools.partial(
    jax.jit, static_argnames=("num_modes", "highpass", "window_name")
)
def _null_filter_device(
    samples, mask, cutoff, tol, *, num_modes, highpass, window_name
):
    n = samples.shape[0]
    fmodes = jnp.linspace(-cutoff, cutoff, num_modes)
    phase = 2.0 * jnp.pi * samples[:, None] * fmodes[None, :]
    F = mask[:, None] * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))

    if window_name is not None:
        x = (samples - samples.min()) / (samples.max() - samples.min())
        w = window_generalised(x, window=window_name)
        F = F * w[:, None]

    u, sig, _ = jnp.linalg.svd(F, full_matrices=False)
    keep = sig > tol * jnp.max(sig)
    basis = jnp.where(keep[None, :], u, 0.0)
    proj = basis @ jnp.conj(basis).T

    if highpass:
        proj = jnp.eye(n, dtype=proj.dtype) - proj
    proj = proj * mask[None, :]
    if window_name is not None:
        proj = proj * w[None, :]
    return proj.real, proj.imag


def null_filter(
    samples,
    cutoff,
    mask,
    num_modes: int = 200,
    tol: float = 1e-8,
    window=True,
    type_: str = "high",
    lapack_driver: str = "gesvd",
):
    """Projector that nulls (or keeps) Fourier modes within ``cutoff``.

    Spans ``num_modes`` modes over [-cutoff, cutoff] evaluated at the
    (possibly irregular) ``samples``, masks and optionally apodises them,
    and keeps the singular directions above ``tol`` — "high" returns the
    orthogonal complement.  Semantics of reference
    ``draco/util/filters.py:133-212``; ``lapack_driver`` is accepted for
    API parity but has no meaning for the XLA SVD.

    Returns the dense complex projector matrix.
    """
    if type_ not in {"high", "low"}:
        raise ValueError(f"type_ must be 'high' or 'low'; got {type_!r}")

    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    window_name = None
    if window:
        window_name = "nuttall" if window is True else window

    re, im = _null_filter_device(
        jnp.asarray(np.asarray(samples), dtype=fdt),
        jnp.asarray(np.asarray(mask), dtype=fdt),
        jnp.asarray(float(cutoff), dtype=fdt),
        jnp.asarray(float(tol), dtype=fdt),
        num_modes=int(num_modes),
        highpass=type_ == "high",
        window_name=window_name,
    )
    # complex dtypes are read back as separate real planes
    return np.asarray(re) + 1.0j * np.asarray(im)
