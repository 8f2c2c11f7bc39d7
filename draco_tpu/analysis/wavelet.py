"""Wavelet power spectrum estimation.

Re-provides reference ``draco/analysis/wavelet.py``
(WaveletSpectrumEstimator:18).  The Wiener in-fill solves are batched on
device, and the CWT runs as batched device FFTs (see
:mod:`draco_tpu.ops.wavelet`) instead of host pywt.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers
from ..core.task import ContainerTask
from ..ops import wavelet as wavelet_ops
from ..ops.delay import flatten_axes


class WaveletSpectrumEstimator(ContainerTask):
    """Estimate a continuous wavelet power spectrum of the data.

    Requires the data and an estimate of its delay spectrum (used to
    Wiener in-fill masked frequencies before transforming).

    Attributes
    ----------
    dataset : str
        Dataset to transform.
    average_axis : str
        Axis the spectrum is averaged (variance taken) over.
    ndelay : int
        Number of delay scales.
    chunks : int
        Scale-bank chunks (memory control on very large inputs).
    """

    dataset = config.str_prop("vis")
    average_axis = config.str_prop()
    ndelay = config.int_prop(128)
    wavelet = config.str_prop("morl")
    chunks = config.int_prop(4)

    def process(self, data, dspec):
        """Estimate the wavelet power spectrum.

        Parameters
        ----------
        data : containers.FreqContainer
            Data with a freq axis and the averaging axis.
        dspec : containers.DelaySpectrum
            Delay spectrum whose flattened baseline axis matches the
            remaining axes of ``data``.

        Returns
        -------
        wspec : containers.WaveletSpectrum
        """
        dset_view, bl_axes = flatten_axes(
            data[self.dataset], [self.average_axis, "freq"]
        )
        weight_view, _ = flatten_axes(
            data.weight,
            [self.average_axis, "freq"],
            match_dset=data[self.dataset],
        )

        nbase = dset_view.shape[0]
        freq = np.asarray(data.freq)

        df = np.abs(freq[1] - freq[0])
        delay_scales = np.arange(1, self.ndelay + 1) / (2 * df * self.ndelay)

        # Wavelet scales, in frequency samples
        wv_scales = wavelet_ops.frequency2scale(
            delay_scales * df, wavelet=self.wavelet
        )

        wspec = containers.WaveletSpectrum(
            baseline=nbase,
            axes_from=data,
            attrs_from=data,
            delay=delay_scales,
        )
        for ax in bl_axes:
            wspec.create_index_map(ax, data.index_map[ax])
        wspec.attrs["baseline_axes"] = np.array(bl_axes)

        ds = np.asarray(dspec.spectrum[:])

        # Fourier matrix mapping delays -> frequencies
        F = np.exp(
            -2.0j
            * np.pi
            * np.asarray(dspec.index_map["delay"])[np.newaxis, :]
            * freq[:, np.newaxis]
        )

        # Batched Wiener in-fill across all baselines at once.
        from ..ops.tools import as_device

        d_all = as_device(dset_view)  # [nbase, ntime, nfreq]
        Ni_all = jnp.asarray(weight_view.mean(axis=1))  # [nbase, nfreq]
        d_infill = _wiener_infill(d_all, Ni_all, jnp.asarray(ds), as_device(F))

        # CWT + variance, chunked over the scale bank
        ws = np.zeros(wspec.spectrum.shape, dtype=np.float64)
        bounds = np.linspace(0, len(wv_scales), self.chunks + 1, dtype=int)
        for s, e in zip(bounds[:-1], bounds[1:]):
            if e <= s:
                continue
            W = wavelet_ops.cwt(
                d_infill, wv_scales[s:e], wavelet=self.wavelet, axis=-1
            )  # [nscale, nbase, ntime, nfreq]
            var = wavelet_ops.cwt_var(W, axis=2)  # [nscale, nbase, nfreq]
            ws[:, s:e] = np.moveaxis(np.asarray(var), 0, 1)

        wspec.spectrum[:] = ws
        wspec.weight[:] = np.asarray(Ni_all).astype(wspec.weight.dtype)

        return wspec


@jax.jit
def _wiener_infill(d, Ni, D, F):
    """Wiener in-fill of masked channels (reference wavelet.py:108-121).

    d : [nbase, ntime, nfreq]; Ni : [nbase, nfreq]; D : [nbase, ndelay];
    F : [nfreq, ndelay].
    """

    def one(d_b, Ni_b, D_b):
        Df = (F * D_b[None, :]) @ F.conj().T
        Ci = jnp.linalg.inv(Df) + jnp.diag(Ni_b).astype(Df.dtype)
        rhs = (Ni_b[:, None] * d_b.T).astype(Df.dtype)
        return jnp.linalg.solve(Ci, rhs).T

    return jax.vmap(one)(d, Ni, D)
