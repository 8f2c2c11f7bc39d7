"""Windowed spherical-harmonic analysis on a compact pixel support.

Beam(-product) maps of real instruments are compactly supported: a
Gaussian/Airy primary beam covers ~1% of the sphere, a cylinder beam a
narrow azimuth strip.  The full-sphere SHT the reference reaches through
``cora.util.hputil.sphtrans_sky`` (reference draco/synthesis/stream.py:85)
then wastes >95% of its ring-DFT and Legendre work on zeros.

:class:`WindowedSHT` restricts the analysis to a per-ring azimuth window
derived from a support mask: only ``Rb`` rings intersect the support and
each contributes a contiguous ``W``-pixel window (wrap-around handled), so

    F[..., r, m] = sum_w  map[..., r, w] * exp(-i m phi_{r,w})
    alm[l, m]    = sum_r  w_r * Lambda_r[l, m] * F[..., r, m]

runs as one batched [.., Rb, W] x [Rb, W, M+1] contraction plus one
Legendre GEMM over the band rings — exact up to the support truncation
(the mask threshold).  Used by
:meth:`draco_tpu.telescope.beamtransfer.BeamTransfer.generate` for the
beam-transfer hot path, with the same f32 accuracy as the full-sphere
transform.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sht import _PREC_LEG, _PREC_RING, SHT

__all__ = ["WindowedSHT", "support_fraction"]


def support_fraction(support, tau: float = 1e-9) -> float:
    """Fraction of pixels with |support| above ``tau * max``."""
    a = np.abs(np.asarray(support))
    mx = a.max()
    if mx == 0:
        return 0.0
    return float((a > tau * mx).mean())


class WindowedSHT:
    """Spherical-harmonic analysis restricted to a compact support.

    Parameters
    ----------
    s
        The full :class:`~draco_tpu.ops.sht.SHT` operator (provides
        geometry, band limits and the Legendre tensors).
    support
        [npix] array whose non-zero (above ``tau * max``) pixels define
        the support; the window is its per-ring azimuthal bounding
        interval.
    tau
        Relative support threshold.
    margin
        Extra pixels added to each side of every ring window.
    """

    def __init__(self, s: SHT, support, tau: float = 1e-9, margin: int = 2):
        # windowed ANALYSIS is a quadrature over uniformly-sampled ring
        # points, which aliases m mod nphi exactly like the full-sphere
        # transform — the band limit applies here too (a dense DFT does
        # not un-alias a discrete sum)
        s._require_analysis_band_limit()
        self.sht = s
        info = s.info
        a = np.abs(np.asarray(support, dtype=np.float64))
        if a.shape != (s.npix,):
            raise ValueError(
                f"support must be [npix={s.npix}], got {a.shape}"
            )
        thresh = tau * a.max()

        band, starts, widths = [], [], []
        for r in range(info.nring):
            o, n = int(info.offset[r]), int(info.nphi[r])
            good = np.nonzero(a[o : o + n] > thresh)[0]
            if len(good) == 0:
                continue
            if len(good) == n:
                p0, width = 0, n
            else:
                # largest gap in the cyclic index set -> the window is its
                # complement (handles wrap-around through phi = 0)
                gaps = np.diff(np.concatenate([good, [good[0] + n]]))
                k = int(np.argmax(gaps))
                p0 = int(good[(k + 1) % len(good)])
                width = n - int(gaps.max()) + 1
            band.append(r)
            starts.append(p0 - margin)
            widths.append(width + 2 * margin)
        if not band:
            raise ValueError("support mask is empty")
        self.band = np.asarray(band)
        self.Rb = len(band)
        self.W = int(max(widths))

        # Rings shorter than W (small polar rings fully inside the
        # support) would double-count pixels through the modular wrap;
        # slots beyond one full cycle get zero weight instead.
        idx = np.zeros((self.Rb, self.W), np.int64)
        phi = np.zeros((self.Rb, self.W))
        valid = np.zeros((self.Rb, self.W))
        for k, r in enumerate(self.band):
            o, n = int(info.offset[r]), int(info.nphi[r])
            p = (starts[k] + np.arange(self.W)) % n
            idx[k] = o + p
            phi[k] = info.phi0[r] + 2 * np.pi * p / n
            valid[k] = np.arange(self.W) < n
        self.window_index = idx  # [Rb, W] pixel indices

        # quadrature weight (and the wrap mask) folded into the DFT
        # factors (matches SHT._analysis_impl semantics); the [Rb, W]
        # trig tensors are built lazily on first use — the rectangular
        # and flat layouts have disjoint consumers (windowed analysis vs
        # fused/streaming projections), so an eager build of both would
        # pin ~2x the needed HBM
        self._phi_rw = phi
        self._w_rw = info.weight[self.band][:, None] * valid
        self._rect_cache = None
        self._lam_band = None
        self._lam_band2 = None

        # -- flat (ragged) layout ------------------------------------------
        # The rectangular [Rb, W] box pays for every ring at the WIDEST
        # ring's width (fill factor ~0.7 for a circular beam).  The flat
        # layout concatenates each ring's own window back-to-back, so
        # GEMM/trig work in consumers scales with the true support pixel
        # count.  Ring membership is carried per pixel (``flat_ring``)
        # plus as a one-hot [Rb, Kf] matrix so per-ring reductions run
        # as GEMMs instead of lowering to scatters.
        fidx, fring, fphi = [], [], []
        for k, r in enumerate(self.band):
            o, n = int(info.offset[r]), int(info.nphi[r])
            w_r = min(widths[k], n)
            p = (starts[k] + np.arange(w_r)) % n
            fidx.append(o + p)
            fring.append(np.full(w_r, k))
            fphi.append(info.phi0[r] + 2 * np.pi * p / n)
        fidx = np.concatenate(fidx)
        fring = np.concatenate(fring)
        fphi = np.concatenate(fphi)
        kf = len(fidx)
        kf_pad = (kf + 127) // 128 * 128
        self.Kf = kf_pad
        self.flat_index = np.concatenate(
            [fidx, np.zeros(kf_pad - kf, np.int64)]
        )
        self.flat_ring = jnp.asarray(
            np.concatenate([fring, np.zeros(kf_pad - kf)]).astype(np.int32)
        )
        self._w_k = np.concatenate(
            [info.weight[self.band][fring], np.zeros(kf_pad - kf)]
        )
        self._phi_k = np.concatenate([fphi, np.zeros(kf_pad - kf)])
        self._flat_cache = None
        onehot = np.zeros((self.Rb, kf_pad), np.float32)
        onehot[fring, np.arange(kf)] = 1.0
        self.ring_onehot = jnp.asarray(onehot)

    @staticmethod
    def _trig_f32(phi_rows, m, w_rows):
        """Weighted cos/sin(phi x m) as f32 [*rows, M+1] pairs.

        The trig runs in f64 (phi*m reaches ~5e3 rad; f32 arguments
        would lose ~3e-4 rad — the same error class the two-float
        fringe phases remove) but stages in row chunks so the f64
        intermediate never exceeds a small fraction of the output.
        """
        shape = phi_rows.shape + (m.shape[0],)
        C = np.empty(shape, np.float32)
        S = np.empty(shape, np.float32)
        flat_phi = phi_rows.reshape(-1)
        flat_w = w_rows.reshape(-1)
        Cf = C.reshape(-1, shape[-1])
        Sf = S.reshape(-1, shape[-1])
        step = max(1, (1 << 22) // max(1, shape[-1]))
        for i in range(0, flat_phi.shape[0], step):
            arg = flat_phi[i : i + step, None] * m
            w = flat_w[i : i + step, None]
            Cf[i : i + step] = np.cos(arg) * w
            Sf[i : i + step] = np.sin(arg) * w
        return C, S

    @property
    def _Ec(self):
        if self._rect_cache is None:
            m = np.arange(self.sht.mmax + 1)
            C, S = self._trig_f32(self._phi_rw, m, self._w_rw)
            self._rect_cache = (jnp.asarray(C), jnp.asarray(S))
        return self._rect_cache[0]

    @property
    def _Es(self):
        _ = self._Ec
        return self._rect_cache[1]

    @property
    def _Ecf(self):
        if self._flat_cache is None:
            m = np.arange(self.sht.mmax + 1)
            C, S = self._trig_f32(self._phi_k, m, self._w_k)
            self._flat_cache = (jnp.asarray(C), jnp.asarray(S))
        return self._flat_cache[0]

    @property
    def _Esf(self):
        _ = self._Ecf
        return self._flat_cache[1]

    @property
    def coverage(self) -> float:
        """Fraction of sphere pixels inside the window."""
        return self.Rb * self.W / self.sht.npix

    def _ensure_lam(self):
        if self._lam_band is None:
            s = self.sht

            @jax.jit
            def build(band):
                # per-m-chunk Legendre blocks, band rows only (never
                # materialises the full [L+1, M+1, R] tensor).  `band` is
                # an ARGUMENT: device arrays captured in a jit closure are
                # baked into the HLO as literals.
                parts = []
                for m_vals in s._m_chunks():
                    blk = s._legendre_block(m_vals, jnp.float32)
                    parts.append(jnp.take(blk, band, axis=2))
                return jnp.concatenate(parts, axis=1)  # [L+1, M+1, Rb]

            self._lam_band = build(jnp.asarray(self.band))
        return self._lam_band

    def _ensure_lam_2f(self):
        """Two-float (hi f32, lo bf16) band Legendre tensors.

        Same layout as :meth:`_ensure_lam`; see
        :meth:`draco_tpu.ops.sht.SHT.precompute_legendre_split_2f` for
        the storage-error rationale (the band tensor's f32 quantization
        alone is a ~3e-6 end-to-end term).
        """
        if self._lam_band2 is None:
            s = self.sht

            @jax.jit
            def build(band):
                his, los = [], []
                with jax.enable_x64(True):
                    for m_vals in s._m_chunks():
                        blk = s._legendre_block(m_vals, jnp.float64)
                        blk = jnp.take(blk, band, axis=2)
                        hi = blk.astype(jnp.float32)
                        lo = (blk - hi.astype(jnp.float64)).astype(
                            jnp.bfloat16
                        )
                        his.append(hi)
                        los.append(lo)
                return jnp.concatenate(his, 1), jnp.concatenate(los, 1)

            self._lam_band2 = build(jnp.asarray(self.band))
        return self._lam_band2

    def gather(self, maps):
        """Window view [..., Rb, W] of full maps [..., npix]."""
        return jnp.asarray(maps)[..., self.window_index]

    def analysis(self, maps_win):
        """alm[..., L+1, M+1] of windowed maps [..., Rb, W].

        Real input gives the real-field alm (m >= 0); complex input the
        full transform of the complex map, like
        :meth:`SHT.analysis_complex`.
        """
        lam = self._ensure_lam()
        x = jnp.asarray(maps_win)
        if jnp.iscomplexobj(x):
            # analysis is linear: one stacked pass over [re, im] (twice
            # the GEMM batch width of two separate dispatches)
            ri = self._analysis_real(jnp.stack([x.real, x.imag]), lam)
            return ri[0] + 1j * ri[1]
        return self._analysis_real(x, lam)

    def analysis_pair(self, re_win, im_win):
        """(alm(B), alm(conj B)) for B = re + i im in one pass.

        Analysis of a complex map is linear: alm(B) = A(re) + i A(im),
        alm(conj B) = A(re) - i A(im) — the pair costs one windowed
        transform of a [2, ...] stack (the trick BeamTransfer.generate
        uses on the full-sphere path).
        """
        lam = self._ensure_lam()
        ri = self._analysis_real(
            jnp.stack([jnp.asarray(re_win), jnp.asarray(im_win)]), lam
        )
        return ri[0] + 1j * ri[1], ri[0] - 1j * ri[1]

    def _analysis_real(self, x, lam):
        # F- = sum_w x (cos - i sin);  alm = sum_r Lambda F-
        Fc = jnp.einsum("...rw,rwm->...rm", x, self._Ec, precision=_PREC_RING)
        Fs = jnp.einsum("...rw,rwm->...rm", x, self._Es, precision=_PREC_RING)
        return jax.lax.complex(
            jnp.einsum("lmr,...rm->...lm", lam, Fc, precision=_PREC_LEG),
            -jnp.einsum("lmr,...rm->...lm", lam, Fs, precision=_PREC_LEG),
        )
