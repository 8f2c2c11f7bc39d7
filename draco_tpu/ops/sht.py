"""Native spherical-harmonic transforms on HEALPix grids.

Replaces ``cora.util.hputil.sphtrans_sky`` / ``sphtrans_inv_sky`` (healpy
SHTs consumed at reference draco/synthesis/stream.py:85 and
draco/analysis/mapmaker.py:112) with a device-first design:

* per-ring Fourier analysis = batched FFTs over iso-latitude rings
  (grouped by ring length, with m-aliasing for the short polar-cap rings),
* the Legendre (theta) transform = an l-recurrence with libsharp-style
  dynamic power-of-two rescaling (stable in float32), producing
  chunked Legendre tensors that contract against the data as batched
  matmuls.

Conventions match healpy: fully-normalised spherical harmonics with the
Condon-Shortley phase; for real fields only m >= 0 coefficients are stored
(``alm[..., l, m]`` as a dense [lmax+1, mmax+1] array).  Analysis uses the
equal-area quadrature weight 4*pi/npix with optional Jacobi iterations to
sharpen the round trip.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from . import healpix

__all__ = ["SHT", "alm2map", "map2alm", "sphtrans_sky", "sphtrans_inv_sky"]

# Power-of-two block for the dynamic rescaling of the Legendre recurrence.
_SCALE_BITS = 60

# All SHT contractions run at HIGHEST matmul precision, which on an H100
# is true f32 (4e-7 of sum |a||b| per 4096-deep GEMM).  There HIGH is the
# same as DEFAULT: TF32 on the tensor cores, ~4x the rate at 4e-5 of
# sum |a||b| (3e-4 of max |C|) — far above the 1e-5 map accuracy target.
# DRACO_TPU_SHT_PRECISION=high selects it for workloads that tolerate it.
def _prec_env(var, fallback):
    name = os.environ.get(var, os.environ.get(fallback, "highest")).lower()
    table = {
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
    }
    try:
        return table[name]
    except KeyError:
        source = var if var in os.environ else fallback
        raise ValueError(
            f"{source}={name!r} is not a supported SHT precision; "
            f"accepted values: {sorted(table)}"
        ) from None


# Ring-DFT GEMMs (pixels <-> ring Fourier coefficients) and Legendre
# contractions (rings <-> l) can run at different precisions:
# DRACO_TPU_SHT_RING_PRECISION / DRACO_TPU_SHT_LEGENDRE_PRECISION override
# the common DRACO_TPU_SHT_PRECISION.
_PREC_RING = _prec_env("DRACO_TPU_SHT_RING_PRECISION", "DRACO_TPU_SHT_PRECISION")
_PREC_LEG = _prec_env(
    "DRACO_TPU_SHT_LEGENDRE_PRECISION", "DRACO_TPU_SHT_PRECISION"
)
_PREC = _PREC_LEG  # compat alias
_LN2 = float(np.log(2.0))


def _seed_log_coeff(mmax: int) -> np.ndarray:
    """ln of the m-dependent part of Lambda_mm (host, float64).

    Lambda_mm(theta) = (-1)^m * sqrt((2m+1)!!/(4 pi (2m)!!)) * sin^m(theta);
    this returns C_m = 0.5*ln((2m+1)!!/(4 pi (2m)!!)).
    """
    m = np.arange(1, mmax + 1)
    terms = np.log((2 * m + 1) / (2 * m))
    return 0.5 * (np.concatenate([[0.0], np.cumsum(terms)]) - np.log(4 * np.pi))


def _recurrence_tables(lmax: int, mmax: int):
    """Upward l-recurrence coefficients a[l,m], b[l,m] (host, float64).

    Lambda_{l,m} = a_{l,m} * cos(theta) * Lambda_{l-1,m} + b_{l,m} * Lambda_{l-2,m}
    valid for l > m (with Lambda_{m-1,m} := 0).
    """
    l = np.arange(lmax + 1)[:, None].astype(np.float64)
    m = np.arange(mmax + 1)[None, :].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.sqrt((4 * l**2 - 1) / (l**2 - m**2))
        b = -np.sqrt(
            ((2 * l + 1) * (l - 1 + m) * (l - 1 - m)) / ((2 * l - 3) * (l**2 - m**2))
        )
    bad = (l.astype(int) <= m.astype(int)) | ~np.isfinite(a)
    a = np.where(bad, 0.0, a)
    b = np.where(bad | ~np.isfinite(b), 0.0, b)
    return a, b


def _legendre_block_core(x, lnsin, cm_c, a_tab, b_tab, mv, two_float=False):
    """Lambda[l, c, r] recurrence with the tables as ARGUMENTS.

    Keeping the tables as runtime inputs (rather than closed-over
    constants) matters when this is the whole jitted program: a
    no-input jit makes XLA constant-fold the entire build at compile
    time — a long compile (and a multi-GB executable) for ~0 s of
    execution at nside=256 (see
    :meth:`SHT.precompute_legendre_split_2f_streamed`).

    Working dtype follows ``a_tab``; ``lnsin``/``cm_c`` may be higher
    precision for the seed exponentials.
    """
    dtype = a_tab.dtype
    lmax1 = a_tab.shape[0]
    # Seed: ln |Lambda_mm| = C_m + m ln sin(theta)
    ln_seed = (
        cm_c[:, None] + mv[:, None].astype(lnsin.dtype) * lnsin[None, :]
    )  # [C, R]
    sign = jnp.where(mv % 2 == 0, 1.0, -1.0).astype(dtype)[:, None]
    e0 = jnp.floor(ln_seed / (_SCALE_BITS * _LN2)).astype(jnp.int32)
    p_seed = (
        jnp.exp(ln_seed - e0.astype(ln_seed.dtype) * (_SCALE_BITS * _LN2))
    ).astype(dtype) * sign

    two_B = jnp.asarray(2.0 ** _SCALE_BITS, dtype=dtype)
    inv_two_B = jnp.asarray(2.0 ** -_SCALE_BITS, dtype=dtype)

    def step(carry, l):
        p_prev, p_curr, e = carry
        is_seed = (l == mv)[:, None]  # [C, 1]
        a_l = a_tab[l][:, None]
        b_l = b_tab[l][:, None]
        p_new = jnp.where(
            is_seed, p_seed, a_l * x[None, :] * p_curr + b_l * p_prev
        )
        e_new = jnp.where(is_seed, e0, e)
        p_base = jnp.where(is_seed, jnp.zeros_like(p_curr), p_curr)
        # Rescale when the mantissa grows past 2^B.
        big = jnp.abs(p_new) > two_B
        scale = jnp.where(big, inv_two_B, jnp.ones_like(p_new))
        p_new = p_new * scale
        p_base = p_base * scale
        e_new = e_new + big.astype(jnp.int32)
        # Emit the true value: mantissa * 2^(e*B).  exp2 underflows to
        # zero in the deep-polar regime where Lambda is genuinely below
        # the floating-point floor.
        lam = p_new * jnp.exp2(e_new.astype(dtype) * _SCALE_BITS)
        lam = jnp.where(l >= mv[:, None], lam, jnp.zeros_like(lam))
        if two_float:
            # emit (hi f32, lo bf16) directly so the f64 tensor is
            # never materialised (scan state stays [C, R])
            hi = lam.astype(jnp.float32)
            lo = (lam - hi.astype(lam.dtype)).astype(jnp.bfloat16)
            return (p_base, p_new, e_new), (hi, lo)
        return (p_base, p_new, e_new), lam

    zeros = jnp.zeros((mv.shape[0], x.shape[0]), dtype=dtype)
    (_, _, _), lam = jax.lax.scan(
        step,
        (zeros, zeros, jnp.zeros_like(zeros, dtype=jnp.int32)),
        jnp.arange(lmax1),
    )
    return lam  # [L+1, C, R] (or the (hi, lo) pair with two_float)


class SHT:
    """Spherical harmonic transform operator for one (nside, lmax) pair.

    Parameters
    ----------
    nside
        HEALPix resolution of the maps.
    lmax, mmax
        Band limits (default lmax = 3*nside - 1, mmax = lmax).
    chunk_m
        How many m values to process per Legendre block; larger blocks use
        more memory but bigger matmuls.
    """

    def __init__(
        self,
        nside: int,
        lmax: int | None = None,
        mmax: int | None = None,
        chunk_m: int = 64,
    ):
        self.nside = nside
        self.lmax = int(lmax) if lmax is not None else 3 * nside - 1
        self.mmax = int(mmax) if mmax is not None else self.lmax
        if self.mmax > self.lmax:
            raise ValueError("mmax cannot exceed lmax")
        # Synthesis at mmax >= 4*nside is exact point-sampling (a dense
        # DFT evaluates e^{i m phi} at the true angles, and FFT-bin
        # aliasing IS the correct sample value), so it is allowed —
        # healpy-style map degrading depends on it.  ANALYSIS is not:
        # the belt's 4*nside azimuthal samples cannot separate aliased
        # m, so the analysis entry points reject it (see
        # _require_analysis_band_limit).
        self._analysis_band_limited = self.mmax < 4 * nside
        self.chunk_m = int(min(chunk_m, self.mmax + 1))
        self.npix = healpix.npix_of(nside)
        self.info = healpix.ring_info(nside)

        info = self.info
        self._theta = info.theta
        self._x = np.cos(info.theta)
        self._lnsin = np.log(np.sin(info.theta))
        self._w = info.weight  # per-ring quadrature weight (4 pi / npix)
        self._cm = _seed_log_coeff(self.mmax)
        self._a_tab, self._b_tab = _recurrence_tables(self.lmax, self.mmax)

        # Ring groups: equal-nphi cap pairs + the equatorial belt.
        # Each entry: (nphi, [(ring_index, pixel_offset), ...]).
        self._groups = self._build_groups()

        self._m = np.arange(self.mmax + 1)

        self._analysis_j = jax.jit(self._analysis_impl)
        self._synthesis_j = jax.jit(self._synthesis_impl)

    # ------------------------------------------------------------------
    def _build_groups(self):
        """Precompute cap/belt decomposition.

        The pixel layout is [north cap | equatorial belt | south cap], each
        contiguous.  The belt's 2*nside+1 rings share nphi = 4*nside (and
        4*nside > mmax, so no aliasing): one batched FFT covers them.  The
        ragged cap rings are handled as m-chunked dense DFT matmuls
        rather than per-ring FFTs — a handful of einsums instead of
        hundreds of tiny FFT ops (compile time and runtime both win).
        """
        info = self.info
        nside = self.nside
        ncap = nside - 1  # rings per polar cap
        self._belt_rings = list(range(ncap, 3 * nside))
        self._belt_off = int(info.offset[ncap]) if ncap < info.nring else 0
        self._belt_nphi = 4 * nside
        self._belt_len = len(self._belt_rings) * self._belt_nphi

        # cap rings in ring order: north 0..ncap-1, south nring-ncap..nring-1
        self._cap_rings = list(range(ncap)) + list(
            range(info.nring - ncap, info.nring)
        )
        self._ncap = len(self._cap_rings)
        if self._ncap:
            width = int(max(info.nphi[r] for r in self._cap_rings))
            self._cap_width = width
            idx = np.zeros((self._ncap, width), dtype=np.int64)
            mask = np.zeros((self._ncap, width), dtype=np.float64)
            phi = np.zeros((self._ncap, width), dtype=np.float64)
            # integer phase tables: phi_rj = pi (2j + s) / n with
            # s in {0, 1} (HEALPix RING phi0 = s pi / n) — the exact
            # turn-fraction reduction in _cap_dft_matrix builds on these
            two_ps = np.zeros((self._ncap, width), dtype=np.int32)
            n_row = np.zeros(self._ncap, dtype=np.int32)
            for k, r in enumerate(self._cap_rings):
                n = int(info.nphi[r])
                idx[k, :n] = info.offset[r] + np.arange(n)
                mask[k, :n] = 1.0
                phi[k, :n] = info.phi0[r] + 2 * np.pi * np.arange(n) / n
                s = int(round(info.phi0[r] * n / np.pi))
                two_ps[k, :n] = 2 * np.arange(n) + s
                n_row[k] = n
            self._cap_idx = idx
            self._cap_mask = mask
            self._cap_phi = phi
            self._cap_2ps = two_ps
            self._cap_n = n_row
            # Width-split row groups: cap ring k has nphi = 4k, so ~half
            # of the padded [ncap, width] tensor is zeros.  Splitting
            # rows into width buckets removes the zero-padding GEMM and
            # gather work exactly (no approximation).
            nphi_rows = info.nphi[np.asarray(self._cap_rings)]
            # Bucket count (DRACO_TPU_CAP_WSPLIT).  At nside=256, 16
            # buckets cut the padded-pixel fraction from 16.5% to 2.0%;
            # 32 buckets remove <= 1% more padding at a much longer
            # compile.  The count is a tuning knob not yet re-swept on
            # the GPU.
            nsplit = int(os.environ.get("DRACO_TPU_CAP_WSPLIT", "16"))
            bounds = sorted({width * i // nsplit for i in range(1, nsplit + 1)} - {0})
            groups = []
            lo = 0
            for w in bounds:
                rows_arr = np.nonzero((nphi_rows > lo) & (nphi_rows <= w))[0]
                if len(rows_arr):
                    # mirror-paired order: [north rows k asc, matched south
                    # rows].  Row r (north) mirrors row ncap-1-r; consumers
                    # (P matrices, Legendre slices, padded layout, row_src)
                    # all derive from rows_arr so any order is consistent.
                    # Streaming bmap builders exploit theta -> pi - theta
                    # symmetry: south-half trig comes free from the north.
                    north = rows_arr[rows_arr < ncap]
                    rows_arr = np.concatenate(
                        [north, self._ncap - 1 - north]
                    )
                    groups.append((rows_arr, int(w)))
                lo = w
            self._cap_wgroups = groups
            # row r of the cap tensor sits at position worder[r] in the
            # concatenation of the group outputs
            src_rows = np.concatenate([g[0] for g in groups])
            self._cap_worder = np.argsort(src_rows)
        else:
            self._cap_width = 0
            self._cap_wgroups = []

    # All three DFT-factor builders reduce their phases EXACTLY before any
    # floating-point trig: every HEALPix azimuth is phi_rj = pi(2j+s)/n
    # (s in {0, 1} — verified for the RING scheme), so the phase in turns
    # is t = m(2j+s)/(2n) mod 1, computed with INTEGER arithmetic.  The
    # naive f32 arg = phi * m reaches ~5e3 rad at mmax ~ 768, where f32
    # rounding costs ~3e-4 rad — measured as the DOMINANT term of the round-trip error
    # (scripts/ablate_const_precision.py: promoting the ring plan to f64
    # moves the nside=64 end-to-end error 1.7e-5 -> 5.3e-6).  With the
    # exact reduction the residual is the bounded-arg trig error (~3e-7).
    @staticmethod
    def _int_phase_product(a, b, den):
        """Phase numerator ``a * b`` as a device int32 array, overflow-safe.

        The on-device product is formed in int32 (x64 is usually
        disabled under jit), which wraps SILENTLY once
        ``max|a*b| >= 2**31`` — for the belt that is nside >= ~16384
        (j reaches 4*nside-1, m reaches mmax), corrupting the DFT
        phases with no error.  In that regime reduce exactly on host in
        int64 and ship the already-small-valued table; below it, form
        the product on device so the HLO stays free of large host
        constants (which slow compiles down).
        """
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        if (
            a.size == 0
            or b.size == 0
            or np.abs(a).max() * np.abs(b).max() < 2**31
        ):
            return jnp.asarray(a, jnp.int32) * jnp.asarray(b, jnp.int32)
        return jnp.asarray((a * b) % np.asarray(den, np.int64), jnp.int32)

    def _phase_turns(self, num, den, dtype):
        """(cos, sin) of 2 pi (num / den) with num/den int32 arrays.

        ``num`` is reduced mod ``den`` exactly in integers before the
        float division, so the trig argument is a turn fraction in
        [0, 1) regardless of how large the unreduced phase was.
        """
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        t = (num % den).astype(rdt) / den.astype(rdt)
        if rdt == jnp.float64:
            ph = 2 * np.pi * t
            return jnp.cos(ph), jnp.sin(ph)
        from .tools import sincos_turns

        return sincos_turns(t)

    def _ring_phase(self, ring_sel, dtype, conj: bool = False) -> jnp.ndarray:
        """exp(-+i m phi0_r) for the selected rings, built on device."""
        info = self.info
        n = info.nphi[ring_sel].astype(np.int64)
        s = np.rint(info.phi0[ring_sel] * n / np.pi).astype(np.int64)
        num = self._int_phase_product(
            s[:, None], np.asarray(self._m)[None, :], (2 * n)[:, None]
        )
        den = jnp.asarray(2 * n, jnp.int32)[:, None]
        c, sn = self._phase_turns(num, den, dtype)
        sign = 1.0 if conj else -1.0
        return jax.lax.complex(c, sign * sn).astype(dtype)

    def _belt_dft_matrix(self, dtype, conj: bool = False) -> jnp.ndarray:
        """W[j, m] = exp(-+2 pi i j m / nphi) for the equal-nphi belt rings.

        A dense DFT matmul instead of an FFT, despite the ~60x FLOP
        overhead (whether cuFFT beats it is open).  Built on device
        (small: nphi x (mmax+1)).
        """
        num = self._int_phase_product(
            np.arange(self._belt_nphi)[:, None],
            np.asarray(self._m)[None, :],
            self._belt_nphi,
        )
        den = jnp.full((1, 1), self._belt_nphi, jnp.int32)
        c, sn = self._phase_turns(num, den, dtype)
        sign = 1.0 if conj else -1.0
        return jax.lax.complex(c, sign * sn).astype(dtype)

    def _cap_dft_matrix(self, m_vals: np.ndarray, dtype, group=None) -> jnp.ndarray:
        """P[r, j, m] = mask * exp(-i m phi_rj) for a chunk of m values.

        ``group``: optional (rows, width) pair restricting to a width-split
        row group (see _build_groups).  Built on device from the small
        integer index tables — a large host-side constant here would
        be serialised into the HLO and slow compiles down.
        """
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        if group is not None:
            rows_arr, w = group
            two_ps = self._cap_2ps[rows_arr][:, :w]
            n_rows = self._cap_n[rows_arr]
            mask = jnp.asarray(self._cap_mask[rows_arr][:, :w], dtype=rdt)
        else:
            two_ps = self._cap_2ps
            n_rows = self._cap_n
            mask = jnp.asarray(self._cap_mask, dtype=rdt)
        num = self._int_phase_product(
            np.asarray(two_ps)[:, :, None],
            np.asarray(m_vals)[None, None, :],
            (2 * np.asarray(n_rows))[:, None, None],
        )
        den = jnp.asarray(2 * n_rows, jnp.int32)[:, None, None]
        c, sn = self._phase_turns(num, den, dtype)
        return (jax.lax.complex(c, -sn) * mask[:, :, None]).astype(dtype)

    # ------------------------------------------------------------------
    # Ring Fourier steps
    # ------------------------------------------------------------------
    def _require_analysis_band_limit(self):
        """Analysis needs mmax < 4*nside (the belt sampling rate).

        Raised at trace time from every ring-analysis funnel: aliased m
        cannot be separated from 4*nside azimuthal samples, so analysis
        beyond the band limit would silently mix modes.  (Synthesis is
        exact point-sampling and has no such restriction.)
        """
        if not self._analysis_band_limited:
            raise ValueError(
                f"analysis requires mmax < 4*nside = {4 * self.nside} "
                f"(got mmax={self.mmax}): the grid cannot separate "
                f"aliased azimuthal modes. Synthesis-only use is fine."
            )

    def _ring_analysis(self, maps):
        """Per-ring Fourier coefficients F[..., nring, mmax+1].

        F_m(r) = sum_j map[r, j] * exp(-i m phi_rj).
        """
        self._require_analysis_band_limit()
        cdtype = jnp.result_type(maps.dtype, jnp.complex64)
        nring = self.info.nring
        ncap_n = self.nside - 1  # north cap ring count

        # Belt: one batched FFT (no aliasing as 4*nside > mmax)
        belt = jax.lax.dynamic_slice_in_dim(
            maps, self._belt_off, self._belt_len, axis=-1
        ).reshape(maps.shape[:-1] + (len(self._belt_rings), self._belt_nphi))
        is_real = not jnp.iscomplexobj(maps)
        if cdtype == jnp.complex64:
            # Dense DFT matmul (see _belt_dft_matrix).  Exact for any mmax: the direct sum is
            # the definition of F_m, no FFT-bin aliasing involved.
            W = self._belt_dft_matrix(cdtype)
            if is_real:
                # real x complex: two real GEMMs — half the FLOPs of
                # up-casting the input to complex first
                F_raw = jax.lax.complex(
                    jnp.matmul(belt, W.real, precision=_PREC_RING),
                    jnp.matmul(belt, W.imag, precision=_PREC_RING),
                )
            else:
                F_raw = jnp.matmul(belt, W, precision=_PREC_RING)
        else:
            F_raw = jnp.fft.fft(belt.astype(cdtype), axis=-1)[
                ..., : self.mmax + 1
            ]
        F_belt = F_raw * self._ring_phase(self._belt_rings, cdtype)

        if not self._ncap:
            return F_belt

        # Caps: m-chunked dense DFT matmuls over width-split row groups
        # (half-width rings avoid GEMM-ing their zero padding)
        group_F = []
        for grp in self._cap_wgroups:
            rows_arr, w = grp
            cap = maps[..., jnp.asarray(self._cap_idx[rows_arr][:, :w])]
            if not (is_real and cdtype == jnp.complex64):
                cap = cap.astype(cdtype)
            parts = []
            for m_vals in self._m_chunks():
                P = self._cap_dft_matrix(m_vals, cdtype, group=grp)
                if is_real and cdtype == jnp.complex64:
                    parts.append(
                        jax.lax.complex(
                            jnp.einsum(
                                "...rj,rjm->...rm", cap, P.real, precision=_PREC_RING
                            ),
                            jnp.einsum(
                                "...rj,rjm->...rm", cap, P.imag, precision=_PREC_RING
                            ),
                        )
                    )
                else:
                    parts.append(
                        jnp.einsum("...rj,rjm->...rm", cap, P, precision=_PREC_RING)
                    )
            group_F.append(jnp.concatenate(parts, axis=-1))
        F_cap = jnp.concatenate(group_F, axis=-2)[
            ..., jnp.asarray(self._cap_worder), :
        ]  # [..., ncap, M+1] in cap-row order

        return jnp.concatenate(
            [F_cap[..., :ncap_n, :], F_belt, F_cap[..., ncap_n:, :]], axis=-2
        )

    def _ring_synthesis(self, G):
        """Real maps from per-ring Fourier coefficients G[..., nring, m].

        f(r, j) = Re sum_{m=-mmax}^{mmax} G_m(r) e^{i m phi_rj} with
        G_{-m} = conj(G_m) (real field).
        """
        ncap_n = self.nside - 1
        nbelt = len(self._belt_rings)
        G_belt = G[..., ncap_n : ncap_n + nbelt, :]
        ring_sel = np.asarray(self._cap_rings)
        G_caps = [
            G[..., jnp.asarray(ring_sel[rows_arr]), :]
            for rows_arr, _ in self._cap_wgroups
        ]
        return self._ring_synthesis_parts(G_belt, G_caps)

    def _ring_synthesis_parts(self, G_belt, G_caps, plan=None):
        """Ring synthesis from per-section coefficients.

        ``G_belt`` [..., nbelt, M+1]; ``G_caps`` per width-split row group
        (layout of :meth:`precompute_legendre_split`).  ``plan``: reuse
        the (quadrature-weighted) analysis DFT factors; the weight is
        divided back out via the per-row coefficient.
        """
        cdtype = G_belt.dtype
        ncap_n = self.nside - 1

        # Belt: fill FFT bins and inverse transform
        g_belt = G_belt * self._ring_phase(
            self._belt_rings, cdtype, conj=True
        )
        nphi = self._belt_nphi
        if cdtype == jnp.complex64 or self.mmax >= nphi:
            # Dense inverse DFT as two real GEMMs.  f(j) = Re sum_m c_m G_m e^{+i m phi_j} with c_0 = 1,
            # c_{m>0} = 2 (real-field hermitian doubling); the direct sum
            # is exact for any mmax (no FFT-bin alias handling needed) —
            # which is why the f64 path also routes here when mmax
            # exceeds the belt's nphi (the iFFT bin-fill below cannot
            # express m >= nphi).
            rdt = np.float32 if cdtype == jnp.complex64 else np.float64
            cm = np.ones(self.mmax + 1, dtype=rdt)
            cm[1:] = 2.0
            gd = g_belt * jnp.asarray(cm, dtype=cdtype)
            Wc = self._belt_dft_matrix(cdtype, conj=True)  # [nphi, M+1]
            f_belt = jnp.matmul(gd.real, Wc.real.T, precision=_PREC_RING) - jnp.matmul(
                gd.imag, Wc.imag.T, precision=_PREC_RING
            )
        else:
            bins = jnp.zeros(g_belt.shape[:-1] + (nphi,), dtype=cdtype)
            # add (not set): at m = nphi/2 the +m and -m contributions
            # alias into the same bin and must sum (2 Re of the coeff)
            bins = bins.at[..., : self.mmax + 1].add(g_belt)
            neg = jnp.conj(g_belt[..., 1:])[..., ::-1]  # m = mmax .. 1
            bins = bins.at[..., nphi - self.mmax :].add(neg)
            f_belt = jnp.fft.ifft(bins, axis=-1).real * nphi
        f_belt = f_belt.reshape(f_belt.shape[:-2] + (self._belt_len,))

        if not self._ncap:
            return f_belt

        # Caps: dense inverse DFT with the m>0 doubling for a real field,
        # over the width-split row groups (no GEMM work on zero padding)
        cap_ring_sel = self._cap_rings
        cm = np.ones(self.mmax + 1)
        cm[1:] = 2.0
        ring_ids = np.asarray(self._cap_rings)
        f_groups = []
        row_src = {}
        for gi, grp in enumerate(self._cap_wgroups):
            rows_arr, w = grp
            for i, r in enumerate(rows_arr):
                row_src[int(r)] = (gi, i)
            g_cap = G_caps[gi]
            if plan is not None:
                # plan P carries the analysis quadrature weight; divide it
                # out through the per-row coefficient
                inv_w = 1.0 / self._w[ring_ids[rows_arr]]
                coeff = jnp.asarray(
                    cm[None, :] * inv_w[:, None], dtype=cdtype
                )  # [rows, M+1]
                f_groups.append(
                    jnp.einsum(
                        "...rm,rjm->...rj",
                        g_cap * coeff,
                        jnp.conj(plan["P"][gi]),
                        precision=_PREC_RING,
                    ).real
                )
                continue
            parts = []
            for m_vals in self._m_chunks():
                P = self._cap_dft_matrix(m_vals, cdtype, group=grp)
                coeff = jnp.asarray(cm[m_vals], dtype=cdtype)
                # Re(sum_m c_m G_m conj(P)) ; conj(P) = exp(+i m phi)
                parts.append(
                    jnp.einsum(
                        "...rm,rjm->...rj",
                        g_cap[..., m_vals] * coeff,
                        jnp.conj(P),
                        precision=_PREC_RING,
                    ).real
                )
            f_groups.append(sum(parts))  # [..., nrows_g, w_g]

        # Scatter cap rings back into the pixel vector
        def ring_pix(k, r):
            gi, i = row_src[k]
            return f_groups[gi][..., i, : int(self.info.nphi[r])]

        north = [ring_pix(k, r) for k, r in enumerate(cap_ring_sel[:ncap_n])]
        south = [
            ring_pix(k + ncap_n, r)
            for k, r in enumerate(cap_ring_sel[ncap_n:])
        ]
        return jnp.concatenate([*north, f_belt, *south], axis=-1)

    # ------------------------------------------------------------------
    # Legendre blocks
    # ------------------------------------------------------------------
    def _legendre_block(self, m_vals: np.ndarray, dtype):
        """Lambda[l, c, r] for the m values in this chunk.

        Stable in float32 via a shared power-of-two exponent carried through
        the upward l-recurrence (rescaled whenever the mantissa exceeds
        2**_SCALE_BITS, libsharp-style).
        """
        x = jnp.asarray(self._x, dtype=dtype)  # [R]
        lnsin = jnp.asarray(self._lnsin, dtype=jnp.float64 if dtype == jnp.float64 else jnp.float32)
        return _legendre_block_core(
            x,
            lnsin,
            jnp.asarray(self._cm[m_vals], dtype=lnsin.dtype),
            jnp.asarray(self._a_tab[:, m_vals], dtype=dtype),
            jnp.asarray(self._b_tab[:, m_vals], dtype=dtype),
            jnp.asarray(m_vals),
        )

    def _m_chunks(self):
        for m0 in range(0, self.mmax + 1, self.chunk_m):
            yield np.arange(m0, min(m0 + self.chunk_m, self.mmax + 1))

    def precompute_legendre(self, dtype=jnp.float32):
        """Materialise the full Legendre tensor Lambda[L+1, M+1, R].

        The l-recurrence is a sequential ``lax.scan``; streaming workloads
        that call the transform many times (e.g. on-the-fly beam-transfer
        generation) should run it ONCE and pass the result to
        ``_analysis_impl``/``_synthesis_impl`` via ``lam=`` — every
        transform then lowers to a single batched GEMM with no sequential
        dependency.  Size: (lmax+1)(mmax+1) R floats (~2.4 GB f32 at
        nside=256, lmax=767).
        """
        blocks = [
            self._legendre_block(m_vals, dtype) for m_vals in self._m_chunks()
        ]  # each [L+1, C, R]
        return jnp.concatenate(blocks, axis=1)  # [L+1, M+1, R]

    def _split_sections(self, lam):
        """Slice a full [L+1, M+1, R] tensor into the belt/caps dict."""
        belt = lam[:, :, self._belt_rings[0] : self._belt_rings[-1] + 1]
        ring_ids = np.asarray(self._cap_rings)
        caps = [
            lam[:, :, jnp.asarray(ring_ids[rows_arr])]
            for rows_arr, _ in self._cap_wgroups
        ]
        return {"belt": belt, "caps": caps}

    def precompute_legendre_split(self, dtype=jnp.float32):
        """Per-section Legendre tensors for the concat-free analysis path.

        Returns {"belt": [L+1, M+1, nbelt], "caps": [[L+1, M+1, n_g], ...]}
        with cap tensors ordered like the width-split row groups.  Passing
        this dict as ``lam=`` to :meth:`_analysis_impl` contracts each ring
        section as its own GEMM and SUMS the partial alm — no [.., R, M+1]
        concatenation, row reorder or separate quadrature-weight multiply
        (the weight is folded into the constant DFT matrices instead).
        """
        return self._split_sections(self.precompute_legendre(dtype))

    def precompute_legendre_split_2f(self):
        """Two-float (hi f32, lo bf16) split Legendre tensors.

        The f32 quantization of the stored Legendre tensor is one of the
        two dominant terms of the round-trip map error (the other was the
        ring-plan trig; scripts/ablate_const_precision.py).  The
        recurrence runs in f64 on device (one-time cost) and each value
        is stored as ``hi + lo`` with hi = f32(lam) and lo the bf16
        residual: hi*2^-24 scale means a bf16 lo retains the value to
        ~2^-32 relative — far below the 1e-5 budget — at half the memory
        of an f32 lo.  Consumers contract ``F @ hi`` at full precision
        plus ``F @ lo`` at DEFAULT (single-pass bf16: the lo term is
        ~6e-8 of the result, so 3e-3 relative error on it is 2e-10).

        Returns ``(hi_dict, lo_dict)`` in the
        :meth:`precompute_legendre_split` layout.
        """
        his, los = [], []
        with jax.enable_x64(True):
            for m_vals in self._m_chunks():
                blk = self._legendre_block(m_vals, jnp.float64)
                hi = blk.astype(jnp.float32)
                lo = (blk - hi.astype(jnp.float64)).astype(jnp.bfloat16)
                his.append(hi)
                los.append(lo)
        hi = jnp.concatenate(his, axis=1)
        lo = jnp.concatenate(los, axis=1)
        return self._split_sections(hi), self._split_sections(lo)

    def precompute_legendre_split_2f_streamed(self):
        """Two-float split Legendre via argument-streamed chunk programs.

        Numerically identical to :meth:`precompute_legendre_split_2f`,
        but the recurrence tables enter each chunk program as RUNTIME
        arguments instead of closed-over constants.  The one-jit
        variant has no inputs, so XLA constant-folds the whole build at
        COMPILE time: a long compile (and a multi-GB executable) for
        ~0 s of execution at nside=256 — paid again whenever the
        compile cache misses.  Here the per-chunk program
        is tiny (compiles in seconds) and the actual
        f64 recurrence work is what runs.
        """
        # ONE dispatch with ~5 MB of table arguments, and the scan emits
        # (hi, lo) directly so the f64 tensor is never materialised.
        @jax.jit
        def build(x, lnsin, cm, a_tab, b_tab, mv):
            hi, lo = _legendre_block_core(
                x, lnsin, cm, a_tab, b_tab, mv, two_float=True
            )
            return self._split_sections(hi), self._split_sections(lo)

        m_all = np.arange(self.mmax + 1)
        with jax.enable_x64(True):
            args = (
                jnp.asarray(self._x, jnp.float64),
                jnp.asarray(self._lnsin, jnp.float64),
                jnp.asarray(self._cm[m_all], jnp.float64),
                jnp.asarray(self._a_tab, jnp.float64),
                jnp.asarray(self._b_tab, jnp.float64),
                jnp.asarray(m_all),
            )
            return build(*args)

    def precompute_ring_plan_streamed(self, dtype=jnp.complex64):
        """Ring-DFT plan with the integer phase tables as runtime args.

        Same output as :meth:`precompute_ring_plan` (cap matrices carry
        the quadrature weight), built through small jitted chunk
        programs instead of one constant-folded giant — see
        :meth:`precompute_legendre_split_2f_streamed` for the compile
        economics.
        """
        ring_ids = np.asarray(self._cap_rings)
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64

        # The [r, j, C] integer phase-numerator tables are as large as
        # the plan itself (~1.2 GB int32 at nside=256) — forming them on
        # host would put them through a large host->device copy.  Ship only the SMALL factor tables and form the
        # products on device; pre-reduce per-factor mod den so the
        # int32 device product cannot wrap (a*b mod d == ((a mod d) *
        # (b mod d)) mod d, and _phase_turns reduces mod den again).
        @jax.jit
        def cap_chunk(two_ps, mv_row, den, mask, w_rows):
            # mv_row: [r, C] = m reduced mod each row's den, so the
            # per-row modular product identity applies
            num = two_ps[:, :, None] * mv_row[:, None, :]
            c, sn = self._phase_turns(num, den, dtype)
            P = (jax.lax.complex(c, -sn) * mask[:, :, None]).astype(dtype)
            return P * w_rows[:, None, None].astype(dtype)

        @jax.jit
        def cap_chunk_hostnum(num, den, mask, w_rows):
            # fallback: host-reduced full num table (large transfer —
            # only for nside large enough that the device product wraps)
            c, sn = self._phase_turns(num, den, dtype)
            P = (jax.lax.complex(c, -sn) * mask[:, :, None]).astype(dtype)
            return P * w_rows[:, None, None].astype(dtype)

        @jax.jit
        def belt_chunk(j_mod, mv, den):
            num = j_mod[:, None] * mv[None, :]
            c, sn = self._phase_turns(num, den, dtype)
            return jax.lax.complex(c, -sn).astype(dtype)

        P_groups = []
        for grp in self._cap_wgroups:
            rows_arr, w = grp
            two_ps = np.asarray(self._cap_2ps[rows_arr][:, :w], np.int64)
            n_rows = np.asarray(self._cap_n[rows_arr], np.int64)
            den_h = (2 * n_rows)[:, None, None]
            two_ps_m = two_ps % den_h[:, :, 0]  # [r, w], < 2*nphi_r
            mask_h = np.asarray(self._cap_mask[rows_arr][:, :w], dtype=rdt)
            w_rows_h = np.asarray(self._w[ring_ids[rows_arr]], dtype=rdt)
            den_d = jnp.asarray(den_h, jnp.int32)
            mask_d = jnp.asarray(mask_h)
            w_rows_d = jnp.asarray(w_rows_h)
            # device int32 product is safe iff max (2ps mod d)(m mod d)
            # < 2^31; dens differ per row inside a width group, so m is
            # reduced per ROW ([r, M+1] — still a tiny transfer).  One
            # call per group covers ALL m.
            max_prod = int(two_ps_m.max(initial=0)) * int(
                (den_h.max() - 1) if den_h.size else 0
            )
            mv_row = np.asarray(self._m, np.int64)[None, :] % den_h[:, 0, :]
            if max_prod < 2**31:
                P_groups.append(
                    cap_chunk(
                        jnp.asarray(two_ps_m, jnp.int32),
                        jnp.asarray(mv_row, jnp.int32),
                        den_d,
                        mask_d,
                        w_rows_d,
                    )
                )
            else:
                num_h = (two_ps_m[:, :, None] * mv_row[:, None, :]) % den_h
                P_groups.append(
                    cap_chunk_hostnum(
                        jnp.asarray(num_h, jnp.int32), den_d, mask_d, w_rows_d
                    )
                )

        den_b = int(self._belt_nphi)
        j_mod = np.arange(self._belt_nphi, dtype=np.int64) % den_b
        mv_red = np.asarray(self._m, np.int64) % den_b
        den_d = jnp.full((1, 1), den_b, jnp.int32)
        if int(j_mod.max(initial=0)) * int(mv_red.max(initial=0)) < 2**31:
            W = belt_chunk(
                jnp.asarray(j_mod, jnp.int32),
                jnp.asarray(mv_red, jnp.int32),
                den_d,
            )
        else:  # huge-nside fallback: ship the host-reduced num table
            num_h = (j_mod[:, None] * mv_red[None, :]) % den_b

            @jax.jit
            def belt_hostnum(num, den):
                c, sn = self._phase_turns(num, den, dtype)
                return jax.lax.complex(c, -sn).astype(dtype)

            W = belt_hostnum(jnp.asarray(num_h, jnp.int32), den_d)
        return {"W": W, "P": P_groups}

    def padded_layout(self) -> np.ndarray:
        """HEALPix pixel index for each slot of the GEMM-ready padded
        layout ``[belt | cap group 0 | cap group 1 | ...]`` (-1 = padding).

        Generating simulated maps (e.g. fringe x beam) directly in this
        layout lets :meth:`analysis_padded` skip the ragged cap gather —
        the single biggest data-movement cost of the transform.
        """
        idxs = [np.arange(self._belt_off, self._belt_off + self._belt_len)]
        for rows_arr, w in self._cap_wgroups:
            idx = self._cap_idx[rows_arr][:, :w].copy()
            idx[self._cap_mask[rows_arr][:, :w] <= 0] = -1
            idxs.append(idx.ravel())
        return np.concatenate(idxs).astype(np.int64)

    def analysis_padded(self, maps_pad, lam, plan=None):
        """alm of maps given in the :meth:`padded_layout` pixel order.

        ``lam`` must be the dict from :meth:`precompute_legendre_split`.
        Padding slots may hold any value as long as the corresponding map
        value is zero (the DFT mask also zeroes them).
        """
        F_belt, group_F = self._ring_analysis_parts_padded(maps_pad, plan=plan)
        return self._contract_alm(F_belt, group_F, lam)

    def _ring_analysis_parts_padded(
        self, maps_pad, raw_belt=False, plan=None, mcut=None
    ):
        """Per-section ring coefficients from :meth:`padded_layout` maps.

        ``mcut``: static m-column truncation — coefficients are produced
        only for m < mcut (the caller guarantees its data carries no
        higher azimuthal content; see the fused full-sphere round
        trip's m-support chunk groups).  Requires ``plan``.
        """
        cdtype = jnp.result_type(maps_pad.dtype, jnp.complex64)
        is_real = not jnp.iscomplexobj(maps_pad)
        lead = maps_pad.shape[:-1]
        belt = maps_pad[..., : self._belt_len].reshape(
            lead + (len(self._belt_rings), self._belt_nphi)
        )
        caps = []
        off = self._belt_len
        for rows_arr, w in self._cap_wgroups:
            size = len(rows_arr) * w
            caps.append(
                maps_pad[..., off : off + size].reshape(
                    lead + (len(rows_arr), w)
                )
            )
            off += size
        return self._analysis_sections(
            belt, caps, is_real, cdtype, raw_belt=raw_belt, plan=plan,
            mcut=mcut,
        )

    def precompute_ring_plan(self, dtype=jnp.complex64):
        """Constant ring-DFT factors as device arrays.

        XLA does not hoist the loop-invariant trig that builds the cap DFT
        matrices out of ``fori_loop`` bodies, so in-graph construction
        repeats it every iteration.  Streaming loops should
        build this plan once and pass it via ``plan=`` to the parts-level
        analysis entry points.  Cap matrices carry the quadrature weight
        (matching :meth:`_analysis_sections`); ~2.4 GB c64 at nside=256.
        """
        ring_ids = np.asarray(self._cap_rings)
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        P_groups = []
        for grp in self._cap_wgroups:
            rows_arr, w = grp
            w_rows = jnp.asarray(self._w[ring_ids[rows_arr]], dtype=rdt)
            parts = [
                self._cap_dft_matrix(mv, dtype, group=grp)
                * w_rows[:, None, None].astype(dtype)
                for mv in self._m_chunks()
            ]
            P_groups.append(jnp.concatenate(parts, axis=-1))
        return {"W": self._belt_dft_matrix(dtype), "P": P_groups}

    def _ring_analysis_parts(self, maps, raw_belt=False, plan=None):
        """Quadrature-weighted per-section ring coefficients (f32 path).

        Returns (F_belt, [F_group, ...]) matching the layout of
        :meth:`precompute_legendre_split`, with the 4pi/npix ring weight
        and the phi0 phase folded into the constant DFT factors.
        """
        cdtype = jnp.result_type(maps.dtype, jnp.complex64)
        is_real = not jnp.iscomplexobj(maps)

        belt = jax.lax.dynamic_slice_in_dim(
            maps, self._belt_off, self._belt_len, axis=-1
        ).reshape(maps.shape[:-1] + (len(self._belt_rings), self._belt_nphi))
        caps = [
            maps[..., jnp.asarray(self._cap_idx[rows_arr][:, :w])]
            for rows_arr, w in self._cap_wgroups
        ]
        return self._analysis_sections(
            belt, caps, is_real, cdtype, raw_belt=raw_belt, plan=plan
        )

    def belt_phase_weight(self, dtype=jnp.complex64) -> jnp.ndarray:
        """exp(-i m phi0_r) * w_r for the belt rings: [nbelt, M+1].

        With ``raw_belt=True`` the analysis skips this elementwise factor;
        streaming consumers fold conj(pw) into their sky contraction and
        pw into adjoint accumulators instead (once, outside hot loops).
        """
        rdt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        w_belt = jnp.asarray(self._w[self._belt_rings], dtype=rdt)
        return self._ring_phase(self._belt_rings, dtype) * w_belt[:, None]

    def _analysis_sections(
        self, belt, caps, is_real, cdtype, raw_belt=False, plan=None,
        mcut=None,
    ):
        """Shared per-section DFT math for the gathered/padded layouts.

        ``raw_belt``: skip the belt phase-weight multiply (see
        :meth:`belt_phase_weight`).  ``plan``: precomputed DFT factors
        from :meth:`precompute_ring_plan` (constants as arguments, not
        rebuilt per loop iteration).
        """
        self._require_analysis_band_limit()
        if mcut is not None and plan is None:
            raise ValueError("mcut requires a precomputed ring plan")
        rdt = jnp.float32 if cdtype == jnp.complex64 else jnp.float64
        W = plan["W"] if plan is not None else self._belt_dft_matrix(cdtype)
        if mcut is not None:
            W = W[:, :mcut]
        if is_real and cdtype == jnp.complex64:
            F_raw = jax.lax.complex(
                jnp.matmul(belt, W.real, precision=_PREC_RING),
                jnp.matmul(belt, W.imag, precision=_PREC_RING),
            )
        else:
            F_raw = jnp.matmul(belt.astype(cdtype), W, precision=_PREC_RING)
        if raw_belt:
            F_belt = F_raw
        else:
            F_belt = F_raw * self.belt_phase_weight(cdtype)

        ring_ids = np.asarray(self._cap_rings)
        group_F = []
        for gi, grp in enumerate(self._cap_wgroups):
            rows_arr, w = grp
            cap = caps[gi]
            if not (is_real and cdtype == jnp.complex64):
                cap = cap.astype(cdtype)
            if plan is not None:
                P_full = plan["P"][gi]  # [rows, w, M+1], weight folded
                if mcut is not None:
                    P_full = P_full[..., :mcut]
                if is_real and cdtype == jnp.complex64:
                    group_F.append(
                        jax.lax.complex(
                            jnp.einsum(
                                "...rj,rjm->...rm",
                                cap,
                                P_full.real,
                                precision=_PREC_RING,
                            ),
                            jnp.einsum(
                                "...rj,rjm->...rm",
                                cap,
                                P_full.imag,
                                precision=_PREC_RING,
                            ),
                        )
                    )
                else:
                    group_F.append(
                        jnp.einsum(
                            "...rj,rjm->...rm", cap, P_full, precision=_PREC_RING
                        )
                    )
                continue
            w_rows = jnp.asarray(self._w[ring_ids[rows_arr]], dtype=rdt)
            parts = []
            for m_vals in self._m_chunks():
                P = self._cap_dft_matrix(m_vals, cdtype, group=grp)
                P = P * w_rows[:, None, None].astype(P.dtype)
                if is_real and cdtype == jnp.complex64:
                    parts.append(
                        jax.lax.complex(
                            jnp.einsum(
                                "...rj,rjm->...rm", cap, P.real, precision=_PREC_RING
                            ),
                            jnp.einsum(
                                "...rj,rjm->...rm", cap, P.imag, precision=_PREC_RING
                            ),
                        )
                    )
                else:
                    parts.append(
                        jnp.einsum("...rj,rjm->...rm", cap, P, precision=_PREC_RING)
                    )
            group_F.append(jnp.concatenate(parts, axis=-1))
        return F_belt, group_F

    def _contract_alm(self, F_belt, group_F, lam, lam_lo=None):
        """Sum of per-section Legendre contractions (lam = split dict).

        ``lam_lo``: optional low parts from
        :meth:`precompute_legendre_split_2f`; contracted at DEFAULT
        precision (their contribution is ~eps of the total, so a cheap
        single-pass GEMM holds the error far below budget).
        """
        rdtype = F_belt.real.dtype

        def contract(F, lam_s, prec):
            lam_r = lam_s.astype(rdtype)
            if jnp.iscomplexobj(F):
                return jax.lax.complex(
                    jnp.einsum(
                        "...rm,lmr->...lm", F.real, lam_r, precision=prec
                    ),
                    jnp.einsum(
                        "...rm,lmr->...lm", F.imag, lam_r, precision=prec
                    ),
                )
            return jnp.einsum("...rm,lmr->...lm", F, lam_r, precision=prec)

        alm = contract(F_belt, lam["belt"], _PREC_LEG)
        for F_g, lam_g in zip(group_F, lam["caps"]):
            alm = alm + contract(F_g, lam_g, _PREC_LEG)
        if lam_lo is not None:
            alm = alm + contract(
                F_belt, lam_lo["belt"], jax.lax.Precision.DEFAULT
            )
            for F_g, lam_g in zip(group_F, lam_lo["caps"]):
                alm = alm + contract(F_g, lam_g, jax.lax.Precision.DEFAULT)
        return alm

    # ------------------------------------------------------------------
    # Public transforms
    # ------------------------------------------------------------------
    def _analysis_impl(self, maps, lam=None, plan=None, lam_lo=None):
        """alm[..., lmax+1, mmax+1] of (real or complex) maps [..., npix].

        ``lam``: optional precomputed Legendre tensor [L+1, M+1, R] from
        :meth:`precompute_legendre`; the transform becomes one batched
        (over m) ring-contraction GEMM.  ``lam_lo``: optional two-float
        low parts (split-dict form only).
        """
        if isinstance(lam, dict):
            # concat-free split path: contract each ring section against
            # its own Legendre slice and sum the partial alm
            F_belt, group_F = self._ring_analysis_parts(maps, plan=plan)
            return self._contract_alm(F_belt, group_F, lam, lam_lo=lam_lo)

        F = self._ring_analysis(maps)  # [..., R, M+1]
        rdtype = F.real.dtype
        w = jnp.asarray(self._w, dtype=rdtype)
        Fw = F * w[:, None]
        if lam is not None:
            # batch over m, contract rings: one batched GEMM.
            # lam is real — contract the real and imaginary parts as two
            # REAL GEMMs (half the FLOPs of a complex x complex contraction)
            lam_r = lam.astype(rdtype)
            if jnp.iscomplexobj(Fw):
                ar = jnp.einsum("...rm,lmr->...lm", Fw.real, lam_r, precision=_PREC_LEG)
                ai = jnp.einsum("...rm,lmr->...lm", Fw.imag, lam_r, precision=_PREC_LEG)
                return jax.lax.complex(ar, ai)
            return jnp.einsum("...rm,lmr->...lm", Fw, lam_r, precision=_PREC_LEG)
        out = []
        for m_vals in self._m_chunks():
            lam_c = self._legendre_block(m_vals, rdtype)  # [L+1, C, R]
            lam_t = jnp.transpose(lam_c, (1, 2, 0))  # [C, R, L+1]
            Fc = jnp.moveaxis(Fw[..., m_vals], -1, -2)  # [..., C, R]
            # alm_c[..., C, L+1]: batched over C, contraction over rings
            alm_c = jnp.einsum(
                "...cr,crl->...cl", Fc, lam_t.astype(Fc.dtype), precision=_PREC_LEG
            )
            out.append(jnp.moveaxis(alm_c, -2, -1))  # [..., L+1, C]
        return jnp.concatenate(out, axis=-1)  # [..., L+1, M+1]

    def _synthesis_impl(self, alm, lam=None, plan=None, lam_lo=None):
        """Real maps [..., npix] from alm[..., lmax+1, mmax+1].

        ``lam``: optional precomputed Legendre tensor (see
        :meth:`precompute_legendre`).  ``lam_lo``: optional two-float
        low parts (split-dict form only).
        """
        rdtype = alm.real.dtype
        if isinstance(lam, dict):

            def contract(lam_s, prec=_PREC_LEG):
                lam_r = lam_s.astype(rdtype)
                if jnp.iscomplexobj(alm):
                    return jax.lax.complex(
                        jnp.einsum(
                            "...lm,lmr->...rm", alm.real, lam_r, precision=prec
                        ),
                        jnp.einsum(
                            "...lm,lmr->...rm", alm.imag, lam_r, precision=prec
                        ),
                    )
                g = jnp.einsum("...lm,lmr->...rm", alm, lam_r, precision=prec)
                return jax.lax.complex(g, jnp.zeros_like(g))

            G_belt = contract(lam["belt"])
            G_caps = [contract(c) for c in lam["caps"]]
            if lam_lo is not None:
                DEF = jax.lax.Precision.DEFAULT
                G_belt = G_belt + contract(lam_lo["belt"], DEF)
                G_caps = [
                    g + contract(c, DEF)
                    for g, c in zip(G_caps, lam_lo["caps"])
                ]
            return self._ring_synthesis_parts(G_belt, G_caps, plan=plan)
        if lam is not None:
            lam_r = lam.astype(rdtype)
            if jnp.iscomplexobj(alm):
                gr = jnp.einsum("...lm,lmr->...rm", alm.real, lam_r, precision=_PREC_LEG)
                gi = jnp.einsum("...lm,lmr->...rm", alm.imag, lam_r, precision=_PREC_LEG)
                G = jax.lax.complex(gr, gi)
            else:
                G = jnp.einsum(
                    "...lm,lmr->...rm", alm, lam_r, precision=_PREC_LEG
                ).astype(
                    jnp.complex64 if rdtype == jnp.float32 else jnp.complex128
                )
            return self._ring_synthesis(G)
        Gs = []
        for m_vals in self._m_chunks():
            lam_c = self._legendre_block(m_vals, rdtype)  # [L+1, C, R]
            lam_t = jnp.transpose(lam_c, (1, 0, 2))  # [C, L+1, R]
            alm_c = jnp.moveaxis(alm[..., m_vals], -1, -2)  # [..., C, L+1]
            G_c = jnp.einsum(
                "...cl,clr->...cr", alm_c, lam_t.astype(alm.dtype), precision=_PREC_LEG
            )
            Gs.append(jnp.moveaxis(G_c, -2, -1))  # [..., R, C]
        G = jnp.concatenate(Gs, axis=-1)  # [..., R, M+1]
        # _ring_synthesis folds in the exp(+i m phi0) pixel phase itself.
        return self._ring_synthesis(G)

    def analysis(self, maps, iter: int = 0):
        """map2alm with optional Jacobi iterations (healpy-style).

        Complex maps iterate on their real and imaginary parts by
        linearity (the real-field synthesis used for the Jacobi residual
        assumes a hermitian spectrum, so iterating a complex map
        directly would add garbage instead of converging) — STACKED into
        one batched transform, not two serial ones: same math, half the
        dispatches and twice the GEMM batch.
        """
        maps = jnp.asarray(maps)
        if iter > 0 and jnp.iscomplexobj(maps):
            ri = self.analysis(jnp.stack([maps.real, maps.imag]), iter=iter)
            return ri[0] + 1j * ri[1]
        alm = self._analysis_j(maps)
        for _ in range(iter):
            resid = maps - self._synthesis_j(alm)
            alm = alm + self._analysis_j(resid)
        return alm

    def synthesis(self, alm):
        """alm2map for a real field (m >= 0 coefficients)."""
        return self._synthesis_j(jnp.asarray(alm))

    def analysis_complex(self, maps):
        """Full SHT of complex maps: (alm_pos, alm_neg).

        alm_pos[..., l, m] = f_{l m} for m >= 0 and
        alm_neg[..., l, m] = f_{l, -m}, computed via
        f_{l,-m} = (-1)^m conj((f*)_{l m}).

        Analysis is linear, so both transforms derive from ONE stacked
        real transform of [Re, Im]: alm(f) = A(re) + i A(im) and
        alm(conj f) = A(re) - i A(im) — half the ring/Legendre GEMM work
        of transforming f and conj(f) separately (the same trick the
        beam-transfer generator and WindowedSHT.analysis_pair use).
        """
        maps = jnp.asarray(maps)
        if jnp.iscomplexobj(maps):
            ri = self._analysis_j(jnp.stack([maps.real, maps.imag]))
            a_re, a_im = ri[0], ri[1]
        else:
            a_re = self._analysis_j(maps)
            a_im = jnp.zeros_like(a_re)
        alm_pos = a_re + 1j * a_im
        alm_conj = a_re - 1j * a_im
        msign = jnp.asarray((-1.0) ** self._m, dtype=alm_pos.real.dtype)
        alm_neg = msign * jnp.conj(alm_conj)
        return alm_pos, alm_neg


_sht_cache: dict = {}


def get_sht(nside: int, lmax: int | None = None, mmax: int | None = None) -> SHT:
    # normalise the defaults into the key so get_sht(256) and the
    # equivalent get_sht(256, 767, 767) share one instance (each SHT
    # holds multi-hundred-MB precomputes at large nside)
    if lmax is None:
        lmax = 3 * nside - 1
    if mmax is None:
        mmax = lmax
    key = (nside, lmax, mmax)
    if key not in _sht_cache:
        _sht_cache[key] = SHT(nside, lmax, mmax)
    return _sht_cache[key]


def map2alm(maps, lmax: int | None = None, iter: int = 3):
    """healpy-compatible scalar map2alm (dense [l, m] output)."""
    maps = jnp.asarray(maps)
    nside = healpix.nside_of(maps.shape[-1])
    sht = get_sht(nside, lmax)
    return sht.analysis(maps, iter=iter)


def alm2map(alm, nside: int):
    """healpy-compatible scalar alm2map from dense [l, m] coefficients."""
    from .tools import as_device

    alm = as_device(np.asarray(alm)) if not isinstance(alm, jnp.ndarray) \
        else alm
    sht = get_sht(nside, alm.shape[-2] - 1, alm.shape[-1] - 1)
    return sht.synthesis(alm)


def sphtrans_sky(sky_map, lmax: int | None = None):
    """SHT every (freq, pol) map: [freq, pol, npix] -> [freq, pol, l, m].

    Equivalent of ``cora.util.hputil.sphtrans_sky`` (reference
    draco/synthesis/stream.py:85): scalar transforms per Stokes component.
    """
    sky_map = jnp.asarray(sky_map)
    nside = healpix.nside_of(sky_map.shape[-1])
    if lmax is None:
        lmax = 3 * nside - 1
    sht = get_sht(nside, lmax)
    return sht.analysis(sky_map, iter=0)


def sphtrans_inv_sky(alm, nside: int):
    """Inverse of :func:`sphtrans_sky`: [freq, pol, l, m] -> [freq, pol, npix].

    Equivalent of ``cora.util.hputil.sphtrans_inv_sky`` (reference
    draco/analysis/mapmaker.py:112).
    """
    return alm2map(jnp.asarray(alm), nside)
