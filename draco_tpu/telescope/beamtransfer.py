"""Beam transfer matrices: the m-mode measurement operator.

Native replacement for ``drift.core.beamtransfer.BeamTransfer`` (API usage
catalogued in SURVEY.md section 1 L0).  The m-mode formalism (Shaw et al.,
arXiv:1302.0327): for each unique baseline the beam-fringe pattern

    B_ij(n) = beamprod_ij(n) * exp(2 pi i b_ij . n / lambda)

maps the sky to visibilities; in harmonic space the m-th sidereal harmonic
of the visibility is

    V_m     = sum_l Bp[l, m] a_lm,      Bp = conj(SHT(conj(B)))
    V*_{-m} = sum_l Bm[l, m] a_lm,      Bm = conj(SHT(B))

(for a real sky, a_{l,-m} folded via reality).  The packed telescope vector
for each m >= 0 is [V_m (all baselines); V*_{-m} (all baselines)], i.e.
``ntel = 2 * npairs`` — matching the reference's MModes ``msign`` layout
(reference draco/analysis/transform.py:701-703, mapmaker.py:156-168).

Device-first: B is generated on device with the native SHT and held as dense
[l, m] tensors; sky->telescope projection over all m is one batched einsum,
not a per-m Python loop.  Per-m SVD products are computed with a
single batched ``jnp.linalg.svd``.
"""

from __future__ import annotations

import os
from functools import partial

import jax
from ..ops.sht import _PREC
import jax.numpy as jnp
import numpy as np

from ..ops import healpix, sht, tools
from .core import TransitTelescope


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _split3(a64):
    """Device three-part split (:func:`tools.threefloat_split`) of ``a64``."""
    return tuple(jnp.asarray(p) for p in tools.threefloat_split(a64))


class BeamTransfer:
    """Generate, store and apply beam transfer matrices.

    Parameters
    ----------
    directory
        Product directory to load from / save to (optional).
    telescope
        The telescope model (required when generating).
    nside
        HEALPix resolution for beam evaluation (default: smallest power of
        two with 2*nside >= lmax+1).
    svcut
        Relative singular-value cut for the per-m SVD basis.
    """

    def __init__(
        self,
        directory: str | None = None,
        telescope: TransitTelescope | None = None,
        nside: int | None = None,
        svcut: float = 1e-6,
    ):
        self.directory = directory
        self._telescope = telescope
        self.svcut = svcut
        self._nside = nside
        self._bp = None  # [nfreq, nbase, npol, L+1, M+1]
        self._bm = None
        self._svd = None
        if directory is not None and telescope is None:
            self.load(directory)

    # -- basic properties ----------------------------------------------------
    @property
    def telescope(self) -> TransitTelescope:
        return self._telescope

    @property
    def nfreq(self) -> int:
        return self.telescope.nfreq

    @property
    def ntel(self) -> int:
        return 2 * self.telescope.npairs

    @property
    def nsky(self) -> int:
        return self.telescope.num_pol_sky * (self.telescope.lmax + 1)

    @property
    def ndofmax(self) -> int:
        self._ensure_svd()
        return int(np.max(np.asarray(self._svd["nmode"])))

    @property
    def beam_nside(self) -> int:
        if self._nside is not None:
            return self._nside
        return max(4, _next_pow2(int(np.ceil((self.telescope.lmax + 1) / 2))))

    # -- generation ------------------------------------------------------------
    def _beam_fringe_maps(self, fi: int, pair_sel=None) -> jnp.ndarray:
        """Beam-fringe maps per unique pair: [nbase, npol_sky, npix].

        ``pair_sel``: optional slice over the unique-pair axis (streaming
        chunks regenerate only their window).
        """
        tel = self.telescope
        nside = self.beam_nside
        lam = tel.wavelengths[fi]
        vec = healpix.pix2vec(nside)  # [npix, 3]
        bl3 = tel.baseline_vectors_3d()  # [nbase, 3]
        if pair_sel is None:
            pair_sel = slice(None)
        bl3 = bl3[pair_sel]
        fringe = np.exp(2j * np.pi * (bl3 @ vec.T) / lam)  # [nbase, npix]

        pairs = tel.uniquepairs[pair_sel]
        # Evaluate each distinct beamclass once.
        bc = tel.beamclass
        class_feeds = {int(c): int(np.where(bc == c)[0][0]) for c in np.unique(bc)}
        beams = {c: np.asarray(tel.beam(f, fi, nside)) for c, f in class_feeds.items()}

        npol = tel.num_pol_sky
        first = next(iter(beams.values()))
        if first.ndim == 1:  # unpolarised amplitude beams
            A_i = np.stack([beams[int(bc[i])] for i, _ in pairs])
            A_j = np.stack([beams[int(bc[j])] for _, j in pairs])
            bprod = (A_i * np.conj(A_j))[:, None, :]  # [nbase, 1, npix]
            if npol == 4:
                z = np.zeros_like(bprod)
                bprod = np.concatenate([bprod, z, z, z], axis=1)
        else:  # dual-pol (Et, Ep) beams
            Et_i = np.stack([beams[int(bc[i])][:, 0] for i, _ in pairs])
            Ep_i = np.stack([beams[int(bc[i])][:, 1] for i, _ in pairs])
            Et_j = np.stack([beams[int(bc[j])][:, 0] for _, j in pairs])
            Ep_j = np.stack([beams[int(bc[j])][:, 1] for _, j in pairs])
            tt = Et_i * np.conj(Et_j)
            pp = Ep_i * np.conj(Ep_j)
            tp = Et_i * np.conj(Ep_j)
            pt = Ep_i * np.conj(Et_j)
            B_T = 0.5 * (tt + pp)
            B_Q = 0.5 * (tt - pp)
            B_U = 0.5 * (tp + pt)
            B_V = 0.5j * (tp - pt)
            if npol == 1:
                bprod = B_T[:, None, :]
            else:
                bprod = np.stack([B_T, B_Q, B_U, B_V], axis=1)

        # normalise by pixel solid angle so V = sum_lm B_lm a_lm is the
        # quadrature of the continuous integral.
        omega_pix = 4 * np.pi / healpix.npix_of(nside)
        return tools.as_device(
            (bprod * fringe[:, None, :] * omega_pix).astype(np.complex64)
        )

    # Per-frequency beam products are reused within a build (support
    # mask, window, streaming setup), but one entry is [nuniq, npol,
    # npix] complex128 — tens of MB at beam_nside 256 — so an unbounded
    # cache would pin O(nfreq) of host RAM on production managers with
    # hundreds of frequencies.  Every in-repo consumer scans fi
    # sequentially, so a deep LRU gets no hits anyway; two entries cover
    # the same-fi adjacency between build phases (support mask ->
    # m-support sampling) at minimal pinned RAM.
    _BEAM_PRODUCTS_LRU = 2

    def _beam_products(self, fi: int):
        from collections import OrderedDict

        cache = self.__dict__.setdefault(
            "_beam_products_cache", OrderedDict()
        )
        if fi in cache:
            cache.move_to_end(fi)
        else:
            cache[fi] = self._beam_products_impl(fi)
            while len(cache) > self._BEAM_PRODUCTS_LRU:
                cache.popitem(last=False)
        return cache[fi]

    def _beam_products_impl(self, fi: int):
        """Deduped beam-product maps per beamclass pair (host arrays).

        Returns ``(u_idx, bprod)``: ``bprod[u]`` is the [npol, npix]
        complex beam product (pixel solid angle folded in) for unique
        beamclass pair ``u``, and ``u_idx[b]`` maps each baseline to its
        product.  Streaming transfers only the deduped products to the
        device and builds the fringe there.
        """
        tel = self.telescope
        nside = self.beam_nside
        pairs = tel.uniquepairs
        bc = tel.beamclass
        keys = [(int(bc[i]), int(bc[j])) for i, j in pairs]
        uniq = sorted(set(keys))
        kmap = {k: u for u, k in enumerate(uniq)}
        u_idx = np.array([kmap[k] for k in keys], dtype=np.int32)

        class_feeds = {
            int(c): int(np.where(bc == c)[0][0]) for c in np.unique(bc)
        }
        beams = {
            c: np.asarray(tel.beam(f, fi, nside))
            for c, f in class_feeds.items()
        }
        npol = tel.num_pol_sky
        first = next(iter(beams.values()))
        out = []
        for ci, cj in uniq:
            if first.ndim == 1:
                bp = (beams[ci] * np.conj(beams[cj]))[None, :]
                if npol == 4:
                    z = np.zeros_like(bp)
                    bp = np.concatenate([bp, z, z, z], axis=0)
            else:
                Et_i, Ep_i = beams[ci][:, 0], beams[ci][:, 1]
                Et_j, Ep_j = beams[cj][:, 0], beams[cj][:, 1]
                tt = Et_i * np.conj(Et_j)
                pp = Ep_i * np.conj(Ep_j)
                tp = Et_i * np.conj(Ep_j)
                pt = Ep_i * np.conj(Et_j)
                B = [
                    0.5 * (tt + pp),
                    0.5 * (tt - pp),
                    0.5 * (tp + pt),
                    0.5j * (tp - pt),
                ]
                bp = np.stack(B[:npol], axis=0)
            out.append(bp)
        omega_pix = 4 * np.pi / healpix.npix_of(nside)
        return u_idx, np.stack(out) * omega_pix

    def _support_mask(self) -> np.ndarray:
        """Union of |beam product| over frequencies and beamclass pairs.

        Defines the compact support the windowed SHT restricts to; the
        union over frequencies covers beam-width variation across the
        band.
        """
        support = np.zeros(healpix.npix_of(self.beam_nside))
        for fi in range(self.telescope.nfreq):
            _, bprod = self._beam_products(fi)
            support = np.maximum(support, np.abs(bprod).max(axis=(0, 1)))
        return support

    def _beam_window(self):
        """WindowedSHT over the beam support, or None if not compact.

        Cached on the instance, keyed by the env knobs that define it
        (DRACO_TPU_BT_WINDOW to disable, DRACO_TPU_BT_WINDOW_TAU for the
        threshold) — a mid-process flip of either must rebuild, not
        reuse the latched window (accuracy cross-checks depend on it).
        """
        env_key = (
            os.environ.get("DRACO_TPU_BT_WINDOW"),
            os.environ.get("DRACO_TPU_BT_WINDOW_TAU"),
        )
        cached = getattr(self, "_win_cache", "unset")
        if cached != "unset" and self._win_cache_key == env_key:
            return self._win_cache
        self._win_cache_key = env_key
        from ..ops.sht_window import WindowedSHT, support_fraction

        win = None
        if os.environ.get("DRACO_TPU_BT_WINDOW", "1") != "0":
            # Relative beam-product threshold below which pixels are
            # dropped from the window.  GEMM/trig work in every windowed
            # path scales linearly with the window pixel count, so this
            # trades wall-clock directly against a truncation error of
            # roughly tau relative; at the 1e-6 default the measured
            # end-to-end f32-vs-f64 map error (1.56e-5 at nside=64) is
            # bit-for-bit indistinguishable from tau=1e-9 — f32 rounding
            # dominates truncation by an order of magnitude.
            tau = float(os.environ.get("DRACO_TPU_BT_WINDOW_TAU", "1e-6"))
            support = self._support_mask()
            if support_fraction(support, tau=tau) <= 0.25:
                s = sht.get_sht(
                    self.beam_nside, self.telescope.lmax, self.telescope.mmax
                )
                cand = WindowedSHT(s, support, tau=tau, margin=4)
                if cand.coverage <= 0.5:
                    win = cand
        self._win_cache = win
        return win

    def generate(self, regen: bool = False) -> "BeamTransfer":
        """Compute the beam transfer tensors for every frequency.

        Beams with compact support (any real primary beam) go through the
        windowed SHT (:mod:`draco_tpu.ops.sht_window`): the fringe x beam
        analysis runs on the few percent of pixels where the beam product
        is non-negligible — same accuracy, an order of magnitude less
        ring-DFT and Legendre work.
        """
        if self._bp is not None and not regen:
            return self
        tel = self.telescope
        s = sht.get_sht(self.beam_nside, tel.lmax, tel.mmax)
        bp_f, bm_f = [], []
        # The beam maps already carry the pixel solid angle; undo the SHT's
        # internal quadrature weight.
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        win = self._beam_window()
        if win is not None:
            # The whole chunk is one jitted program.
            # The rectangular [Rb, W] box layout is the right structure
            # HERE (unlike the streaming/fused paths, which use the flat
            # layout): the windowed analysis contracts the W axis against
            # Ec/Es [Rb, W, M+1] inside one einsum, never materialising a
            # per-pixel [.., Kf, M+1] intermediate — which a flat-layout
            # analysis would need (prohibitive at chunked-B scale).
            vec = np.asarray(healpix.pix2vec(self.beam_nside), np.float64)
            # flat [Rb*W, 3] three-part split (exact fringe phases)
            vw = _split3(vec[win.window_index].reshape(-1, 3))
            lam_band = win._ensure_lam()
            Ec, Es = win._Ec, win._Es

            @jax.jit
            def gen_chunk(bl, br_u, bi_u, uidx, vw, Ec, Es, lam_band):
                turns = tools.phase_frac3(*bl, *vw).reshape(
                    bl[0].shape[0], Ec.shape[0], Ec.shape[1]
                )
                c, sn = tools.sincos_turns(turns)
                c = c[:, None]
                sn = sn[:, None]
                br = br_u[uidx]
                bi = bi_u[uidx]
                ri = jnp.stack([br * c - bi * sn, br * sn + bi * c])
                # windowed real analysis of the [Re, Im] pair
                Fc = jnp.einsum("...rw,rwm->...rm", ri, Ec, precision=_PREC)
                Fs = jnp.einsum("...rw,rwm->...rm", ri, Es, precision=_PREC)
                ar = jnp.einsum(
                    "lmr,...rm->...lm", lam_band, Fc, precision=_PREC
                )
                ai = -jnp.einsum(
                    "lmr,...rm->...lm", lam_band, Fs, precision=_PREC
                )
                A = jax.lax.complex(ar, ai)  # [2, C, p, L+1, M+1]
                af = A[0] + 1j * A[1]
                ac = A[0] - 1j * A[1]
                # Bp = conj(alm(conj B)) * scale; Bm = conj(alm(B)) * scale
                return jnp.conj(ac) * scale, jnp.conj(af) * scale

            for fi in range(tel.nfreq):
                u_idx, bprod = self._beam_products(fi)
                bw = bprod[..., win.window_index]
                br_u = jnp.asarray(bw.real.astype(np.float32))
                bi_u = jnp.asarray(bw.imag.astype(np.float32))
                bl3 = tel.baseline_vectors_3d() / tel.wavelengths[fi]
                bps, bms = [], []
                for b0, b1 in self._stream_chunks(2048):
                    bp_c, bm_c = gen_chunk(
                        _split3(bl3[b0:b1]),
                        br_u,
                        bi_u,
                        jnp.asarray(u_idx[b0:b1]),
                        vw,
                        Ec,
                        Es,
                        lam_band,
                    )
                    bps.append(bp_c)
                    bms.append(bm_c)
                bp_f.append(jnp.concatenate(bps))
                bm_f.append(jnp.concatenate(bms))
            self._bp = jnp.stack(bp_f).astype(jnp.complex64)
            self._bm = jnp.stack(bm_f).astype(jnp.complex64)
            self._bm = self._bm.at[..., 0].set(0.0)
            return self
        # Compute the split Legendre tensors once: the per-frequency
        # transforms become pure batched GEMMs with no sequential
        # l-recurrence, contracted per ring section (no big concats).
        lam = jax.jit(lambda: s.precompute_legendre_split(jnp.float32))()

        # Analysis is linear: alm(B) = alm(Re) + i alm(Im) and
        # alm(conj B) = alm(Re) - i alm(Im) — one real-input batched
        # transform yields both conjugate projections at half the
        # ring-GEMM FLOPs.  Bp = conj(SHT(conj B)); Bm = conj(SHT(B)).
        # One jit end-to-end.
        @jax.jit
        def dense_freq(bmaps, lam):
            ri = s._analysis_impl(
                jnp.stack([bmaps.real, bmaps.imag]), lam=lam
            )
            alm_f = ri[0] + 1j * ri[1]
            alm_c = ri[0] - 1j * ri[1]
            return jnp.conj(alm_c) * scale, jnp.conj(alm_f) * scale

        for fi in range(tel.nfreq):
            bmaps = self._beam_fringe_maps(fi)  # [nbase, npol, npix]
            bp_c, bm_c = dense_freq(bmaps, lam)
            bp_f.append(bp_c)
            bm_f.append(bm_c)
        # The m = 0 negative block duplicates conj(V_0); the m-mode
        # containers leave [m=0, msign=1] empty (reference
        # transform.py:701-703), so zero it for a consistent operator.
        @jax.jit
        def finalize(bp_f, bm_f):
            bp = jnp.stack(bp_f).astype(jnp.complex64)
            bm = jnp.stack(bm_f).astype(jnp.complex64)
            return bp, bm.at[..., 0].set(0.0)

        self._bp, self._bm = finalize(bp_f, bm_f)
        return self

    # -- projection API (reference parity) --------------------------------------
    def beam_m(self, m: int, fi: int | None = None) -> np.ndarray:
        """Beam transfer matrix for one m: [(nfreq,) ntel, npol, lmax+1].

        Equivalent of driftscan ``BeamTransfer.beam_m`` as consumed at
        reference draco/analysis/mapmaker.py:162.
        """
        self.generate()
        sel = slice(None) if fi is None else fi
        bp = np.asarray(self._bp[sel, ..., m])  # [..., nbase, npol, L+1]
        bm = np.asarray(self._bm[sel, ..., m])
        return np.concatenate([bp, bm], axis=-3)

    def project_vector_sky_to_telescope(self, m: int, alm) -> np.ndarray:
        """Project sky alm [npol, lmax+1(, nfreq?)] -> [ntel] for one m.

        Matches the per-m API (reference draco/synthesis/stream.py:110).
        """
        self.generate()
        alm = np.asarray(alm)
        if alm.ndim == 2:  # [npol, l] single freq not supported; need freq
            bm_full = self.beam_m(m)  # [nfreq, ntel, npol, L+1]
            return np.einsum("ftpl,pl->ft", bm_full, alm)
        # [nfreq, npol, l]
        bm_full = self.beam_m(m)
        return np.einsum("ftpl,fpl->ft", bm_full, alm)

    def project_sky_to_telescope(self, alm) -> jnp.ndarray:
        """Batched projection over every m (the device path).

        Parameters
        ----------
        alm
            Sky harmonics [nfreq, npol, lmax+1, mmax+1].

        Returns
        -------
        vis
            [mmax+1, 2, nfreq, nbase] with msign 0 = V_m, 1 = conj(V_{-m}).
        """
        self.generate()
        from ..ops.tools import as_device

        alm = as_device(np.asarray(alm)) if not isinstance(
            alm, jnp.ndarray
        ) else alm
        return _project_fwd_jit(self._bp, self._bm, alm)

    def project_telescope_to_sky_dirty(self, vis, weight) -> jnp.ndarray:
        """Adjoint (dirty-map) projection over every m.

        a_lm = sum_tel conj(B)[tel, l, m] * w[tel] * v[tel] batched over
        (m, freq): the device analogue of DirtyMapMaker._solve_m
        (reference draco/analysis/mapmaker.py:156-168).

        Parameters
        ----------
        vis
            [mmax+1, 2, nfreq, nbase].
        weight
            Same shape inverse-variance weights.

        Returns
        -------
        alm
            [nfreq, npol, lmax+1, mmax+1].
        """
        self.generate()
        from ..ops.tools import as_device

        vis_d = as_device(np.asarray(vis)) if not isinstance(
            vis, jnp.ndarray
        ) else vis
        w_d = jnp.asarray(np.asarray(weight)) if not isinstance(
            weight, jnp.ndarray
        ) else weight
        return _project_adj_jit(self._bp, self._bm, vis_d, w_d)

    # -- streaming (factorised) projections ------------------------------------
    #
    # With B = sum_r conj(F)[b, p, r, m] Lambda[l, m, r] / omega (F = ring
    # coefficients of the fringe x beam-product maps), the projection
    # factorises so B is never materialised:
    #
    #   vis_p[m, b] = sum_{p, r} conj(F_cb) S[p, m, r] / omega,
    #   S = sum_l Lambda alm  (contracted once per frequency),
    #
    # and the adjoint accumulates T[p, r, m] = sum_b F (w v) per baseline
    # chunk, applying Lambda once at the end.  Analysis linearity gives
    # both conjugate F's from one real [Re, Im] transform.  This is how
    # production-scale configurations (beam tensors >> HBM) run; the
    # repo-root bench uses the same structure.

    def _streaming_ops(self):
        s, lam, _lam_lo, plan = self._streaming_ops2()
        return s, lam, plan

    def _streaming_ops2(self):
        """(sht, lam_hi, lam_lo, plan) — two-float Legendre variant.

        ``lam_lo`` is None when DRACO_TPU_COMP_LEGENDRE=0 (single-f32
        storage, the pre-round-3 behaviour); otherwise the (hi, lo)
        pair from :meth:`SHT.precompute_legendre_split_2f`, whose lo
        terms remove the Legendre storage-quantization error from the
        round trip (scripts/ablate_const_precision.py).
        """
        if getattr(self, "_stream_ops2", None) is None:
            s = sht.get_sht(self.beam_nside, self.telescope.lmax,
                            self.telescope.mmax)
            comp = os.environ.get("DRACO_TPU_COMP_LEGENDRE", "1") not in (
                "0",
                "",
            )

            # Argument-streamed builders: a single no-input jit here
            # made XLA constant-fold the ENTIRE constants build at
            # compile time (80 s compile / multi-GB executable for ~0 s
            # of execution at nside=256) — the dominant fresh-process
            # warmup cost whenever the compile cache missed.  The
            # streamed variants compile a handful of small chunk
            # programs and actually RUN the build (round 4).
            if comp:
                lam, lam_lo = s.precompute_legendre_split_2f_streamed()
            else:
                # legacy single-f32 path (DRACO_TPU_COMP_LEGENDRE=0):
                # kept as the one-jit build
                lam = jax.jit(
                    lambda: s.precompute_legendre_split(jnp.float32)
                )()
                lam_lo = None
            plan = s.precompute_ring_plan_streamed()
            self._stream_ops2 = (s, lam, lam_lo, plan)
        return self._stream_ops2

    def _stream_chunks(self, chunk):
        nbase = len(self.telescope.uniquepairs)
        if chunk is None:
            chunk = max(1, min(nbase, 256))
        for b0 in range(0, nbase, chunk):
            yield b0, min(b0 + chunk, nbase)

    def _stream_geometry(self):
        """Device three-part pixel vectors for exact phases."""
        if getattr(self, "_stream_geo", None) is None:
            vec = np.asarray(healpix.pix2vec(self.beam_nside), np.float64)
            self._stream_geo = _split3(vec)
        return self._stream_geo

    @staticmethod
    def _stream_bmaps(vec, bl_w, u_re, u_im, uidx):
        """Device-side fringe x beam-product maps: ([C,p,npix] re, im).

        ``vec`` and ``bl_w`` are three-part splits — exact fringe phases
        independent of baseline length (ops.tools.phase_frac3).
        """
        c, sn = tools.sincos_turns(tools.phase_frac3(*bl_w, *vec))
        c = c[:, None, :]
        sn = sn[:, None, :]
        br = u_re[uidx]
        bi = u_im[uidx]
        return br * c - bi * sn, br * sn + bi * c

    # -- windowed streaming (compact beams) --------------------------------
    #
    # When the beam support is compact the streaming projections use the
    # fused windowed formulation (see bench.py and ops/sht_window.py):
    # with a1 + i a2 = (Ec + i Es) S per (pol, ring, pixel), the chunk
    # visibilities are four flat [C, p*Rb*W] x [p*Rb*W, M+1] GEMMs and the
    # adjoint accumulates the transposed GEMMs into Y[(p r w), m], with
    # (Ec - i Es) and Lambda applied once after the loop.

    def _windowed_stream_fns(self, win):
        # Every device tensor (Ec/Es/lam_band/vecw) is threaded through as
        # a jit ARGUMENT: device arrays captured in a jit closure are baked
        # into the HLO as literals, which bloats compiles.
        #
        # The jitted closures are cached on the instance — rebuilding them
        # per call would miss the jit cache and recompile every streaming
        # projection (the retrace-per-call bug class fixed elsewhere in
        # the stackers).
        cached = self.__dict__.get("_win_stream_cache")
        if cached is not None and cached[0] is win:
            return cached[1]
        s = win.sht
        mmax = s.mmax
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))
        vec = healpix.pix2vec(self.beam_nside)
        # flat (ragged) window layout: work scales with the true support
        # pixel count, not the Rb x W bounding box
        vw = _split3(np.asarray(vec, np.float64)[win.flat_index])
        lam_band = win._ensure_lam()
        Ecf, Esf = win._Ecf, win._Esf  # quadrature weight folded in
        consts = (Ecf, Esf, lam_band, vw, win.flat_ring, win.ring_onehot)

        @jax.jit
        def sky_phase_tensors(alm_r, alm_i, consts):
            Ecf, Esf, lam_band, _, flat_ring, _ = consts
            Sr = jnp.einsum(
                "plm,lmr->prm", alm_r, lam_band, precision=_PREC
            )
            Si = jnp.einsum(
                "plm,lmr->prm", alm_i, lam_band, precision=_PREC
            )
            Srk = jnp.take(Sr, flat_ring, axis=1)  # [p, Kf, M+1]
            Sik = jnp.take(Si, flat_ring, axis=1)
            a1 = Ecf * Srk - Esf * Sik
            a2 = Ecf * Sik + Esf * Srk
            return a1.reshape(-1, mmax + 1), a2.reshape(-1, mmax + 1)

        def fringe_win(bl_w, u_re_w, u_im_w, uidx, vw):
            # three-part splits: exact fringe phases
            cp, sp = tools.sincos_turns(tools.phase_frac3(*bl_w, *vw))
            cp = cp[:, None]
            sp = sp[:, None]
            br = u_re_w[uidx]  # [C, p, Kf]
            bi = u_im_w[uidx]
            nc = bl_w[0].shape[0]
            re = (br * cp - bi * sp).reshape(nc, -1)
            im = (br * sp + bi * cp).reshape(nc, -1)
            return re, im

        @jax.jit
        def chunk_vis_win(bl_w, u_re_w, u_im_w, uidx, a1, a2, consts):
            re, im = fringe_win(bl_w, u_re_w, u_im_w, uidx, consts[3])
            G1 = jnp.matmul(re, a1, precision=_PREC)
            G2 = jnp.matmul(im, a2, precision=_PREC)
            G3 = jnp.matmul(re, a2, precision=_PREC)
            G4 = jnp.matmul(im, a1, precision=_PREC)
            vp = ((G1 - G2) + 1j * (G3 + G4)).T * scale
            vm = ((G1 + G2) + 1j * (G3 - G4)).T * scale
            return jnp.stack([vp.real, vp.imag, vm.real, vm.imag])

        @jax.jit
        def chunk_Y_win(
            bl_w, u_re_w, u_im_w, uidx, vs_r, vs_i, vd_r, vd_i, Y_r, Y_i,
            consts,
        ):
            re, im = fringe_win(bl_w, u_re_w, u_im_w, uidx, consts[3])
            Y_r = Y_r + jnp.matmul(re.T, vs_r, precision=_PREC) - jnp.matmul(
                im.T, vd_i, precision=_PREC
            )
            Y_i = Y_i + jnp.matmul(re.T, vs_i, precision=_PREC) + jnp.matmul(
                im.T, vd_r, precision=_PREC
            )
            return Y_r, Y_i

        npol = self.telescope.num_pol_sky

        @jax.jit
        def finish_Y_win(Y_r, Y_i, consts):
            Ecf, Esf, lam_band, _, _, ring_onehot = consts
            # conjugate per-pixel DFT factors, then the pixel -> ring
            # reduction as a one-hot GEMM instead of a scatter
            Y_r = Y_r.reshape(npol, win.Kf, mmax + 1)
            Y_i = Y_i.reshape(npol, win.Kf, mmax + 1)
            Tr = Ecf * Y_r + Esf * Y_i
            Ti = Ecf * Y_i - Esf * Y_r
            Tr = jnp.einsum("rk,pkm->prm", ring_onehot, Tr, precision=_PREC)
            Ti = jnp.einsum("rk,pkm->prm", ring_onehot, Ti, precision=_PREC)
            a = jax.lax.complex(
                jnp.einsum("lmr,prm->plm", lam_band, Tr, precision=_PREC),
                jnp.einsum("lmr,prm->plm", lam_band, Ti, precision=_PREC),
            ) * scale
            return jnp.stack([a.real, a.imag])

        out = (consts, sky_phase_tensors, chunk_vis_win, chunk_Y_win,
               finish_Y_win)
        self._win_stream_cache = (win, out)
        return out

    def _project_sky_streaming_windowed(self, alm, win, chunk=None):
        tel = self.telescope
        s = win.sht
        mmax = s.mmax
        bl3 = tel.baseline_vectors_3d().astype(np.float64)
        nbase = len(tel.uniquepairs)
        consts, sky_phase_tensors, chunk_vis_win, _, _ = (
            self._windowed_stream_fns(win)
        )

        alm = tools.device_to_numpy(alm)
        vis = np.zeros((mmax + 1, 2, tel.nfreq, nbase), dtype=np.complex64)
        for fi in range(tel.nfreq):
            a1, a2 = sky_phase_tensors(
                jnp.asarray(np.ascontiguousarray(alm[fi].real, dtype=np.float32)),
                jnp.asarray(np.ascontiguousarray(alm[fi].imag, dtype=np.float32)),
                consts,
            )
            u_idx, bprod = self._beam_products(fi)
            bw = bprod[..., win.flat_index]
            u_re = jnp.asarray(bw.real.astype(np.float32))
            u_im = jnp.asarray(bw.imag.astype(np.float32))
            lam_f = tel.wavelengths[fi]
            for b0, b1 in self._stream_chunks(chunk):
                out = np.asarray(
                    chunk_vis_win(
                        _split3(bl3[b0:b1] / lam_f),
                        u_re,
                        u_im,
                        jnp.asarray(u_idx[b0:b1]),
                        a1,
                        a2,
                        consts,
                    )
                )
                vis[:, 0, fi, b0:b1] = out[0] + 1j * out[1]
                vis[:, 1, fi, b0:b1] = out[2] + 1j * out[3]
        vis[0, 1] = 0.0
        return tools.numpy_to_device(vis)

    def _project_dirty_streaming_windowed(self, wv, win, chunk=None):
        tel = self.telescope
        s = win.sht
        mmax = s.mmax
        npol = tel.num_pol_sky
        bl3 = tel.baseline_vectors_3d().astype(np.float64)
        consts, _, _, chunk_Y_win, finish_Y_win = self._windowed_stream_fns(win)
        nwin = npol * win.Kf

        alm_out = []
        for fi in range(tel.nfreq):
            u_idx, bprod = self._beam_products(fi)
            bw = bprod[..., win.flat_index]
            u_re = jnp.asarray(bw.real.astype(np.float32))
            u_im = jnp.asarray(bw.imag.astype(np.float32))
            lam_f = tel.wavelengths[fi]
            Y_r = jnp.zeros((nwin, mmax + 1), jnp.float32)
            Y_i = jnp.zeros((nwin, mmax + 1), jnp.float32)
            for b0, b1 in self._stream_chunks(chunk):
                v0 = wv[:, 0, fi, b0:b1]
                v1 = wv[:, 1, fi, b0:b1]
                vs = (v0 + v1).T  # [C, M+1]
                vd = (v1 - v0).T
                Y_r, Y_i = chunk_Y_win(
                    _split3(bl3[b0:b1] / lam_f),
                    u_re,
                    u_im,
                    jnp.asarray(u_idx[b0:b1]),
                    jnp.asarray(np.ascontiguousarray(vs.real)),
                    jnp.asarray(np.ascontiguousarray(vs.imag)),
                    jnp.asarray(np.ascontiguousarray(vd.real)),
                    jnp.asarray(np.ascontiguousarray(vd.imag)),
                    Y_r,
                    Y_i,
                    consts,
                )
            out = np.asarray(finish_Y_win(Y_r, Y_i, consts))
            alm_out.append(out[0] + 1j * out[1])
        return tools.numpy_to_device(np.stack(alm_out).astype(np.complex64))

    def project_sky_to_telescope_streaming(self, alm, chunk=None):
        """Streaming equivalent of :meth:`project_sky_to_telescope`.

        Never materialises the beam-transfer tensors: per (freq, baseline
        chunk) the fringe x beam maps are built ON DEVICE (only the
        deduped beamclass products are transferred) and contracted
        against the per-frequency sky sections.  Memory scales with the
        chunk, not with nbase x lmax x mmax.  Compact beams go through
        the windowed formulation (an order of magnitude less work).
        """
        win = self._beam_window()
        if win is not None:
            return self._project_sky_streaming_windowed(alm, win, chunk)
        s, lam, plan = self._streaming_ops()
        tel = self.telescope
        alm = tools.as_device(alm)  # [nfreq, npol, L+1, M+1]
        bl3 = tel.baseline_vectors_3d().astype(np.float64)
        nbase = len(tel.uniquepairs)
        mmax = s.mmax
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))

        @jax.jit
        def sky_sections(alm_f, lam):
            def contract(lam_s):
                return jax.lax.complex(
                    jnp.einsum("plm,lmr->pmr", alm_f.real, lam_s,
                               precision=_PREC),
                    jnp.einsum("plm,lmr->pmr", alm_f.imag, lam_s,
                               precision=_PREC),
                )

            return [contract(lam["belt"])] + [
                contract(c) for c in lam["caps"]
            ]

        @jax.jit
        def chunk_vis(vec, bl_w, u_re, u_im, uidx, S_secs, plan):
            re, im = self._stream_bmaps(vec, bl_w, u_re, u_im, uidx)
            F_belt, group_F = s._ring_analysis_parts(
                jnp.stack([re, im]), plan=plan
            )  # each [2, C, p, r, M+1]
            U = jnp.zeros((mmax + 1, bl_w[0].shape[0]), jnp.complex64)
            V = jnp.zeros((mmax + 1, bl_w[0].shape[0]), jnp.complex64)
            for F2, S in zip([F_belt, *group_F], S_secs):
                U = U + jnp.einsum(
                    "cprm,pmr->mc", jnp.conj(F2[0]), S, precision=_PREC
                )
                V = V + jnp.einsum(
                    "cprm,pmr->mc", jnp.conj(F2[1]), S, precision=_PREC
                )
            vp = (U + 1j * V) * scale
            vm = (U - 1j * V) * scale
            return jnp.stack([vp.real, vp.imag, vm.real, vm.imag])

        vis = np.zeros((mmax + 1, 2, tel.nfreq, nbase), dtype=np.complex64)
        for fi in range(tel.nfreq):
            S_secs = sky_sections(alm[fi].astype(jnp.complex64), lam)
            u_idx, bprod = self._beam_products(fi)
            u_re = jnp.asarray(bprod.real.astype(np.float32))
            u_im = jnp.asarray(bprod.imag.astype(np.float32))
            lam_f = tel.wavelengths[fi]
            for b0, b1 in self._stream_chunks(chunk):
                out = np.asarray(
                    chunk_vis(
                        self._stream_geometry(),
                        _split3(bl3[b0:b1] / lam_f),
                        u_re,
                        u_im,
                        jnp.asarray(u_idx[b0:b1]),
                        S_secs,
                        plan,
                    )
                )
                vis[:, 0, fi, b0:b1] = out[0] + 1j * out[1]
                vis[:, 1, fi, b0:b1] = out[2] + 1j * out[3]
        # m-mode container convention: [m=0, msign=1] is empty
        vis[0, 1] = 0.0
        return tools.numpy_to_device(vis)

    def project_telescope_to_sky_dirty_streaming(self, vis, weight,
                                                 chunk=None):
        """Streaming equivalent of :meth:`project_telescope_to_sky_dirty`."""
        tel = self.telescope
        # host-side weighting: the inputs may be host arrays
        wv = tools.device_to_numpy(vis) * tools.device_to_numpy(weight)
        # the materialised operator zeroes Bm at m=0 (the [m=0, msign=1]
        # container block is empty by convention) — match it exactly
        wv[0, 1] = 0.0
        win = self._beam_window()
        if win is not None:
            return self._project_dirty_streaming_windowed(wv, win, chunk)
        s, lam, plan = self._streaming_ops()
        mmax = s.mmax
        scale = 1.0 / (4 * np.pi / healpix.npix_of(self.beam_nside))

        bl3 = tel.baseline_vectors_3d().astype(np.float64)

        @jax.jit
        def chunk_T(vec, bl_w, u_re, u_im, uidx, vs_r, vs_i, vd_r, vd_i,
                    T_secs, plan):
            re, im = self._stream_bmaps(vec, bl_w, u_re, u_im, uidx)
            F_belt, group_F = s._ring_analysis_parts(
                jnp.stack([re, im]), plan=plan
            )
            # conj(bp) = F_cb Lambda scale; conj(bm) = F_b Lambda scale
            v_sum = jax.lax.complex(vs_r, vs_i)
            v_dif = jax.lax.complex(vd_r, vd_i)
            out = []
            for F2, T in zip([F_belt, *group_F], T_secs):
                T = T + jnp.einsum(
                    "cprm,mc->prm", F2[0], v_sum, precision=_PREC
                )
                T = T + 1j * jnp.einsum(
                    "cprm,mc->prm", F2[1], v_dif, precision=_PREC
                )
                out.append(T)
            return out

        @jax.jit
        def finish(T_secs, lam):
            a = None
            for T, lam_s in zip(T_secs, [lam["belt"], *lam["caps"]]):
                blk = jax.lax.complex(
                    jnp.einsum("lmr,prm->plm", lam_s, T.real,
                               precision=_PREC),
                    jnp.einsum("lmr,prm->plm", lam_s, T.imag,
                               precision=_PREC),
                )
                a = blk if a is None else a + blk
            a = a * scale
            return jnp.stack([a.real, a.imag])

        npol = tel.num_pol_sky
        sec_r = [lam["belt"].shape[2]] + [c.shape[2] for c in lam["caps"]]

        @jax.jit
        def zeros_T():
            return [
                jnp.zeros((npol, r, mmax + 1), jnp.complex64) for r in sec_r
            ]

        out = []
        for fi in range(tel.nfreq):
            u_idx, bprod = self._beam_products(fi)
            u_re = jnp.asarray(bprod.real.astype(np.float32))
            u_im = jnp.asarray(bprod.imag.astype(np.float32))
            lam_f = tel.wavelengths[fi]
            T_secs = zeros_T()
            for b0, b1 in self._stream_chunks(chunk):
                v_sum = wv[:, 0, fi, b0:b1] + wv[:, 1, fi, b0:b1]
                v_dif = wv[:, 1, fi, b0:b1] - wv[:, 0, fi, b0:b1]
                T_secs = chunk_T(
                    self._stream_geometry(),
                    _split3(bl3[b0:b1] / lam_f),
                    u_re,
                    u_im,
                    jnp.asarray(u_idx[b0:b1]),
                    jnp.asarray(v_sum.real.copy()),
                    jnp.asarray(v_sum.imag.copy()),
                    jnp.asarray(v_dif.real.copy()),
                    jnp.asarray(v_dif.imag.copy()),
                    T_secs,
                    plan,
                )
            ri = np.asarray(finish(T_secs, lam))
            out.append(ri[0] + 1j * ri[1])
        return tools.numpy_to_device(np.stack(out))

    # -- SVD products -------------------------------------------------------------
    def _ensure_svd(self):
        """Batched per-(freq, m) SVD of the beam matrix.

        Stores U [nfreq, M+1, ndof, ntel], singular values and per-m mode
        counts; ragged ranks are padded with zero rows (SURVEY.md 'hard
        parts' (a): padding-to-bucket for m-dependent mode counts).
        """
        if self._svd is not None:
            return
        self.generate()
        tel = self.telescope
        L1 = tel.lmax + 1
        M1 = tel.mmax + 1
        nsky = self.nsky
        # B matrix per (freq, m): [ntel, nsky]
        # ONE jitted program
        U, s, Vh, keep, nmode = _svd_build_jit(
            self._bp, self._bm, float(self.svcut), ntel=self.ntel, nsky=nsky
        )
        self._svd = {
            "U": U,  # [f, M1, ntel, k]
            "s": s,  # [f, M1, k]
            "Vh": Vh,  # [f, M1, k, nsky]
            "keep": keep,
            "nmode": nmode,  # [f, M1]
        }

    def svd_len(self, m: int | None = None) -> int:
        """Number of SVD modes: the per-m count, or the padded maximum.

        With ``m`` given this is the true retained rank at that m (the
        driftscan per-m semantics); without it, the uniform padded k
        every batched tensor is allocated with.
        """
        self._ensure_svd()
        if m is not None:
            return int(np.asarray(self._svd["nmode"])[:, m].max())
        return int(np.asarray(self._svd["s"]).shape[-1])

    def svd_spectrum(self) -> np.ndarray:
        """Singular value spectrum [nfreq, M+1, k]."""
        self._ensure_svd()
        return np.asarray(self._svd["s"])

    def nmodes(self) -> np.ndarray:
        self._ensure_svd()
        return np.asarray(self._svd["nmode"])

    def _svd_host(self) -> dict:
        """Host copies of U/keep for the per-m vector APIs.

        Fetched ONCE.
        """
        if getattr(self, "_svd_np", None) is None:
            self._svd_np = {
                "U": tools.device_to_numpy(self._svd["U"]),
                "keep": np.asarray(self._svd["keep"]),
            }
        return self._svd_np

    def project_vector_telescope_to_svd(self, m: int, tm) -> np.ndarray:
        """Telescope vector(s) -> SVD basis for one m.

        tm: [nfreq, ntel] (or [2, npairs] flattened); returns [nfreq, k].
        """
        self._ensure_svd()
        tm = np.asarray(tm).reshape(-1, self.ntel)
        host = self._svd_host()
        U = host["U"][:, m]  # [f, ntel, k]
        keep = host["keep"][:, m]  # [f, k]
        out = np.einsum("ftk,ft->fk", np.conj(U), tm)
        return out * keep

    def project_vector_svd_to_telescope(self, m: int, svdm) -> np.ndarray:
        """SVD vector(s) -> telescope basis for one m."""
        self._ensure_svd()
        svdm = np.asarray(svdm).reshape(-1, self.svd_len())
        host = self._svd_host()
        U = host["U"][:, m]
        keep = host["keep"][:, m]
        return np.einsum("ftk,fk->ft", U, svdm * keep)

    def project_telescope_to_svd(self, vis) -> jnp.ndarray:
        """Batched telescope->SVD over every m: [M+1, nfreq, k].

        ONE jitted program.
        """
        self._ensure_svd()
        from ..ops.tools import as_device

        vis = as_device(vis)  # [M+1, 2, nfreq, nbase]
        return _tel2svd_jit(self._svd["U"], self._svd["keep"], vis)

    def project_svd_to_telescope(self, svdm) -> jnp.ndarray:
        """Batched SVD->telescope over every m (adjoint of the above).

        svdm : [M+1, nfreq, k] -> [M+1, nfreq, ntel].  The vmapped
        device inverse of the reference's per-m
        ``project_vector_svd_to_telescope`` host loop.
        """
        self._ensure_svd()
        from ..ops.tools import as_device

        return _svd2tel_jit(
            self._svd["U"], self._svd["keep"], as_device(svdm)
        )

    # -- persistence -----------------------------------------------------------
    def save(self, directory: str | None = None):
        """Save generated products (beam tensors + telescope config)."""
        import pickle

        directory = directory or self.directory
        os.makedirs(directory, exist_ok=True)
        self.generate()
        from ..ops.tools import device_to_numpy

        np.save(
            os.path.join(directory, "beam_p.npy"), device_to_numpy(self._bp)
        )
        np.save(
            os.path.join(directory, "beam_m.npy"), device_to_numpy(self._bm)
        )
        with open(os.path.join(directory, "telescope.pkl"), "wb") as f:
            pickle.dump(self._telescope, f)

    def load(self, directory: str):
        import pickle

        with open(os.path.join(directory, "telescope.pkl"), "rb") as f:
            self._telescope = pickle.load(f)
        bp_path = os.path.join(directory, "beam_p.npy")
        if os.path.exists(bp_path):
            from ..ops.tools import as_device

            self._bp = as_device(np.load(bp_path))
            self._bm = as_device(
                np.load(os.path.join(directory, "beam_m.npy"))
            )
        return self


@partial(jax.jit, static_argnames=("ntel", "nsky"))
def _svd_build_jit(bp, bm, svcut, *, ntel, nsky):
    """Batched per-(freq, m) economy SVD of the beam matrix, one program."""
    B = jnp.concatenate([bp, bm], axis=1)  # [f, ntel, p, L1, M1]
    B = jnp.moveaxis(B, -1, 1)  # [f, M1, ntel, p, L1]
    B = B.reshape(B.shape[0], B.shape[1], ntel, nsky)
    U, s, Vh = jnp.linalg.svd(B, full_matrices=False)
    smax = jnp.max(s, axis=-1, keepdims=True)
    keep = s > svcut * jnp.maximum(smax, 1e-30)
    return U, s, Vh, keep, keep.sum(axis=-1)


@jax.jit
def _tel2svd_jit(U, keep, vis):
    tm = jnp.moveaxis(vis, 2, 1).reshape(
        vis.shape[0], vis.shape[2], -1
    )  # [M+1, f, ntel]
    out = jnp.einsum(
        "fmtk,mft->mfk", jnp.conj(U), tm.astype(U.dtype), precision=_PREC
    )
    return out * jnp.moveaxis(keep, 0, 1)


@jax.jit
def _svd2tel_jit(U, keep, svdm):
    svdm = svdm * jnp.moveaxis(keep, 0, 1)
    return jnp.einsum(
        "fmtk,mfk->mft", U, svdm.astype(U.dtype), precision=_PREC
    )


@jax.jit
def _project_fwd_jit(bp, bm, alm):
    vp = jnp.einsum(
        "fbplm,fplm->mfb", bp, alm.astype(bp.dtype), precision=_PREC
    )
    vm = jnp.einsum(
        "fbplm,fplm->mfb", bm, alm.astype(bm.dtype), precision=_PREC
    )
    return jnp.stack([vp, vm], axis=1)


@jax.jit
def _project_adj_jit(bp, bm, vis, weight):
    wv = vis * weight
    a_p = jnp.einsum(
        "fbplm,mfb->fplm", jnp.conj(bp), wv[:, 0].astype(bp.dtype),
        precision=_PREC,
    )
    a_m = jnp.einsum(
        "fbplm,mfb->fplm", jnp.conj(bm), wv[:, 1].astype(bm.dtype),
        precision=_PREC,
    )
    return a_p + a_m
