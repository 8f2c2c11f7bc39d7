"""Fully-fused simulate -> map round trip.

One compiled XLA program runs the whole m-mode spine:

  sky map --SHT--> alm --windowed beam projection--> V_m --(weights)-->
  --adjoint--> dirty alm --inverse SHT--> map

The task chain this fuses (``SimulateSidereal -> MModeTransform ->
DirtyMapMaker``) additionally materialises the sidereal stream between
simulation and mapping; that iFFT -> FFT pair is algebraically the
identity on the m-modes (the stream always holds >= 2*mmax + 1
samples), so the fused program elides it and runs forward projection
and weighted adjoint in a SINGLE pass over baseline chunks — each
chunk's fringe x beam tensors (the HBM-dominant intermediates) are
built once and consumed by both GEMM sets while still in HBM.

Baseline chunks stream through an on-device ``fori_loop`` (the
beam-transfer tensors are never materialised; see
:meth:`BeamTransfer.project_sky_to_telescope_streaming` for the
per-chunk-dispatch variant this fuses), and frequencies batch through
every GEMM.  This is the round trip the repo-root benchmark measures, and
it is exposed to pipelines as the :class:`SimulateAndMap` task.

Large device tensors (window trig, Legendre bands, beam products,
baselines) are threaded through as jit *arguments*: closure-captured
device arrays serialise into the HLO as literals, which slows compiles
and bloats the compilation cache.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import healpix

_F32 = jnp.float32

# GEMM precision of the fused projection loops.  The default (HIGHEST,
# true f32) holds the end-to-end map error inside the 1e-5 contract;
# DRACO_TPU_ROUNDTRIP_PRECISION=high selects HIGH, which on an H100 is
# TF32 (see ops/sht.py), for throughput-bound sweeps that tolerate it.
#
# DRACO_TPU_ROUNDTRIP_LOOP_PRECISION controls ONLY the per-chunk
# baseline GEMMs (the contractions whose flops scale with npairs);
# the Legendre/DFT contractions — where the large-cancellation sums
# live — keep the main precision.  Defaults to the main precision.
from ..ops.sht import _prec_env

_PREC_RT = _prec_env(
    "DRACO_TPU_ROUNDTRIP_PRECISION", "DRACO_TPU_ROUNDTRIP_PRECISION"
)
_PREC_LOOP = _prec_env(
    "DRACO_TPU_ROUNDTRIP_LOOP_PRECISION", "DRACO_TPU_ROUNDTRIP_PRECISION"
)


def _pad_to(n: int, chunk: int) -> int:
    return (n + chunk - 1) // chunk * chunk


# Exact fringe phases: see ops.tools.phase_frac3 (shared by the fused
# programs).  Baselines and pixel vectors are pre-split on the host
# into three f32 parts so every high product on device is EXACTLY
# representable — immune to compiler FMA contraction (which breaks
# runtime Dekker/TwoSum schemes on the XLA:CPU truth path).  For the
# (usual) uniformly-spaced frequency grid the per-frequency phases form
# an arithmetic progression t_f = t_0 + f*dt, so the trig is evaluated
# only for t_0 and dt and each further frequency is ONE complex
# rotation — the per-frequency fringe build drops from ~100 elementwise
# ops per pixel to ~6.
from ..ops.tools import phase_frac3 as _phase_frac3
from ..ops.tools import sincos_turns as _sincos_turns
from ..ops.tools import threefloat_split as _threefloat_split


def _baseline_prep(tel, nfreq: int, nbase: int, chunk: int, order=None):
    """Chunk-padded baseline-phase tensors shared by both fused programs.

    Returns ``(npad, nchunk, ba, bb, bc, uniform)`` where ba/bb/bc are
    the three-part splits (:func:`threefloat_split`) of per-frequency
    baseline phase coefficients in turns per unit direction:

    - ``uniform=True`` (evenly spaced frequency grid): shape [2, npad,
      3] holding ``b * nu_0 / c`` and ``b * dnu / c`` — the base phase
      and the per-frequency-step phase increment of the arithmetic
      progression.
    - ``uniform=False``: shape [nfreq, npad, 3] holding ``b / lambda_f``
      for every frequency.

    ``order`` optionally permutes the baseline axis (m-support sort).
    """
    npad = _pad_to(nbase, chunk)
    nchunk = npad // chunk
    bl3 = tel.baseline_vectors_3d().astype(np.float64)
    if order is not None:
        bl3 = bl3[order]
    blp = np.zeros((npad, 3), np.float64)
    blp[:nbase] = bl3
    inv_wl = 1.0 / np.asarray(tel.wavelengths, dtype=np.float64)  # nu/c
    # Uniform frequency grid -> arithmetic-progression phases.  The
    # tolerance keeps the linear-fit phase error well under the fringe
    # builder's own ~3e-7-turn budget at u ~ 1e4 wavelengths.
    uniform = nfreq == 1
    if nfreq > 1:
        step = (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
        fit = inv_wl[0] + step * np.arange(nfreq)
        dev = np.abs(inv_wl - fit).max()
        uniform = bool(dev <= 1e-12 * np.abs(inv_wl).max())
    if uniform:
        step = 0.0 if nfreq == 1 else (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
        coeff = np.stack([blp * inv_wl[0], blp * step])  # [2, npad, 3]
    else:
        coeff = blp[None] * inv_wl[:, None, None]  # [nfreq, npad, 3]
    ba, bb, bc = _threefloat_split(coeff)
    return npad, nchunk, ba, bb, bc, uniform


def _geom_prep(tel, nfreq: int, nbase: int, chunk: int):
    """Geometric-baseline dedup of the fringe trig (full-sphere path).

    Redundancy-stacked DUAL-POL products share baseline geometry four
    ways (XX/XY/YX/YY of one feed separation), but the fringe
    ``cos/sin`` planes were computed per PRODUCT.  This
    sorts products by geometry and computes trig only for each chunk's
    distinct-geometry slice ([Gc, K] instead of [chunk, K]); products
    pick their rows back up with a one-hot selection GEMM inside the
    combine (value-exact at HIGHEST).  Phases are bit-identical to the
    per-product path (same three-float operands).

    Returns ``None`` when dedup would not pay (already-unique
    geometries), else ``(order, ga, gb, gc, g0s, lidx, Gc, uniform)``.
    Disable with ``DRACO_TPU_GEOM_DEDUP=0``.
    """
    if os.environ.get("DRACO_TPU_GEOM_DEDUP", "1") in ("0", ""):
        return None
    bl3 = tel.baseline_vectors_3d().astype(np.float64)
    # quantised key: identical-position pol pairs are bit-equal; the
    # nano-unit round only merges separations a fringe cannot resolve
    _, first_idx, inv = np.unique(
        np.round(bl3, 9), axis=0, return_index=True, return_inverse=True
    )
    ngeom = len(first_idx)
    if ngeom > 0.75 * nbase:
        return None
    order = np.argsort(inv, kind="stable")
    gsorted = inv[order]
    npad = _pad_to(nbase, chunk)
    nchunk = npad // chunk
    gs_pad = np.concatenate(
        [gsorted, np.full(npad - nbase, gsorted[-1], gsorted.dtype)]
    )
    g0s = np.zeros(nchunk, np.int32)
    span = 1
    for ci in range(nchunk):
        seg = gs_pad[ci * chunk : (ci + 1) * chunk]
        g0s[ci] = seg.min()
        span = max(span, int(seg.max() - seg.min()) + 1)
    Gc = _pad_to(span, 8)
    lidx = (gs_pad - np.repeat(g0s.astype(gs_pad.dtype), chunk)).astype(
        np.int32
    )
    # one-hot row selector [npad, Gc]: the product -> geometry fan-out
    # runs as a tiny-K GEMM instead of a row gather (same choice as the
    # one-hot beam selection; gather vs GEMM is open on the GPU)
    lidx_oh = np.zeros((len(lidx), Gc), np.float32)
    lidx_oh[np.arange(len(lidx)), lidx] = 1.0
    # geometry vectors: each group's FIRST member's exact f64 vector,
    # padded so every [g0, g0 + Gc) slice stays in range
    gvec = np.zeros((ngeom + Gc, 3), np.float64)
    gvec[:ngeom] = bl3[first_idx]  # first_idx is aligned with inv's ids
    inv_wl = 1.0 / np.asarray(tel.wavelengths, dtype=np.float64)
    uniform = nfreq == 1
    if nfreq > 1:
        step = (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
        fit = inv_wl[0] + step * np.arange(nfreq)
        uniform = bool(
            np.abs(inv_wl - fit).max() <= 1e-12 * np.abs(inv_wl).max()
        )
    if uniform:
        step = 0.0 if nfreq == 1 else (inv_wl[-1] - inv_wl[0]) / (nfreq - 1)
        coeff = np.stack([gvec * inv_wl[0], gvec * step])
    else:
        coeff = gvec[None] * inv_wl[:, None, None]
    ga, gb, gc = _threefloat_split(coeff)
    return order, ga, gb, gc, g0s, lidx_oh, Gc, uniform


def _fringe_trig(ba, bb, bc, va, vb, vc, c0, chunk, nfreq, uniform):
    """(cos, sin) fringe planes [nfreq, chunk, K] for one baseline chunk.

    ``ba``/``bb``/``bc`` are the :func:`_baseline_prep` coefficients;
    ``va``/``vb``/``vc`` the three-part pixel direction vectors [K, 3].
    Uniform grids rotate the base phasor by the per-step phasor per
    frequency (error ~nfreq * eps_f32, negligible for the <= O(10)
    frequencies a single program invocation batches).
    """
    G = ba.shape[0]
    # all three start indices must share a dtype (an int32 c0 — e.g. a
    # value read from a device int32 array — meets int64 literals under
    # x64 otherwise)
    c0 = jnp.asarray(c0)
    z = jnp.zeros((), c0.dtype)
    Ba = jax.lax.dynamic_slice(ba, (z, c0, z), (G, chunk, 3))
    Bb = jax.lax.dynamic_slice(bb, (z, c0, z), (G, chunk, 3))
    Bc = jax.lax.dynamic_slice(bc, (z, c0, z), (G, chunk, 3))
    if not uniform:
        t = _phase_frac3(Ba, Bb, Bc, va, vb, vc)  # [nfreq, C, K]
        return _sincos_turns(t)
    t0 = _phase_frac3(Ba[0], Bb[0], Bc[0], va, vb, vc)  # [C, K]
    c_f, s_f = _sincos_turns(t0)
    if nfreq == 1:
        return c_f[None], s_f[None]
    td = _phase_frac3(Ba[1], Bb[1], Bc[1], va, vb, vc)
    cd, sd = _sincos_turns(td)
    cs, ss = [c_f], [s_f]
    for _ in range(nfreq - 1):
        c_f, s_f = cs[-1] * cd - ss[-1] * sd, cs[-1] * sd + ss[-1] * cd
        cs.append(c_f)
        ss.append(s_f)
    return jnp.stack(cs), jnp.stack(ss)


def _beam_prep(bt, nfreq: int, npad: int, nbase: int, gather, order=None):
    """Per-frequency deduped beam products, ``gather``-ed to the layout.

    Returns (u_re, u_im, uidx_pad, uniform_real): the stacked real/imag
    products, the padded baseline -> unique-product index, and whether
    every baseline shares one real product (the identical-dish case the
    fused programs specialise).
    """
    u_res, u_ims, uidx = [], [], None
    for fi in range(nfreq):
        u_idx, bprod = bt._beam_products(fi)
        bw = gather(bprod)
        u_res.append(bw.real.astype(np.float32))
        u_ims.append(bw.imag.astype(np.float32))
        uidx = u_idx
    uidx_pad = np.zeros(npad, np.int32)
    uidx_pad[:nbase] = uidx if order is None else np.asarray(uidx)[order]
    u_re_h = np.stack(u_res)
    u_im_h = np.stack(u_ims)
    uniform_real = u_re_h.shape[1] == 1 and not u_im_h.any()
    return u_re_h, u_im_h, uidx_pad, uniform_real


def _beam_index_dev(uidx_pad, uniform_real):
    """Device beam-product selector: one-hot [npad, U] or index [npad].

    With a handful of unique products (every real instrument: one per
    beamclass pair) the per-baseline gather in the chunk loop is
    replaced by a tiny-K one-hot GEMM (gather vs GEMM is open on the
    GPU).
    DRACO_TPU_ONEHOT_BEAM=0 restores the gather.
    """
    U = int(uidx_pad.max()) + 1 if len(uidx_pad) else 1
    use_oh = (
        not uniform_real
        and U <= 32
        and os.environ.get("DRACO_TPU_ONEHOT_BEAM", "1") not in ("0", "")
    )
    if not use_oh:
        return jnp.asarray(uidx_pad)
    oh = np.zeros((len(uidx_pad), U), np.float32)
    oh[np.arange(len(uidx_pad)), uidx_pad] = 1.0
    return jnp.asarray(oh)


def _make_run(program, consts, dims, s, mmax, nfreq, npad, nbase,
              uniform_real, order=None, uniform_freq=True):
    """The shared run(sky, weight) closure over a prepared fused program.

    ``order`` carries the m-support baseline sort; user weights are
    indexed by the ORIGINAL baseline order and permuted here (the map
    output is a baseline sum, so nothing un-permutes).
    """

    def run(sky, weight=None):
        use_weight = weight is not None
        if use_weight:
            w = np.asarray(weight, dtype=np.float32)
            if order is not None:
                w = w[..., order]
            w_pad = np.zeros((mmax + 1, 2, nfreq, npad), np.float32)
            w_pad[..., :nbase] = w
            w_dev = jnp.asarray(w_pad)
        else:
            w_dev = jnp.zeros((), _F32)
        if not isinstance(sky, jax.Array):
            # keep a float64 sky intact under x64 (accuracy probes);
            # everything else runs the f32 production dtype
            sky_h = np.asarray(sky)
            if not (jax.config.jax_enable_x64 and sky_h.dtype == np.float64):
                sky_h = sky_h.astype(np.float32)
            sky = jnp.asarray(sky_h)
        kwargs = dict(
            sht_obj=s,
            dims=dims,
            use_weight=use_weight,
            uniform_real_beam=bool(uniform_real),
            uniform_freq=bool(uniform_freq),
        )
        return program(sky, *consts, w_dev, **kwargs)

    return run


@functools.partial(
    jax.jit,
    static_argnames=(
        "sht_obj", "dims", "use_weight", "uniform_real_beam", "uniform_freq"
    ),
)
def _fused_roundtrip(
    sky,
    lam,
    lam_lo,
    plan,
    lam_band,
    band_lo,
    Ecf,
    Esf,
    flat_ring,
    ring_onehot,
    va,
    vb,
    vc,
    u_re,
    u_im,
    uidx_pad,
    bla,
    blb,
    blc,
    weight,
    *,
    sht_obj,
    dims,
    use_weight,
    uniform_real_beam,
    uniform_freq,
):
    """The single-program round trip (see module docstring).

    The window is the FLAT (ragged) layout of
    :class:`~draco_tpu.ops.sht_window.WindowedSHT`: per-ring azimuth
    windows concatenated into one [Kf] pixel axis, so every GEMM and
    trig evaluation scales with the true support pixel count instead of
    the rectangular Rb x W bounding box (~1.4x fewer pixels for a
    circular beam).

    sky : [nfreq, npol, npix] real
    Ecf/Esf : [Kf, M+1] per-pixel DFT factors, quadrature weight folded
    flat_ring : [Kf] band-ring position of each window pixel
    ring_onehot : [Rb, Kf] one-hot ring membership (adjoint reduction
        as a GEMM instead of a scatter)
    u_re/u_im : [nfreq, nuniq, npol, Kf] beam products (solid angle in)
    uidx_pad : [npad] unique-product index per (padded) baseline
    bla/blb/blc : [2 or nfreq, npad, 3] three-part baseline phase
        coefficients (see _baseline_prep)
    weight : [mmax+1, 2, nfreq, npad] (ignored unless use_weight)
    uniform_real_beam : every baseline shares one real beam product —
        the dominant identical-dish case; the per-baseline gather and
        complex combine collapse to one broadcast multiply (3x less HBM
        traffic in the hot loop).
    """
    s = sht_obj
    nfreq, npol, chunk, nchunk, npairs, Kf, mmax, groups = dims
    K = npol * Kf
    scale = 1.0 / (4 * np.pi / s.npix)
    prec = _PREC_RT
    # Accumulator dtype follows the input so the program RUNS under
    # jax_enable_x64 (f64 carries through the fori_loop).  Note the
    # prepared constants (Legendre band, DFT factors, beam products,
    # three-part fringe splits) are f32, so an x64 run is f32-accurate
    # with f64 accumulation — NOT a full f64 truth engine; genuine f64
    # truth comes from the bench's full-precision CPU spine.
    rdt = jnp.zeros(0, sky.dtype).real.dtype

    # -- forward: sky -> alm -> windowed phase tensors -------------------
    # unit (freq, pol) batch dims are squeezed around the SHT: batch-1
    # batched GEMM lowerings can tile worse than the plain forms
    if nfreq * npol == 1:
        alm = s._analysis_impl(
            sky[0, 0], lam=lam, plan=plan, lam_lo=lam_lo
        )[None, None]
    else:
        alm = s._analysis_impl(
            sky, lam=lam, plan=plan, lam_lo=lam_lo
        )  # [f, p, L+1, M+1]
    Sr = jnp.einsum("fplm,lmr->fprm", alm.real, lam_band, precision=prec)
    Si = jnp.einsum("fplm,lmr->fprm", alm.imag, lam_band, precision=prec)
    if band_lo is not None:
        # two-float band tensor: the lo term restores the f32-storage
        # bits at DEFAULT precision (it contributes ~eps of the result)
        DEF = jax.lax.Precision.DEFAULT
        blo = band_lo.astype(jnp.float32)
        Sr = Sr + jnp.einsum("fplm,lmr->fprm", alm.real, blo, precision=DEF)
        Si = Si + jnp.einsum("fplm,lmr->fprm", alm.imag, blo, precision=DEF)
    # ring -> pixel gather, then the per-pixel DFT factors
    Srk = jnp.take(Sr, flat_ring, axis=2)  # [f, p, Kf, M+1]
    Sik = jnp.take(Si, flat_ring, axis=2)
    a1 = (Ecf * Srk - Esf * Sik).reshape(nfreq, K, mmax + 1)
    a2 = (Ecf * Sik + Esf * Srk).reshape(nfreq, K, mmax + 1)

    def fringe(c):
        """Windowed fringe x beam planes for baseline chunk ``c``."""
        cph, sph = _fringe_trig(
            bla, blb, blc, va, vb, vc, c * chunk, chunk, nfreq, uniform_freq
        )  # [f, C, Kf]
        if uniform_real_beam:
            # u_re[:, 0] broadcasts over the chunk: two writes total
            b = u_re[:, 0][:, None]  # [f, 1, p, Kf]
            re = (b * cph[:, :, None]).reshape(nfreq, chunk, K)
            im = (b * sph[:, :, None]).reshape(nfreq, chunk, K)
            return re, im
        cp = cph[:, :, None]
        sp = sph[:, :, None]
        if uidx_pad.ndim == 2:
            # one-hot beam selection as a tiny-K GEMM: real arrays have
            # only a handful of unique beamclass products.
            # HIGHEST keeps the selection f32-exact (1.0 x value).
            oh = jax.lax.dynamic_slice_in_dim(uidx_pad, c * chunk, chunk)
            br = jnp.einsum(
                "cu,fupk->fcpk", oh, u_re,
                precision=jax.lax.Precision.HIGHEST,
            )
            bi = jnp.einsum(
                "cu,fupk->fcpk", oh, u_im,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            idxc = jax.lax.dynamic_slice_in_dim(uidx_pad, c * chunk, chunk)
            br = u_re[:, idxc]  # [f, C, p, Kf]
            bi = u_im[:, idxc]
        re = (br * cp - bi * sp).reshape(nfreq, chunk, K)
        im = (br * sp + bi * cp).reshape(nfreq, chunk, K)
        return re, im

    def _mm(x, y):
        """[f, C, K] x [f, K, M] -> [f, C, M] batched GEMM."""
        return jnp.einsum("fck,fkm->fcm", x, y, precision=_PREC_LOOP)

    def _mmT(x, y):
        """[f, C, K] x [f, C, M] -> [f, K, M] batched GEMM."""
        return jnp.einsum("fck,fcm->fkm", x, y, precision=_PREC_LOOP)

    # The sidereal-stream round trip between simulation and mapping —
    # pack m-modes -> iFFT -> stream -> FFT -> pack — is algebraically
    # the identity whenever the stream holds >= 2*mmax + 1 samples, so
    # the fused program elides it entirely (the task chain materialises
    # the stream because it is a product; here it is internal).  That
    # collapses forward projection and adjoint into ONE chunk loop: the
    # windowed fringe x beam tensors (the HBM-heaviest intermediates,
    # cos/sin over chunk x window) are built once per chunk instead of
    # twice, and the [mmax+1, 2, nfreq, npad] m-mode tensor is never
    # materialised.
    if use_weight:
        # chunk-sliceable layout [2, f, npad, M+1], transposed once
        weight_t = weight.transpose(1, 2, 3, 0)

    # Baselines are SORTED by their m-support bound (2 pi u_perp s_max +
    # beam extent; see fused_roundtrip_fn) and chunks grouped by the
    # rounded support Mb: a short baseline's visibility carries no power
    # beyond ~2 pi |u_perp| (Bessel decay is super-exponential past the
    # edge), so its chunk's eight GEMMs contract only the first Mb
    # m-columns — typically ~40% fewer GEMM flops on a grid array at
    # float-level exactness.  ``groups`` is a static tuple of
    # (chunk_start, chunk_end, Mb).
    def make_body(Mb):
        a1b = a1[:, :, :Mb]
        a2b = a2[:, :, :Mb]
        midx = jnp.arange(Mb)

        def body(c, Y):
            Yr, Yi = Y
            re, im = fringe(c)
            # natural-layout batched GEMMs [f, C, K] x [f, K, Mb]
            G1 = _mm(re, a1b)
            G2 = _mm(im, a2b)
            G3 = _mm(re, a2b)
            G4 = _mm(im, a1b)
            vp = ((G1 - G2) + 1j * (G3 + G4)) * scale  # [f, C, Mb]
            vm = ((G1 + G2) + 1j * (G3 - G4)) * scale
            # padded baselines carry no data; m=0 has no negative mode
            valid = (
                c * chunk + jnp.arange(chunk) < npairs
            ).astype(rdt)[None, :, None]
            vp = vp * valid
            vm = vm * valid * (midx > 0)[None, None, :]
            if use_weight:
                wc = jax.lax.dynamic_slice(
                    weight_t, (0, 0, c * chunk, 0), (2, nfreq, chunk, Mb)
                )
                vp = vp * wc[0]
                vm = vm * wc[1]
            vs = vp + vm  # [f, C, Mb]
            vd = vm - vp
            Yr = Yr.at[:, :, :Mb].add(_mmT(re, vs.real) - _mmT(im, vd.imag))
            Yi = Yi.at[:, :, :Mb].add(_mmT(re, vs.imag) + _mmT(im, vd.real))
            return (Yr, Yi)

        return body

    Y = (
        jnp.zeros((nfreq, K, mmax + 1), rdt),
        jnp.zeros((nfreq, K, mmax + 1), rdt),
    )
    for c0, c1, Mb in groups:
        Y = jax.lax.fori_loop(c0, c1, make_body(Mb), Y)
    Yr, Yi = Y
    # per-pixel conjugate DFT factors, then pixel -> ring reduction as a
    # one-hot GEMM (Tr/Ti real parts of Ew * Y with Ew = Ecf - i Esf)
    Yr = Yr.reshape(nfreq, npol, Kf, mmax + 1)
    Yi = Yi.reshape(nfreq, npol, Kf, mmax + 1)
    Tr = Ecf * Yr + Esf * Yi
    Ti = Ecf * Yi - Esf * Yr
    Tr = jnp.einsum("rk,fpkm->fprm", ring_onehot, Tr, precision=prec)
    Ti = jnp.einsum("rk,fpkm->fprm", ring_onehot, Ti, precision=prec)
    ar = jnp.einsum("lmr,fprm->fplm", lam_band, Tr, precision=prec)
    ai = jnp.einsum("lmr,fprm->fplm", lam_band, Ti, precision=prec)
    if band_lo is not None:
        DEF = jax.lax.Precision.DEFAULT
        blo = band_lo.astype(jnp.float32)
        ar = ar + jnp.einsum("lmr,fprm->fplm", blo, Tr, precision=DEF)
        ai = ai + jnp.einsum("lmr,fprm->fplm", blo, Ti, precision=DEF)
    a_dirty = jax.lax.complex(ar, ai) * scale
    if nfreq * npol == 1:
        return s._synthesis_impl(
            a_dirty[0, 0], lam=lam, plan=plan, lam_lo=lam_lo
        )[None, None]
    return s._synthesis_impl(a_dirty, lam=lam, plan=plan, lam_lo=lam_lo)


@functools.partial(
    jax.jit,
    static_argnames=(
        "sht_obj", "dims", "use_weight", "uniform_real_beam", "uniform_freq"
    ),
)
def _fused_roundtrip_fullsphere(
    sky,
    lam,
    lam_lo,
    plan,
    pw,
    va,
    vb,
    vc,
    u_re,
    u_im,
    uidx_pad,
    bla,
    blb,
    blc,
    ga,
    gb,
    gc,
    g0s,
    lidx,
    weight,
    *,
    sht_obj,
    dims,
    use_weight,
    uniform_real_beam,
    uniform_freq,
):
    """Full-sphere variant of :func:`_fused_roundtrip`.

    For beams without compact support (cylinder telescopes — the
    reference's own instrument class) the projection runs through the
    factorised per-ring-section form: the sky is pre-contracted against
    the split Legendre sections once per frequency, each baseline chunk
    ring-analyses its [Re, Im] fringe x beam maps on the padded ring
    layout, and the adjoint accumulates per-section T tensors with the
    Legendre applied once after the loop.

    sky : [nfreq, npol, npix]
    pw : [nbelt, M+1] belt phase-weight (folded into S / T, the belt
        sections are analysed "raw")
    vecp : [npad_pix, 3] padded-layout pixel vectors (zero rows where
        the layout has no pixel)
    u_re/u_im : [nfreq, nuniq, npol, npad_pix] padded beam products
    """
    s = sht_obj
    nfreq, npol, chunk, nchunk, npairs, mmax, Gc = dims
    scale = 1.0 / (4 * np.pi / s.npix)
    prec = _PREC_RT
    # accumulator dtypes follow the input so the program runs under
    # x64 (f64 carries; constants stay f32 — see _fused_roundtrip)
    rdt = jnp.zeros(0, sky.dtype).real.dtype
    cdt = jnp.complex128 if rdt == jnp.float64 else jnp.complex64

    if nfreq * npol == 1:
        alm = s._analysis_impl(
            sky[0, 0], lam=lam, plan=plan, lam_lo=lam_lo
        )[None, None]
    else:
        alm = s._analysis_impl(
            sky, lam=lam, plan=plan, lam_lo=lam_lo
        )  # [f, p, L+1, M+1]

    def sky_section(lam_s, lam_s_lo=None):
        r = jnp.einsum("fplm,lmr->fpmr", alm.real, lam_s, precision=prec)
        i = jnp.einsum("fplm,lmr->fpmr", alm.imag, lam_s, precision=prec)
        if lam_s_lo is not None:
            DEF = jax.lax.Precision.DEFAULT
            lo = lam_s_lo.astype(jnp.float32)
            r = r + jnp.einsum("fplm,lmr->fpmr", alm.real, lo, precision=DEF)
            i = i + jnp.einsum("fplm,lmr->fpmr", alm.imag, lo, precision=DEF)
        return jax.lax.complex(r, i)

    lo_secs = (
        [lam_lo["belt"], *lam_lo["caps"]]
        if lam_lo is not None
        else [None] * (1 + len(lam["caps"]))
    )
    S_secs = [sky_section(lam["belt"], lo_secs[0]) * jnp.conj(pw).T] + [
        sky_section(c, lo) for c, lo in zip(lam["caps"], lo_secs[1:])
    ]

    def fringe_sections(c):
        """Ring-section coefficients of the chunk's fringe x beam pair."""
        if Gc:
            # geometry-deduped trig: evaluate only the chunk's distinct
            # geometric baselines ([Gc, K] instead of [C, K] — 3-4x
            # less trig work for dual-pol stacks), then fan rows
            # back out to products with a contiguous-row gather
            g0 = jax.lax.dynamic_index_in_dim(g0s, c, keepdims=False)
            cg, sg = _fringe_trig(
                ga, gb, gc, va, vb, vc, g0, Gc, nfreq, uniform_freq
            )  # [f, Gc, npad_pix]
            # product -> geometry fan-out as a one-hot GEMM (HIGHEST is
            # value-exact for 0/1 selectors) rather than a row gather
            oh = jax.lax.dynamic_slice_in_dim(lidx, c * chunk, chunk)
            cph = jnp.einsum(
                "cg,fgk->fck", oh, cg,
                precision=jax.lax.Precision.HIGHEST,
            )
            sph = jnp.einsum(
                "cg,fgk->fck", oh, sg,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            cph, sph = _fringe_trig(
                bla, blb, blc, va, vb, vc, c * chunk, chunk, nfreq,
                uniform_freq,
            )  # [f, C, npad_pix]
        if uniform_real_beam:
            b = u_re[:, 0][:, None]  # [f, 1, p, npad_pix]
            re = b * cph[:, :, None]
            im = b * sph[:, :, None]
        else:
            cp = cph[:, :, None]
            sp = sph[:, :, None]
            if uidx_pad.ndim == 2:
                # one-hot selection GEMM; see the windowed fringe above
                oh = jax.lax.dynamic_slice_in_dim(
                    uidx_pad, c * chunk, chunk
                )
                br = jnp.einsum(
                    "cu,fupk->fcpk", oh, u_re,
                    precision=jax.lax.Precision.HIGHEST,
                )
                bi = jnp.einsum(
                    "cu,fupk->fcpk", oh, u_im,
                    precision=jax.lax.Precision.HIGHEST,
                )
            else:
                idxc = jax.lax.dynamic_slice_in_dim(
                    uidx_pad, c * chunk, chunk
                )
                br = u_re[:, idxc]
                bi = u_im[:, idxc]
            re = br * cp - bi * sp
            im = br * sp + bi * cp
        X = jnp.stack([re, im])  # [2, f, C, p, npad_pix]
        return s._ring_analysis_parts_padded(X, raw_belt=True, plan=plan)

    sec_rings = [lam["belt"].shape[2]] + [c.shape[2] for c in lam["caps"]]

    # As in the windowed program, the sidereal-stream FFT round trip is
    # the identity, so forward and adjoint fuse into one chunk loop and
    # the per-chunk ring-analysed fringe sections (the dominant cost:
    # cos/sin + ring FFTs over chunk x padded sphere) are built once.
    if use_weight:
        weight_t = weight.transpose(1, 2, 0, 3)  # [2, f, M+1, npad]

    def body(c, T_accs):
        F_belt, group_F = fringe_sections(c)
        vp = jnp.zeros((nfreq, mmax + 1, chunk), cdt)
        vm = jnp.zeros((nfreq, mmax + 1, chunk), cdt)
        # analysis is linear: with U = sum conj(F[0]) S, V = sum conj(F[1]) S
        # the two conjugate-beam branches are U + iV and U - iV.  The
        # stacked einsum streams each section's full F2 tensor ONCE for
        # the U/V pair (these matvec-shaped contractions are bound by
        # memory traffic; the T pair below is stacked the same way).
        for F2, S in zip([F_belt, *group_F], S_secs):
            UV = jnp.einsum(
                "xfcprm,fpmr->xfmc", jnp.conj(F2), S, precision=_PREC_LOOP
            )
            vp = vp + (UV[0] + 1j * UV[1])
            vm = vm + (UV[0] - 1j * UV[1])
        # padded baselines carry no data; m=0 has no negative mode
        valid = (
            c * chunk + jnp.arange(chunk) < npairs
        ).astype(rdt)[None, None, :]
        midx = jnp.arange(mmax + 1)
        vp = vp * (scale * valid)
        vm = vm * (scale * valid) * (midx > 0)[None, :, None]
        if use_weight:
            wc = jax.lax.dynamic_slice(
                weight_t, (0, 0, 0, c * chunk), (2, nfreq, mmax + 1, chunk)
            )
            vp = vp * wc[0]
            vm = vm * wc[1]
        v_sum = (vp + vm).transpose(1, 0, 2)  # [M+1, f, C]
        v_dif = (vm - vp).transpose(1, 0, 2)
        # T += F[0] (v0 + v1) + i F[1] (v1 - v0), one F2 pass per section
        vst = jnp.stack([v_sum, 1j * v_dif])
        out = []
        for F2, T in zip([F_belt, *group_F], T_accs):
            T = T + jnp.einsum(
                "xfcprm,xmfc->fprm", F2, vst, precision=_PREC_LOOP
            )
            out.append(T)
        return out

    T0 = [
        jnp.zeros((nfreq, npol, r, mmax + 1), cdt)
        for r in sec_rings
    ]
    T_accs = jax.lax.fori_loop(0, nchunk, body, T0)
    T_accs[0] = T_accs[0] * pw

    a_dirty = jnp.zeros((nfreq, npol, s.lmax + 1, mmax + 1), cdt)
    for T, lam_s, lo_s in zip(T_accs, [lam["belt"], *lam["caps"]], lo_secs):
        ar = jnp.einsum("lmr,fprm->fplm", lam_s, T.real, precision=prec)
        ai = jnp.einsum("lmr,fprm->fplm", lam_s, T.imag, precision=prec)
        if lo_s is not None:
            DEF = jax.lax.Precision.DEFAULT
            lo = lo_s.astype(jnp.float32)
            ar = ar + jnp.einsum("lmr,fprm->fplm", lo, T.real, precision=DEF)
            ai = ai + jnp.einsum("lmr,fprm->fplm", lo, T.imag, precision=DEF)
        a_dirty = a_dirty + jax.lax.complex(ar, ai)
    a_dirty = a_dirty * scale
    if nfreq * npol == 1:
        return s._synthesis_impl(
            a_dirty[0, 0], lam=lam, plan=plan, lam_lo=lam_lo
        )[None, None]
    return s._synthesis_impl(a_dirty, lam=lam, plan=plan, lam_lo=lam_lo)


def _auto_chunk(nbase: int, nfreq: int, npol: int, per_pixel: int) -> int:
    """Baselines per chunk from an HBM budget.

    The per-chunk fringe tensors dominate the loop footprint at roughly
    ``bytes ~ 4 x fringe_factor x nfreq x chunk x npol x per_pixel``
    (re/im pairs, f32).  The budget defaults to 4 GB
    (DRACO_TPU_CHUNK_BUDGET_GB) — large chunks keep the GEMMs wide
    while leaving headroom for the accumulators and workspace.
    """
    budget = float(os.environ.get("DRACO_TPU_CHUNK_BUDGET_GB", "4")) * 2**30
    c = int(budget // max(1, 4 * 4 * nfreq * npol * per_pixel))
    c = max(64, min(c, nbase))
    return (c + 7) // 8 * 8


def _beam_m_support(bt, info, tau: float) -> int:
    """Measured azimuthal band width of the deduped beam products.

    Largest ``|m|`` at which any beam product's per-ring azimuthal
    Fourier coefficient stays above ``tau`` relative to the global peak
    coefficient, maxed over a sample of frequencies spanning the band
    (beams vary smoothly with frequency; both edges are included).
    This bounds the m-broadening the beam convolves onto each
    baseline's fringe spectrum — measuring it replaces a guessed
    constant, which under-covers azimuthally narrow beams.
    """
    tel = bt.telescope
    nfreq = tel.nfreq
    fis = sorted(set(np.linspace(0, nfreq - 1, min(nfreq, 8)).astype(int)))
    ring_specs = None
    gmax = 0.0
    for fi in fis:
        _, bprod = bt._beam_products(fi)
        flat = np.asarray(bprod).reshape(-1, bprod.shape[-1])
        off = 0
        specs = []
        for r in range(info.nring):
            n = int(info.nphi[r])
            F = np.abs(np.fft.fft(flat[:, off : off + n], axis=-1)) / n
            off += n
            specs.append(F.max(axis=0))
            gmax = max(gmax, float(F.max()))
        if ring_specs is None:
            ring_specs = specs
        else:
            ring_specs = [np.maximum(a, b) for a, b in zip(ring_specs, specs)]
    m_sup = 0
    for spec in ring_specs:
        n = spec.shape[0]
        above = spec > tau * gmax
        if above.any():
            m_abs = np.minimum(np.arange(n), n - np.arange(n))
            m_sup = max(m_sup, int(m_abs[above].max()))
    return m_sup


def fused_roundtrip_fn(bt, chunk: int | None = None):
    """Build a reusable ``run(sky, weight=None)`` closure for ``bt``.

    All geometry/beam/Legendre device tensors are prepared and
    transferred ONCE here; each ``run`` call only moves the sky (and
    optional weights).  Per-call host prep and host->device transfers
    would dominate repeated invocations otherwise.

    Compact beams run the windowed program; wide beams (cylinders) the
    full-sphere factorised one.  ``chunk=None`` sizes the baseline chunk
    automatically from the HBM budget (:func:`_auto_chunk`).
    """
    win = bt._beam_window()
    if win is None:
        return _fullsphere_roundtrip_fn(bt, chunk)
    tel = bt.telescope
    s = win.sht
    mmax = s.mmax
    npol = tel.num_pol_sky
    nfreq = tel.nfreq
    nbase = len(tel.uniquepairs)
    if chunk is None:
        chunk = _auto_chunk(nbase, nfreq, npol, win.Kf)

    # m-support bound per baseline: the visibility of baseline u carries
    # no power beyond m ~ 2 pi |u_perp| sin(theta)_max (the fringe's
    # Jacobi-Anger band edge, Bessel tail ~4 x^(1/3) wide) plus the beam
    # product's own azimuthal band width — MEASURED from the per-ring
    # spectra (_beam_m_support), not guessed, so azimuthally narrow
    # beams are covered.  Sorting baselines by the bound lets chunks of
    # short baselines truncate their GEMM m-columns (float-exact;
    # tests/test_roundtrip.py).  DRACO_TPU_MCUT_MARGIN: unset = derive
    # from the beam, >= 0 = fixed margin override, < 0 = disable.
    m_margin_env = os.environ.get("DRACO_TPU_MCUT_MARGIN")
    bl3_all = tel.baseline_vectors_3d()
    if m_margin_env is None or int(m_margin_env) >= 0:
        u_perp = np.hypot(bl3_all[:, 0], bl3_all[:, 1]) / tel.wavelengths.min()
        s_max = float(np.sin(win.sht.info.theta[win.band]).max())
        x = 2 * np.pi * u_perp * s_max
        if m_margin_env is None:
            tau = float(os.environ.get("DRACO_TPU_BT_WINDOW_TAU", "1e-6"))
            m_margin = _beam_m_support(bt, win.sht.info, tau) + np.ceil(
                4.0 * np.cbrt(np.maximum(x, 1.0))
            ).astype(int)
        else:
            m_margin = int(m_margin_env)
        m_cut = np.minimum(np.ceil(x).astype(int) + m_margin, mmax + 1)
        order = np.argsort(m_cut, kind="stable")
    else:
        m_cut = np.full(nbase, mmax + 1)
        order = None

    _, lam, lam_lo, plan = bt._streaming_ops2()
    if lam_lo is not None:
        lam_band, band_lo = win._ensure_lam_2f()
    else:
        lam_band, band_lo = win._ensure_lam(), None
    vec = healpix.pix2vec(bt.beam_nside)
    va, vb, vc = _threefloat_split(
        np.asarray(vec, dtype=np.float64)[win.flat_index]
    )

    npad, nchunk, bla, blb, blc, uniform_freq = _baseline_prep(
        tel, nfreq, nbase, chunk, order=order
    )
    u_re_h, u_im_h, uidx_pad, uniform_real = _beam_prep(
        bt, nfreq, npad, nbase, lambda bprod: bprod[..., win.flat_index],
        order=order,
    )

    # group chunks by their (128-rounded) max m-support; m_cut is an
    # INCLUSIVE max-m bound, so mb + 1 columns are required before
    # rounding (otherwise a chunk whose bound lands exactly on a
    # multiple of 128 loses its band-edge column)
    mc_sorted = m_cut if order is None else m_cut[order]
    group_list = []
    for ci in range(nchunk):
        in_chunk = mc_sorted[ci * chunk : (ci + 1) * chunk]
        mb = int(in_chunk.max()) if len(in_chunk) else 1
        mb = min(mmax + 1, (mb + 1 + 127) // 128 * 128)
        if group_list and group_list[-1][2] == mb:
            group_list[-1][1] = ci + 1
        else:
            group_list.append([ci, ci + 1, mb])
    groups = tuple(tuple(g) for g in group_list)

    consts = (
        lam,
        lam_lo,
        plan,
        lam_band,
        band_lo,
        win._Ecf,
        win._Esf,
        win.flat_ring,
        win.ring_onehot,
        jnp.asarray(va),
        jnp.asarray(vb),
        jnp.asarray(vc),
        jnp.asarray(u_re_h),
        jnp.asarray(u_im_h),
        _beam_index_dev(uidx_pad, uniform_real),
        jnp.asarray(bla),
        jnp.asarray(blb),
        jnp.asarray(blc),
    )
    dims = (nfreq, npol, chunk, nchunk, nbase, win.Kf, mmax, groups)
    return _make_run(
        _fused_roundtrip, consts, dims, s, mmax, nfreq, npad, nbase,
        uniform_real, order=order, uniform_freq=uniform_freq,
    )


def _fullsphere_roundtrip_fn(bt, chunk: int | None):
    """Prepared-run closure for the full-sphere fused program."""
    tel = bt.telescope
    s, lam, lam_lo, plan = bt._streaming_ops2()
    mmax = s.mmax
    npol = tel.num_pol_sky
    nfreq = tel.nfreq
    nbase = len(tel.uniquepairs)
    layout = s.padded_layout()
    if chunk is None:
        # the ring-analysed fringe sections cost a few padded spheres
        chunk = _auto_chunk(nbase, nfreq, npol, 3 * len(layout))
    lclip = np.clip(layout, 0, None)
    vec = healpix.pix2vec(bt.beam_nside)
    va, vb, vc = _threefloat_split(
        np.where(
            layout[:, None] >= 0, np.asarray(vec, dtype=np.float64)[lclip], 0.0
        )
    )
    pw = s.belt_phase_weight(jnp.complex64)

    geom = _geom_prep(tel, nfreq, nbase, chunk)
    order = geom[0] if geom is not None else None
    npad, nchunk, bla, blb, blc, uniform_freq = _baseline_prep(
        tel, nfreq, nbase, chunk, order=order
    )
    u_re_h, u_im_h, uidx_pad, uniform_real = _beam_prep(
        bt, nfreq, npad, nbase,
        lambda bprod: np.where(layout >= 0, bprod[..., lclip], 0.0),
        order=order,
    )
    if geom is not None:
        _, ga, gb, gc, g0s, lidx, Gc, g_uniform = geom
        assert g_uniform == uniform_freq
        geom_consts = (
            jnp.asarray(ga),
            jnp.asarray(gb),
            jnp.asarray(gc),
            jnp.asarray(g0s),
            jnp.asarray(lidx),
        )
    else:
        Gc = 0
        z3 = jnp.zeros((1, 1, 3), jnp.float32)
        zi = jnp.zeros(1, jnp.int32)
        geom_consts = (z3, z3, z3, zi, zi)

    consts = (
        lam,
        lam_lo,
        plan,
        pw,
        jnp.asarray(va),
        jnp.asarray(vb),
        jnp.asarray(vc),
        jnp.asarray(u_re_h),
        jnp.asarray(u_im_h),
        _beam_index_dev(uidx_pad, uniform_real),
        jnp.asarray(bla),
        jnp.asarray(blb),
        jnp.asarray(blc),
        *geom_consts,
    )
    dims = (nfreq, npol, chunk, nchunk, nbase, mmax, Gc)
    return _make_run(
        _fused_roundtrip_fullsphere, consts, dims, s, mmax, nfreq, npad,
        nbase, uniform_real, order=order, uniform_freq=uniform_freq,
    )


class _FreqTileBT:
    """A frequency-window view of a BeamTransfer for tiled execution.

    Shares everything frequency-independent with the parent (telescope
    geometry through a telescope proxy, beam window, streaming SHT ops,
    beam nside) and remaps the per-frequency surfaces
    (``wavelengths``/``frequencies``/``nfreq``/``_beam_products``) onto
    the ``[f0, f1)`` window.  Every tile of the same width lowers to the
    SAME fused program shape, so an N-tile sweep compiles once.
    """

    def __init__(self, bt, f0: int, f1: int):
        self._bt = bt
        self._f0, self._f1 = f0, f1
        parent_tel = bt.telescope
        outer = self

        class _TelView:
            def __getattr__(self, name):
                return getattr(parent_tel, name)

            @property
            def nfreq(self):
                return outer._f1 - outer._f0

            @property
            def wavelengths(self):
                return parent_tel.wavelengths[outer._f0 : outer._f1]

            @property
            def frequencies(self):
                return parent_tel.frequencies[outer._f0 : outer._f1]

        self.telescope = _TelView()

    @property
    def beam_nside(self):
        return self._bt.beam_nside

    def _beam_window(self):
        return self._bt._beam_window()

    def _streaming_ops(self):
        return self._bt._streaming_ops()

    def _streaming_ops2(self):
        return self._bt._streaming_ops2()

    def _beam_products(self, fi: int):
        return self._bt._beam_products(self._f0 + fi)


def fused_simulate_to_map_tiled(
    bt, sky, freq_tile: int, chunk: int | None = None, weight=None
):
    """Tile the round trip over frequency windows that fit HBM.

    Large frequency batches amortise the fringe trig but their per-chunk
    intermediates scale with nfreq and exceed single-chip HBM (nfreq=16
    at 256 feeds: 16.6 G > 15.75 G).  This runs ``freq_tile``
    frequencies at a time through ONE compiled program (all tiles share
    the shape; per-tile constants are jit arguments) and concatenates
    the maps.  ``nfreq`` must divide into whole tiles.
    """
    nfreq = bt.telescope.nfreq
    if nfreq % freq_tile:
        raise ValueError(
            f"freq_tile={freq_tile} does not divide nfreq={nfreq}"
        )
    sky = np.asarray(sky)
    outs = []
    cache = bt.__dict__.setdefault("_fused_tiles", {})
    for f0 in range(0, nfreq, freq_tile):
        key = (f0, freq_tile, chunk)
        if key not in cache:
            cache[key] = fused_roundtrip_fn(
                _FreqTileBT(bt, f0, f0 + freq_tile), chunk=chunk
            )
        w = None if weight is None else weight[:, :, f0 : f0 + freq_tile]
        outs.append(cache[key](sky[f0 : f0 + freq_tile], weight=w))
    import jax.numpy as _jnp

    return _jnp.concatenate(outs, axis=0)


def fused_simulate_to_map(bt, sky, chunk: int | None = None, weight=None):
    """Run the full simulate -> dirty-map round trip in one XLA program.

    Parameters
    ----------
    bt : BeamTransfer
        Beam-transfer manager; compact beams run the windowed program,
        wide (cylinder) beams the full-sphere factorised one.
    sky : [nfreq, npol_sky, npix]
        Input sky maps matching the telescope frequencies.
    chunk : int
        Baselines per streamed chunk.
    weight : optional [mmax+1, 2, nfreq, nbase]
        Inverse-noise weights applied to the m-modes before the adjoint
        (unit weights when omitted).

    Returns
    -------
    maps : jnp.ndarray [nfreq, npol_sky, npix]
        The dirty-map round trip of ``sky``.

    The prepared device state is cached on ``bt`` keyed by the chunk
    size AND the env knobs that parameterise the build (m-cut margin,
    HBM chunk budget, window switches) — otherwise a process flipping
    one of those mid-run (e.g. an accuracy cross-check disabling the
    m-truncation) would silently reuse the stale program.
    """
    key = (
        chunk,
        os.environ.get("DRACO_TPU_MCUT_MARGIN"),
        os.environ.get("DRACO_TPU_CHUNK_BUDGET_GB"),
        os.environ.get("DRACO_TPU_BT_WINDOW"),
        os.environ.get("DRACO_TPU_BT_WINDOW_TAU"),
        os.environ.get("DRACO_TPU_COMP_LEGENDRE"),
    )
    cache = bt.__dict__.setdefault("_fused_fns", {})
    if key not in cache:
        cache[key] = fused_roundtrip_fn(bt, chunk=chunk)
    return cache[key](sky, weight=weight)


from ..core import config as _config
from ..core.task import ContainerTask as _ContainerTask


class SimulateAndMap(_ContainerTask):
    """Pipeline task: Map in, dirty-map round trip out, fully fused.

    The one-program equivalent of chaining ``SimulateSidereal ->
    MModeTransform -> DirtyMapMaker`` (group_tasks fuses the *scheduling*
    of those; this fuses the *computation* into a single XLA executable,
    which is what production simulation sweeps should run).

    Attributes
    ----------
    baseline_chunk : int
        Baselines per streamed chunk inside the fused program.
    """

    # 0 = size the chunk automatically from the HBM budget
    baseline_chunk = _config.int_prop(0)

    def setup(self, bt):
        """Keep the beam-transfer manager."""
        from ..core import io

        self.beamtransfer = io.get_beamtransfer(bt)
        self.telescope = io.get_telescope(bt)

    def process(self, map_):
        """Round-trip ``map_`` and return the dirty Map."""
        from ..core import containers
        from ..ops import tools

        sky = np.asarray(map_.map[:])
        maps = fused_simulate_to_map(
            self.beamtransfer, sky, chunk=self.baseline_chunk or None
        )
        out = containers.Map(
            nside=healpix.nside_of(sky.shape[-1]),
            polarisation=sky.shape[1] == 4,
            freq=map_.index_map["freq"][:],
            attrs_from=map_,
        )
        out.map[:] = tools.device_to_numpy(maps)
        return out
