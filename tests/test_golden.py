"""Golden accuracy test: the f32 device pipeline matches f64 truth.

The BASELINE.json north star requires the accelerator simulate->map round
trip to match the CPU reference maps to 1e-5 relative error; here the f64
run of our own engine stands in as the reference and the f32 run (the
accelerator's precision) is validated against it end to end on the full
m-mode spine.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")


def _round_trip(sky, bl3, beam_omega, nside, lmax, fdtype, cdtype):
    import jax.numpy as jnp

    from draco_tpu.ops import healpix, mmode, sht

    s = sht.get_sht(nside, lmax)
    omega = 4 * np.pi / healpix.npix_of(nside)
    vec = healpix.pix2vec(nside)

    alm = s._analysis_impl(jnp.asarray(sky.astype(fdtype)))

    phase = 2 * jnp.pi * (
        jnp.asarray(bl3.astype(fdtype)) @ jnp.asarray(vec.astype(fdtype)).T
    )
    bmap = jnp.asarray(beam_omega.astype(fdtype))[None] * jnp.exp(
        1j * phase.astype(fdtype)
    )
    ap = s._analysis_impl(bmap)
    ac = s._analysis_impl(jnp.conj(bmap))
    bp = jnp.conj(ac) / omega
    bm = jnp.conj(ap) / omega

    vp = jnp.einsum("blm,lm->mb", bp, alm.astype(bp.dtype))
    vm = jnp.einsum("blm,lm->mb", bm, alm.astype(bm.dtype))
    vis = jnp.stack([vp, vm], 1)

    ntime = 2 * lmax + 1
    stream = mmode.mmodes_to_sidereal(vis, n=ntime, oddra=True)
    vis2 = mmode.make_marray(stream, mmax=lmax)

    a = jnp.einsum("blm,mb->lm", jnp.conj(bp), vis2[:, 0])
    a = a + jnp.einsum("blm,mb->lm", jnp.conj(bm), vis2[:, 1])
    return np.asarray(s._synthesis_impl(a.astype(cdtype)))


def test_f32_roundtrip_matches_f64_to_1e5():
    from draco_tpu.ops import healpix

    nside = 32
    lmax = 3 * nside - 1
    npix = healpix.npix_of(nside)
    rng = np.random.Generator(np.random.SFC64(1))

    base = np.stack(
        np.meshgrid(np.arange(3) * 7.0, np.arange(3) * 7.0, indexing="ij"), -1
    ).reshape(-1, 2)
    pos = base + rng.uniform(-1, 1, base.shape)
    ii, jj = np.triu_indices(9, k=0)
    bl = pos[ii] - pos[jj]

    colat = np.pi / 2 - np.radians(45.0)
    east = np.array([0.0, 1.0, 0.0])
    north = np.array([-np.cos(colat), 0.0, np.sin(colat)])
    zen = np.array([np.sin(colat), 0.0, np.cos(colat)])
    bl3 = (bl[:, :1] * east[None] + bl[:, 1:] * north[None]) / 0.6

    vec = healpix.pix2vec(nside)
    cos_sep = np.clip(vec @ zen, -1, 1)
    beam = np.exp(-(np.arccos(cos_sep) ** 2) / (2 * (0.12 / 2.355) ** 2)) * (
        cos_sep > 0
    )
    beam_omega = beam * (4 * np.pi / npix)

    sky = rng.standard_normal(npix)

    m32 = _round_trip(sky, bl3, beam_omega, nside, lmax, np.float32, jnp.complex64)
    m64 = _round_trip(sky, bl3, beam_omega, nside, lmax, np.float64, jnp.complex128)

    rel = np.abs(m32 - m64).max() / np.abs(m64).max()
    assert rel < 1e-5, f"f32/f64 round-trip relative error {rel:.2e} > 1e-5"
