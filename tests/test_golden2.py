"""Engine-independent golden validation above the SHT.

Two anchors the self-referential f32-vs-f64 checks cannot provide:

1. Brute-force sidereal visibilities.  An analytic band-limited sky
   (scipy spherical harmonics, no engine code) is observed by a direct
   pixel sum ``V(phi) = Omega sum_pix beam_ij(n) exp(2 pi i b.n / lambda)
   T_rot(n)`` with the sky rotated analytically in RA, and compared to
   the full SimulateSidereal task output.  A conjugation or +-m packing
   error anywhere in the SHT / beam-transfer / m-mode chain shifts or
   mirrors the transit tracks and breaks the match at O(1).

2. The m-mode packing convention against a literal numpy transcription
   of the reference's FFT packing (reference
   draco/analysis/transform.py:644-705 and :820-851), used here only as
   a test oracle.
"""

import numpy as np
import pytest
from scipy.special import sph_harm_y

import jax.numpy as jnp

from draco_tpu.ops import healpix, mmode
from draco_tpu.ops.tools import as_device, device_to_numpy


def _conv_tol():
    """Convention-oracle tolerance: f64 on CPU; f32-class on the chip
    (x64 is unavailable there, so complex128 inputs degrade to c64)."""
    import jax

    return 1e-10 if jax.config.jax_enable_x64 else 5e-6
from draco_tpu.synthesis.stream import SimulateSidereal
from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray

L_SKY = 6  # analytic sky band limit


@pytest.fixture(scope="module")
def analytic_setup(rng=None):
    rng = np.random.Generator(np.random.SFC64(99))
    nside = 32
    tel = UnpolarisedDishArray(
        grid_ew=2,
        grid_ns=2,
        spacing_ew=3.0,
        spacing_ns=3.0,
        latitude=35.0,
        freq_lower=400.0,
        freq_upper=500.0,
        num_freq=1,
        dish_width=6.0,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside).generate()

    # random band-limited real sky: c[l, m] for m >= 0
    coeff = {}
    for ell in range(L_SKY + 1):
        coeff[(ell, 0)] = rng.standard_normal()
        for m in range(1, ell + 1):
            coeff[(ell, m)] = rng.standard_normal() + 1j * rng.standard_normal()

    theta, phi = healpix.pix2ang(nside)

    def sky_at(phi_values):
        """T(theta_pix, phi_values) evaluated analytically."""
        T = np.zeros_like(phi_values, dtype=np.float64)
        for (ell, m), c in coeff.items():
            Y = sph_harm_y(ell, m, theta, phi_values)
            T += np.real(c * Y) * (1.0 if m == 0 else 2.0)
        return T

    return tel, bt, nside, sky_at


def test_brute_force_sidereal_visibilities(analytic_setup):
    tel, bt, nside, sky_at = analytic_setup
    theta, phi = healpix.pix2ang(nside)
    npix = healpix.npix_of(nside)
    omega = 4.0 * np.pi / npix

    # engine path: pixelised map through the full task spine
    from draco_tpu.core import containers

    m = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies)
    m.map[:] = sky_at(phi)[np.newaxis, np.newaxis, :]

    sim = SimulateSidereal()
    sim.read_config({})
    sim.setup(bt)
    ss = sim.process(m)
    v_eng = np.asarray(ss.vis[:])[0]  # [npairs, ntime]
    ntime = v_eng.shape[-1]

    # brute force: beam product and fringe directly from the telescope
    # model (no beam-transfer/SHT code)
    lam = tel.wavelengths[0]
    vec = healpix.pix2vec(nside)
    bl3 = tel.baseline_vectors_3d()
    pairs = tel.uniquepairs
    beams = {f: np.asarray(tel.beam(f, 0, nside)) for f in set(pairs.ravel())}
    BF = np.stack(
        [
            beams[i] * np.conj(beams[j]) * np.exp(2j * np.pi * (b @ vec.T) / lam)
            for (i, j), b in zip(pairs, bl3)
        ]
    )  # [npairs, npix]

    ra = np.radians(np.asarray(ss.ra))
    assert ra.size == ntime

    def brute(sign):
        out = np.zeros((len(pairs), ntime), dtype=np.complex128)
        for k, ra_k in enumerate(ra):
            out[:, k] = omega * (BF @ sky_at(phi - sign * ra_k))
        return out

    # the engine advances RA forward in time: the sky seen at earth
    # rotation angle ra_k is T evaluated at (theta, phi + ra_k)
    v_bf = brute(-1.0)
    scale = np.abs(v_bf).max()
    err = np.abs(v_eng - v_bf).max() / scale
    assert err < 2e-3, f"engine vs brute-force visibilities differ: {err:.2e}"

    # the opposite rotation direction must NOT match (catches a global
    # RA/conjugation flip)
    v_flip = brute(+1.0)
    assert np.abs(v_eng - v_flip).max() / scale > 0.05


# -- m-mode packing convention ---------------------------------------------


def _marray_oracle(ts, mmax):
    """Literal numpy rendition of the reference's m-mode packing
    (reference draco/analysis/transform.py:644-705); test oracle only."""
    N = ts.shape[-1]
    mlim = min(N // 2, mmax)
    mlim_neg = N // 2 - 1 + N % 2 if mmax >= N // 2 else mmax

    m_fft = np.moveaxis(np.fft.fft(ts, axis=-1), -1, 0) / N
    out = np.zeros((mmax + 1, 2, *ts.shape[:-1]), dtype=np.complex128)
    out[: mlim + 1, 0] = m_fft[: mlim + 1]
    out[1 : mlim_neg + 1, 1] = m_fft[-1 : -(mlim_neg + 1) : -1].conj()
    return out


def _unpack_oracle(mmodes, n):
    """Literal numpy rendition of reference transform.py:820-851."""
    shape = mmodes.shape[2:]
    mmax_plus = mmodes.shape[0] - 1
    if (mmodes[mmax_plus, 1].flatten() == 0).all():
        mmax_minus = mmax_plus - 1
    else:
        mmax_minus = mmax_plus
    mmax_plus = min(n // 2, mmax_plus)
    mmax_minus = min((n - 1) // 2, mmax_minus)

    marr = np.zeros((*shape, n), dtype=np.complex128)
    marr[..., 0] = mmodes[0, 0]
    for mi in range(1, mmax_minus + 1):
        marr[..., mi] = mmodes[mi, 0]
        marr[..., -mi] = mmodes[mi, 1].conj()
    if mmax_plus != mmax_minus:
        marr[..., mmax_plus] = mmodes[mmax_plus, 0]
    return marr


@pytest.mark.parametrize("ntime,mmax", [(17, 8), (16, 8), (16, 5), (33, 20)])
def test_make_marray_matches_reference_convention(ntime, mmax, rng):
    ts = rng.standard_normal((3, 4, ntime)) + 1j * rng.standard_normal(
        (3, 4, ntime)
    )
    want = _marray_oracle(ts, mmax)
    got = device_to_numpy(mmode.make_marray(as_device(ts), mmax=mmax))
    assert np.allclose(got, want, atol=_conv_tol() * np.abs(want).max())


@pytest.mark.parametrize("ntime,mmax", [(17, 8), (33, 16)])
def test_mmode_sidereal_inverse_matches_reference_convention(ntime, mmax, rng):
    vis_m = (
        rng.standard_normal((mmax + 1, 2, 3, 4))
        + 1j * rng.standard_normal((mmax + 1, 2, 3, 4))
    ).astype(np.complex128)
    want = np.fft.ifft(_unpack_oracle(vis_m, ntime), axis=-1) * ntime
    got = device_to_numpy(
        mmode.mmodes_to_sidereal(
            as_device(vis_m), n=ntime, oddra=bool(ntime % 2)
        )
    )
    assert np.allclose(got, want, atol=_conv_tol() * np.abs(want).max())


# -- polarised brute force ---------------------------------------------------


def test_brute_force_polarised_visibilities():
    """Engine (T, Q, U, V) projection vs a direct coherency-matrix sum.

    The brute force builds the visibility of every unique pair from the
    dual-pol beams and the Stokes fields directly — no beam-transfer,
    SHT or m-mode code — pinning the polarised beam-product convention
    (B_T, B_Q, B_U, B_V ordering and signs) and the per-component
    scalar transforms end-to-end.
    """
    from draco_tpu.core import containers
    from draco_tpu.telescope import PolarisedDishArray

    rng = np.random.Generator(np.random.SFC64(7))
    nside = 16
    L_pol = 4
    tel = PolarisedDishArray(
        grid_ew=2,
        grid_ns=1,
        spacing_ew=3.0,
        latitude=35.0,
        freq_lower=400.0,
        freq_upper=400.0,
        num_freq=1,
        dish_width=6.0,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside).generate()

    theta, phi = healpix.pix2ang(nside)

    # four independent band-limited scalar fields (T, Q, U, V)
    coeffs = []
    for _ in range(4):
        c = {}
        for ell in range(L_pol + 1):
            c[(ell, 0)] = rng.standard_normal()
            for m in range(1, ell + 1):
                c[(ell, m)] = rng.standard_normal() + 1j * rng.standard_normal()
        coeffs.append(c)

    def field_at(ci, phi_values):
        T = np.zeros_like(phi_values, dtype=np.float64)
        for (ell, m), c in coeffs[ci].items():
            Y = sph_harm_y(ell, m, theta, phi_values)
            T += np.real(c * Y) * (1.0 if m == 0 else 2.0)
        return T

    m = containers.Map(nside=nside, polarisation=True, freq=tel.frequencies)
    marr = np.stack([field_at(ci, phi) for ci in range(4)])
    m.map[:] = marr[np.newaxis]

    sim = SimulateSidereal()
    sim.read_config({})
    sim.setup(bt)
    ss = sim.process(m)
    v_eng = np.asarray(ss.vis[:])[0]  # [npairs, ntime]
    ntime = v_eng.shape[-1]
    ra = np.radians(np.asarray(ss.ra))

    # brute force from the dual-pol beams (coherency -> Stokes weights)
    npix = healpix.npix_of(nside)
    omega = 4.0 * np.pi / npix
    lam = tel.wavelengths[0]
    vec = healpix.pix2vec(nside)
    bl3 = tel.baseline_vectors_3d()
    pairs = tel.uniquepairs
    beams = {f: np.asarray(tel.beam(f, 0, nside)) for f in set(pairs.ravel())}

    B_planes = []
    for (i, j), b in zip(pairs, bl3):
        Et_i, Ep_i = beams[i][:, 0], beams[i][:, 1]
        Et_j, Ep_j = beams[j][:, 0], beams[j][:, 1]
        tt = Et_i * np.conj(Et_j)
        pp = Ep_i * np.conj(Ep_j)
        tp = Et_i * np.conj(Ep_j)
        pt = Ep_i * np.conj(Et_j)
        fringe = np.exp(2j * np.pi * (b @ vec.T) / lam)
        B_planes.append(
            np.stack(
                [
                    0.5 * (tt + pp),
                    0.5 * (tt - pp),
                    0.5 * (tp + pt),
                    0.5j * (tp - pt),
                ]
            )
            * fringe
        )
    B_planes = np.stack(B_planes)  # [npairs, 4, npix]

    v_bf = np.zeros((len(pairs), ntime), dtype=np.complex128)
    for k, ra_k in enumerate(ra):
        sky_k = np.stack([field_at(ci, phi + ra_k) for ci in range(4)])
        v_bf[:, k] = omega * np.einsum("bcp,cp->b", B_planes, sky_k)

    scale = np.abs(v_bf).max()
    err = np.abs(v_eng - v_bf).max() / scale
    assert err < 2e-3, f"polarised engine vs brute force differ: {err:.2e}"
