"""Tests for mmode/tools/random ops."""

import jax
import jax.numpy as jnp
import numpy as np

from draco_tpu.ops import mmode, random as drandom, tools


# ---------------------------------------------------------------------------
# m-mode transforms
# ---------------------------------------------------------------------------


def _reference_make_marray(ts, mmax):
    """Independent numpy implementation of the packing semantics."""
    N = ts.shape[-1]
    mlim = min(N // 2, mmax)
    mlim_neg = N // 2 - 1 + N % 2 if mmax >= N // 2 else mmax
    m_fft = np.fft.fft(ts, axis=-1) / N
    m_fft = np.moveaxis(m_fft, -1, 0)
    out = np.zeros((mmax + 1, 2, *ts.shape[:-1]), dtype=complex)
    out[: mlim + 1, 0] = m_fft[: mlim + 1]
    out[1 : mlim_neg + 1, 1] = m_fft[-1 : -(mlim_neg + 1) : -1].conj()
    return out


def test_make_marray_even_odd(rng):
    for nra in [16, 17]:
        ts = rng.standard_normal((3, 5, nra)) + 1j * rng.standard_normal((3, 5, nra))
        for mmax in [nra // 2, 4]:
            ours = tools.device_to_numpy(mmode.make_marray(ts, mmax))
            ref = _reference_make_marray(ts, mmax)
            tol = 1e-8 if jax.config.jax_enable_x64 else 1e-5
            assert np.allclose(ours, ref, atol=tol * np.abs(ref).max()), (
                nra,
                mmax,
            )


def test_mmode_roundtrip_real(rng):
    """sidereal -> m-modes -> sidereal is the identity at Nyquist sampling."""
    for nra in [16, 17]:
        ts = rng.standard_normal((2, 3, nra))  # real input
        mm = mmode.make_marray(ts, mmax=nra // 2)
        back = tools.device_to_numpy(mmode.mmodes_to_sidereal(mm, n=nra))
        tol = 1e-10 if jax.config.jax_enable_x64 else 2e-6
        assert np.allclose(back.real, ts, atol=tol), nra
        assert np.allclose(back.imag, 0.0, atol=tol), nra


def test_fast_fft_size():
    assert mmode.fast_fft_size(1) == 1
    assert mmode.fast_fft_size(6) == 6
    assert mmode.fast_fft_size(7) == 8
    assert mmode.fast_fft_size(1535) == 1536  # 2*767 + 1, the benchmark's mmax
    assert mmode.fast_fft_size(2049) == 2160  # 2^4 * 3^3 * 5
    for n in [1, 13, 100, 257, 1535, 4097]:
        s = mmode.fast_fft_size(n)
        assert s >= n
        r = s
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        assert r == 1, (n, s)


def test_mmode_roundtrip_padded(rng):
    """A padded (smooth-size) sidereal axis preserves every m-mode."""
    mmax = 7
    mm = (
        rng.standard_normal((mmax + 1, 2, 3, 4))
        + 1j * rng.standard_normal((mmax + 1, 2, 3, 4))
    )
    mm[0, 1] = 0.0
    n = mmode.fast_fft_size(2 * mmax + 1)  # 15 -> 16
    ts = mmode.mmodes_to_sidereal(jnp.asarray(mm), n=n, oddra=True)
    back = np.asarray(mmode.make_marray(ts, mmax=mmax))
    assert np.allclose(back, mm, atol=1e-12)


def test_mmode_roundtrip_downsample(rng):
    """Resampling to fewer RA bins keeps the low-m content."""
    nra, n_out = 32, 16
    m_true = 3
    phi = np.linspace(0, 2 * np.pi, nra, endpoint=False)
    ts = np.cos(m_true * phi)[None]
    mm = mmode.make_marray(ts, mmax=nra // 2)
    back = np.asarray(mmode.mmodes_to_sidereal(mm, n=n_out)).real
    phi_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    assert np.allclose(back[0], np.cos(m_true * phi_out), atol=1e-10)


# ---------------------------------------------------------------------------
# tools
# ---------------------------------------------------------------------------


def test_invert_no_zero():
    x = np.array([0.0, 2.0, -4.0, 1e-320])
    out = tools.invert_no_zero(x)
    assert np.allclose(out, [0.0, 0.5, -0.25, 0.0])
    xj = jnp.asarray([0.0, 2.0])
    assert np.allclose(np.asarray(tools.invert_no_zero(xj)), [0.0, 0.5])


def test_cmap_icmap_roundtrip():
    n = 7
    for i in range(n):
        for j in range(i, n):
            p = tools.cmap(i, j, n)
            i2, j2 = tools.icmap(p, n)
            assert (i2, j2) == (i, j)


def test_apply_gain(rng):
    nfreq, ninput, ntime = 3, 4, 5
    nprod = ninput * (ninput + 1) // 2
    vis = rng.standard_normal((nfreq, nprod, ntime)) + 1j * rng.standard_normal(
        (nfreq, nprod, ntime)
    )
    gain = rng.standard_normal((nfreq, ninput, ntime)) + 1j * rng.standard_normal(
        (nfreq, ninput, ntime)
    )
    out = np.asarray(tools.apply_gain(vis, gain))
    # check a couple of entries against the definition
    pm = tools.unique_pair_indices(ninput)
    for p in [0, 3, nprod - 1]:
        ia, ib = pm[p]
        assert np.allclose(out[:, p], vis[:, p] * gain[:, ia] * gain[:, ib].conj())


def test_extract_diagonal(rng):
    ninput = 5
    nprod = ninput * (ninput + 1) // 2
    vis = rng.standard_normal((2, nprod, 3))
    diag = np.asarray(tools.extract_diagonal(vis))
    assert diag.shape == (2, ninput, 3)
    assert np.allclose(diag[:, 0], vis[:, 0])


def test_unpack_product_array(rng):
    n = 4
    nprod = n * (n + 1) // 2
    ut = rng.standard_normal(nprod) + 1j * rng.standard_normal(nprod)
    # make autos real so the unpacked matrix is exactly Hermitian
    for i in range(n):
        ut[tools.cmap(i, i, n)] = ut[tools.cmap(i, i, n)].real
    full = np.asarray(tools.unpack_product_array(ut, axis=0))
    assert full.shape == (n, n)
    # Hermitian with upper triangle matching input
    assert np.allclose(full, full.conj().T)
    for i in range(n):
        for j in range(i, n):
            assert np.isclose(full[i, j], ut[tools.cmap(i, j, n)])


def test_calculate_redundancy():
    ninput, ntime = 3, 4
    pm = tools.unique_pair_indices(ninput)  # 6 products
    flags = np.ones((ninput, ntime), dtype=np.float32)
    flags[2, 2:] = 0.0  # input 2 bad for later half
    # stack everything into 2 stacks: autos -> 0, cross -> 1
    stack_index = np.array([0, 1, 1, 0, 1, 0])
    red = np.asarray(tools.calculate_redundancy(flags, pm, stack_index, 2))
    # early times: stack0 = 3 autos, stack1 = 3 cross
    assert np.allclose(red[:, 0], [3, 3])
    # later: input 2 drops out: stack0 keeps autos (0,0),(1,1); stack1 keeps (0,1)
    assert np.allclose(red[:, 3], [2, 1])


def test_window_generalised():
    x = np.linspace(0, 1, 101)
    w = np.asarray(tools.window_generalised(x, "hann"))
    assert np.isclose(w[50], 1.0)
    assert np.isclose(w[0], 0.0, atol=1e-12)
    wt = np.asarray(tools.window_generalised(x, "tukey-0.4"))
    assert np.isclose(wt[50], 1.0)
    # outside range -> 0
    assert tools.window_generalised(np.array([-0.1, 1.1]), "hann").sum() == 0


def test_correct_phase_wrap():
    assert np.isclose(float(tools.correct_phase_wrap(np.pi + 0.1)), -np.pi + 0.1)
    assert np.isclose(float(tools.correct_phase_wrap(190.0, deg=True)), -170.0)


def test_find_contiguous_slices():
    sl = tools.find_contiguous_slices([1, 2, 3, 7, 8, 11])
    assert sl == [slice(1, 4), slice(7, 9), slice(11, 12)]


def test_sincos_turns_accuracy():
    rng = np.random.default_rng(42)
    t = rng.uniform(-0.75, 0.75, 50_000).astype(np.float32)
    # exact quadrant boundaries and zero
    edges = np.array(
        [0, 0.125, 0.25, 0.375, 0.5, -0.5, -0.25, -0.125, 0.625, -0.625],
        np.float32,
    )
    t = np.concatenate([t, edges])
    c, s = jax.jit(tools.sincos_turns)(jnp.asarray(t))
    t64 = t.astype(np.float64)
    assert np.abs(np.asarray(c, np.float64) - np.cos(2 * np.pi * t64)).max() < 5e-7
    assert np.abs(np.asarray(s, np.float64) - np.sin(2 * np.pi * t64)).max() < 5e-7
    # float64 inputs take the exact path
    c64, s64 = tools.sincos_turns(jnp.asarray(t64))
    if c64.dtype == jnp.float64:  # only when x64 is enabled
        assert np.allclose(np.asarray(c64), np.cos(2 * np.pi * t64), atol=1e-14)


def test_phase_frac3_accuracy():
    """Three-part fringe phase matches f64 to ~3e-7 turns UNDER JIT.

    phase_frac3 over threefloat_split operands is the fused-roundtrip
    fringe path; compare against exact f64 at CHIME-scale baseline
    lengths (~500 wavelengths) where a plain f32 dot loses ~2e-4 rad.
    Run jitted on the CPU backend deliberately: XLA:CPU's FMA
    contraction breaks runtime Dekker/TwoSum compensation, which this
    scheme is immune to by using only exactly-representable products.
    """
    rng = np.random.default_rng(7)
    bl = rng.uniform(-120.0, 120.0, (64, 3))
    vec = rng.normal(size=(257, 3))
    vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    wavelengths = np.array([0.21, 0.42, 0.7499])
    blw = bl[None] / wavelengths[:, None, None]  # [nf, nb, 3]
    ba, bb, bc = tools.threefloat_split(blw)
    va, vb, vc = tools.threefloat_split(vec)
    # the split reconstructs the f64 operand to f32-residual accuracy
    rec = ba.astype(np.float64) + bb.astype(np.float64) + bc.astype(np.float64)
    assert np.abs(rec - blw).max() < np.abs(blw).max() * 2e-14

    turns = jax.jit(tools.phase_frac3)(
        *map(jnp.asarray, (ba, bb, bc, va, vb, vc))
    )
    t64 = np.einsum("fbx,kx->fbk", blw, vec)
    d = np.asarray(turns, np.float64) - (t64 - np.round(t64))
    d = d - np.round(d)  # 0.5 / -0.5 are the same phase
    assert np.abs(d).max() < 1e-6


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------


def test_complex_normal_stats():
    key = jax.random.key(0)
    z = np.asarray(
        drandom.complex_normal(key, size=(200_000,), scale=2.0, dtype=jnp.complex128)
    )
    # E|z|^2 = scale^2
    assert np.isclose(np.mean(np.abs(z) ** 2), 4.0, rtol=0.02)
    assert np.isclose(np.mean(z).real, 0.0, atol=0.02)


def test_standard_wishart_mean():
    """E[W] = n * I for the standard complex Wishart."""
    key = jax.random.key(1)
    m, n = 4, 10
    W = np.asarray(
        drandom.standard_complex_wishart(
            key, m, n, batch_shape=(3000,), dtype=jnp.complex128
        )
    )
    mean = W.mean(axis=0)
    assert np.allclose(mean, n * np.eye(m), atol=0.5)
    # Hermitian positive definite
    assert np.allclose(W, np.conj(np.swapaxes(W, -1, -2)))
    evs = np.linalg.eigvalsh(W)
    assert evs.min() > 0


def test_complex_wishart_mean(rng):
    key = jax.random.key(2)
    m, n = 3, 8
    A = rng.standard_normal((m, m)) + 1j * rng.standard_normal((m, m))
    C = A @ A.conj().T + m * np.eye(m)
    W = np.asarray(
        drandom.complex_wishart(key, C, n, batch_shape=(4000,))
    )
    assert np.allclose(W.mean(axis=0) / n, C, rtol=0.15, atol=0.5)


def test_numpy_twins_match_semantics(rng):
    W = drandom.standard_complex_wishart_np(4, 9, rng=rng)
    assert np.allclose(W, W.conj().T)
    C = np.eye(3) * 2.0
    Wc = drandom.complex_wishart_np(C, 7, rng=rng)
    assert Wc.shape == (3, 3)


def test_ang2pix_exact_containment():
    """ang2pix returns pixel centres' own pixels and stays in-ring.

    Pins the exact HEALPix diamond-boundary algorithm (a nearest-centre
    approximation disagrees with healpy near cap pixel edges).
    """
    from draco_tpu.ops import healpix

    for nside in (1, 4, 32):
        theta, phi = healpix.pix2ang(nside)
        got = np.asarray(healpix.ang2pix(nside, theta, phi))
        assert (got == np.arange(healpix.npix_of(nside))).all()

    # points just either side of an equatorial-belt phi boundary land in
    # adjacent pixels (exact boundary algebra, not rounding)
    nside = 8
    info = healpix.ring_info(nside)
    r = 2 * nside  # equatorial ring
    th = info.theta[r]
    step = 2 * np.pi / info.nphi[r]
    edge = info.phi0[r] + 0.5 * step
    lo, hi = edge - 1e-9, edge + 1e-9
    p = np.asarray(healpix.ang2pix(nside, np.array([th, th]), np.array([lo, hi])))
    assert p[1] == p[0] + 1


def test_rebin_matrix_matches_scalar_loop():
    """The vectorised overlap rebinner equals a literal per-sample loop."""
    from draco_tpu.ops.regrid import rebin_matrix

    def scalar_rebin(tra, ra, width_t):
        width_t = width_t or 1e-10
        out = np.zeros((ra.shape[0], tra.shape[0]))
        inds = np.searchsorted(ra, tra)
        width_ra = np.median(np.abs(np.diff(ra)))
        lo_edge = ra[0] - width_ra / 2
        hi_edge = ra[-1] + width_ra / 2
        for ii, (jj, t) in enumerate(zip(inds, tra)):
            lower = t - width_t / 2.0
            upper = t + width_t / 2.0
            if upper > lo_edge and jj < len(ra):
                edge = ra[jj] - width_ra / 2
                out[jj, ii] = np.clip((upper - edge) / width_t, 0.0, 1.0)
            if lower < hi_edge and jj > 0:
                edge = ra[jj - 1] + width_ra / 2
                out[jj - 1, ii] = np.clip((edge - lower) / width_t, 0.0, 1.0)
        return out

    gen = np.random.Generator(np.random.SFC64(7))
    ra = np.linspace(0.0, 360.0, 32, endpoint=False)
    for width_t in (0.0, 3.0, 11.25, 30.0):
        # irregular samples spilling past both RA edges
        tra = np.sort(gen.uniform(-20.0, 380.0, size=200))
        got = rebin_matrix(tra, ra, width_t=width_t)
        want = scalar_rebin(tra, ra, width_t)
        np.testing.assert_allclose(got, want, atol=1e-12)
        # samples inside the grid conserve weight
        interior = (tra > ra[0]) & (tra < ra[-1])
        np.testing.assert_allclose(
            got[:, interior].sum(axis=0), 1.0, atol=1e-9
        )
