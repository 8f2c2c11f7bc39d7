"""Delay-spectrum estimation kernels.

Re-provides the estimator functions of reference ``draco/analysis/delay.py``
(fourier matrices :1480-1613, delay_power_spectrum_gibbs:1713,
delay_spectrum_gibbs_cross:1907, delay_spectrum_fft:2102,
delay_spectrum_wiener_filter:2132).

Device design: alongside the faithful numpy implementations, the Gibbs sampler
is provided as a fully batched jax kernel — all baselines' chains advance
in lockstep with on-device batched Cholesky solves and JAX PRNG draws
(:func:`delay_power_spectrum_gibbs_batched`), replacing the reference's
per-baseline Python loop (the SURVEY.md section 3.5 hot loop).
"""

from __future__ import annotations

import numpy as np

from . import tools

__all__ = [
    "fourier_matrix_r2c",
    "fourier_matrix_c2r",
    "fourier_matrix_c2c",
    "fourier_matrix",
    "delay_spectrum_fft",
    "delay_spectrum_wiener_filter",
    "delay_power_spectrum_gibbs",
    "delay_power_spectrum_gibbs_batched",
    "delay_spectrum_gibbs_cross",
    "delay_spectrum_gibbs_cross_batched",
    "match_axes",
    "flatten_axes",
]


# ---------------------------------------------------------------------------
# Fourier matrices (reference delay.py:1480-1613)
# ---------------------------------------------------------------------------


def _dft_angles(N: int, fsel, nchan_default: int) -> np.ndarray:
    """Phase table 2*pi*f*t/N, [nsel, N]."""
    chans = np.arange(nchan_default) if fsel is None else np.array(fsel)
    return 2 * np.pi * np.outer(chans, np.arange(N)) / N


def fourier_matrix_r2c(N: int, fsel=None) -> np.ndarray:
    """Real-to-complex FFT matrix, alternating re/im rows (delay.py:1480)."""
    arg = _dft_angles(N, fsel, N // 2 + 1)
    out = np.zeros((2 * arg.shape[0], N), dtype=np.float64)
    out[0::2] = np.cos(arg)
    out[1::2] = -np.sin(arg)
    return out


def fourier_matrix_c2r(N: int, fsel=None) -> np.ndarray:
    """Complex-to-real inverse FFT matrix (delay.py:1513)."""
    chans = np.arange(N // 2 + 1) if fsel is None else np.array(fsel)
    # DC and Nyquist rows carry no doubled conjugate partner
    scale = np.where((chans == 0) | (chans == N // 2), 1.0, 2.0) / N
    arg = _dft_angles(N, fsel, N // 2 + 1).T
    out = np.zeros((N, 2 * chans.shape[0]), dtype=np.float64)
    out[:, 0::2] = np.cos(arg) * scale
    out[:, 1::2] = -np.sin(arg) * scale
    return out


def fourier_matrix_c2c(N: int, fsel=None) -> np.ndarray:
    """Complex-to-complex FFT as a real matrix over alternating re/im.

    (delay.py:1549)
    """
    arg = _dft_angles(N, fsel, N)
    c, s = np.cos(arg), np.sin(arg)
    out = np.zeros((2 * arg.shape[0], 2 * N), dtype=np.float64)
    out[0::2, 0::2] = c
    out[0::2, 1::2] = s
    out[1::2, 0::2] = -s
    out[1::2, 1::2] = c
    return out


def fourier_matrix(N: int, fsel=None) -> np.ndarray:
    """Complex Fourier matrix exp(-2 pi i t f / N) (delay.py:1588)."""
    return np.exp(-1.0j * _dft_angles(N, fsel, N))


def _complex_to_alternating_real(array):
    return array.astype(np.complex128, order="C").view(np.float64)


def _alternating_real_to_complex(array):
    return np.ascontiguousarray(array.astype(np.float64)).view(np.complex128)


# ---------------------------------------------------------------------------
# Shared input preparation (reference delay.py:1657-1710)
# ---------------------------------------------------------------------------


def _chan_taper(fsel, total_freq, window):
    """Apodisation over the selected channels, doubled for re/im rows."""
    taper = np.asarray(
        tools.window_generalised(fsel / total_freq, window=window)
    )
    return np.repeat(taper, 2)


def _alternating_noise_inverse(Ni, fsel, N, complex_timedomain):
    """Per-alternating-row inverse noise.

    Purely-real channels (DC/Nyquist of a real transform) put all their
    information in the re row; every other channel splits across re/im
    with doubled weight.  Ni may be [nfreq] or [..., nfreq].
    """
    if complex_timedomain:
        lone_real = np.zeros(fsel.shape, dtype=bool)
    else:
        lone_real = (fsel == 0) | (fsel == N // 2)
    out = np.zeros(Ni.shape[:-1] + (2 * Ni.shape[-1],))
    out[..., 0::2] = np.where(lone_real, Ni, Ni * 2)
    out[..., 1::2] = np.where(lone_real, 0.0, Ni * 2)
    return out


def _compute_delay_spectrum_inputs(data, N, Ni, fsel, window, complex_timedomain):
    """Pre-whitened alternating-real data + noise-weighted Fourier matrices."""
    total_freq = N if complex_timedomain else N // 2 + 1
    fsel = np.arange(total_freq) if fsel is None else np.asarray(fsel)

    if complex_timedomain:
        F = fourier_matrix_c2c(N, fsel)
    else:
        F = fourier_matrix_r2c(N, fsel)
    rows = _complex_to_alternating_real(data).T.copy()

    if window is not None:
        taper = _chan_taper(fsel, total_freq, window)
        F = F * taper[:, np.newaxis]
        rows = rows * taper[:, np.newaxis]

    Ni_r = _alternating_noise_inverse(Ni, fsel, N, complex_timedomain)
    root = Ni_r**0.5
    FTNih = F.T * root[np.newaxis, :]
    return rows * root[:, np.newaxis], FTNih, FTNih @ FTNih.T, fsel


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def delay_spectrum_fft(data, N: int, window="nuttall"):
    """Delay transform by inverse FFT (reference delay.py:2102).

    One jitted program (per-op eager dispatch is slow).
    """
    import jax
    import jax.numpy as jnp

    if window is not None:
        wx = np.arange(N) / N
        w = np.asarray(tools.window_generalised(wx, window=window))
    else:
        w = np.ones(N)
    return tools.device_to_numpy(
        _delay_fft_jit()(tools.as_device(np.asarray(data)), jnp.asarray(w))
    )


def _delay_fft_jit():
    # module-level cached jit, built lazily (this module imports jax on
    # demand)
    global _DELAY_FFT_JIT
    try:
        return _DELAY_FFT_JIT
    except NameError:
        pass
    import jax
    import jax.numpy as jnp

    _DELAY_FFT_JIT = jax.jit(
        lambda d, w: jnp.fft.ifft(d * w[jnp.newaxis], axis=-1)
    )
    return _DELAY_FFT_JIT


def delay_spectrum_wiener_filter(
    delay_PS, data, N, Ni, window="nuttall", fsel=None, complex_timedomain=False
):
    """Wiener-filtered delay spectrum (reference delay.py:2132).

    See arXiv:2202.01242 Eq. A6.
    """
    import scipy.linalg as la

    data, FTNih, FTNiF, fsel = _compute_delay_spectrum_inputs(
        data, N, Ni, fsel, window, complex_timedomain
    )
    Si = np.asarray(tools.invert_no_zero(np.asarray(delay_PS)))
    if complex_timedomain:
        Si = 2.0 * np.repeat(Si, 2)
    y_spec = _solve_regularised(FTNiF, Si, FTNih @ data).T
    if complex_timedomain:
        y_spec = _alternating_real_to_complex(y_spec)
    return y_spec


def _solve_regularised(FTNiF, Si_diag, rhs):
    """cho_solve of (FTNiF + diag(Si)) x = rhs (both overwritten)."""
    import scipy.linalg as la

    system = FTNiF.copy()
    system[np.diag_indices_from(system)] += Si_diag
    factor = la.cho_factor(
        system, check_finite=False, lower=False, overwrite_a=True
    )
    return la.cho_solve(factor, rhs, check_finite=False, overwrite_b=True)


def delay_power_spectrum_gibbs(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    rng=None,
    complex_timedomain=False,
):
    """Gibbs-sample the delay power spectrum (reference delay.py:1713).

    Alternates a perturbed-Wiener signal draw (frequency- or time-basis
    form depending on dimensions, delay.py:1884-1886) with an inverse-chi^2
    power spectrum draw.  Returns (list of samples, success flag).
    """
    if rng is None:
        rng = np.random.default_rng()

    draws = []
    data, FTNih, FTNiF, fsel = _compute_delay_spectrum_inputs(
        data, N, Ni, fsel, window, complex_timedomain
    )
    ndelay_rows = 2 * N if complex_timedomain else N
    nsamp = data.shape[1]

    def _noise():
        return (
            rng.standard_normal((ndelay_rows, nsamp)),
            rng.standard_normal(data.shape),
        )

    def _signal_via_delay_basis(S):
        # "frequency" form of the perturbed-Wiener draw (delay.py:1884):
        # solve in the ndelay x ndelay system — cheap when most channels
        # are retained
        Si = np.asarray(tools.invert_no_zero(S))
        if complex_timedomain:
            Si = 2.0 * np.repeat(Si, 2)
        eps_s, eps_n = _noise()
        rhs = eps_s * (Si**0.5)[:, np.newaxis] + FTNih @ (data + eps_n)
        return _solve_regularised(FTNiF, Si, rhs)

    def _signal_via_chan_basis(S):
        # "time" form: solve in the (smaller) retained-channel system
        Sh = S**0.5
        if complex_timedomain:
            Sh = (0.5**0.5) * np.repeat(Sh, 2)
        eps_s, eps_n = _noise()
        Rt = FTNih * Sh[:, np.newaxis]
        R = Rt.T.conj()
        rhs = eps_n - R @ eps_s + data
        x = _solve_regularised(R @ Rt, np.ones(R.shape[0]), rhs)
        return Sh[:, np.newaxis] * ((Rt @ x) + eps_s)

    def _spectrum_draw(d):
        # inverse-chi^2 draw about the realised sample variance
        S_hat = d.var(axis=-1)
        if complex_timedomain:
            S_hat = S_hat[::2] + S_hat[1::2]
        return S_hat * nsamp / rng.chisquare(nsamp, size=S_hat.shape[0])

    dense = len(fsel) > 0.25 * N
    _signal_draw = _signal_via_delay_basis if dense else _signal_via_chan_basis

    S_samp = initial_S
    for _ in range(niter):
        try:
            d_samp = _signal_draw(S_samp)
        except np.linalg.LinAlgError:
            return draws, False
        S_samp = _spectrum_draw(d_samp)
        draws.append(S_samp)
    return draws, True


def _delay_inputs_batched(data, N, Ni, fsel, window, complex_timedomain):
    """Batched on-device variant of :func:`_compute_delay_spectrum_inputs`.

    The Fourier matrix and window are shared across baselines; only the
    noise weights vary, so the noise-weighted matrices build as one
    broadcast multiply plus one batched GEMM on the accelerator instead
    of a per-baseline host loop (which dominates wall-clock at
    production frequency counts).

    data : [nbase, nsample, nfreq] complex;  Ni : [nbase, nfreq]
    Returns device arrays (d [b, 2F, nsamp], FTNih [b, nd, 2F],
    FTNiF [b, nd, nd]).
    """
    import jax
    import jax.numpy as jnp

    total_freq = N if complex_timedomain else N // 2 + 1
    if fsel is None:
        fsel = np.arange(total_freq)
    else:
        fsel = np.asarray(fsel)

    F = (
        fourier_matrix_c2c(N, fsel)
        if complex_timedomain
        else fourier_matrix_r2c(N, fsel)
    )  # [2F, nd]
    w = None
    if window is not None:
        w = _chan_taper(fsel, total_freq, window)
        F = F * w[:, np.newaxis]

    # alternating-real data [b, nsamp, 2F] -> [b, 2F, nsamp]
    d_alt = _complex_to_alternating_real(
        np.ascontiguousarray(data)
    ).transpose(0, 2, 1)

    Ni_r = _alternating_noise_inverse(Ni, fsel, N, complex_timedomain)

    # dtype follows the jax x64 config (f64 under x64 for CPU
    # verification runs, f32 on accelerator defaults) — matching the
    # per-baseline host prep this replaces.  The window folds into F on
    # the host so the jitted build (module scope: one compile per shape,
    # not one per call) has a single code path.
    if w is not None:
        d_alt = d_alt * w[None, :, None]
    return _delay_build_batched(
        jnp.asarray(F),
        jnp.asarray(np.sqrt(Ni_r)),
        jnp.asarray(d_alt),
    )


def _delay_build_batched(F_dev, Nih, d_alt):
    """Noise-weighted design products for the batched Gibbs sampler.

    Jitted once at module level (lazily — this module imports without
    jax) so repeated calls reuse one executable per shape instead of
    recompiling a per-call closure.
    """
    global _delay_build_batched_jit
    try:
        build = _delay_build_batched_jit
    except NameError:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def build(F_dev, Nih, d_alt):
            FTNih = F_dev.T[None] * Nih[:, None, :]  # [b, nd, 2F]
            FTNiF = jnp.einsum(
                "bdf,bef->bde",
                FTNih,
                FTNih,
                precision=jax.lax.Precision.HIGHEST,
            )
            d = d_alt * Nih[:, :, None]
            return d, FTNih, FTNiF

        _delay_build_batched_jit = build
    return build(F_dev, Nih, d_alt)


def delay_power_spectrum_gibbs_batched(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    key=None,
    complex_timedomain=False,
):
    """Batched Gibbs sampler: every baseline's chain advances on device.

    The device replacement of the reference's per-baseline loop
    (reference delay.py:905-931): frequency-basis perturbed-Wiener draws
    with batched Cholesky solves under vmap over the baseline axis, and
    inverse-chi^2 power spectrum draws from the JAX PRNG.

    Parameters
    ----------
    data : np.ndarray[nbase, nsample, nfreq] (complex)
    N : int
        Number of delays.
    Ni : np.ndarray[nbase, nfreq]
        Inverse noise variance per baseline.
    initial_S : np.ndarray[nbase, ndelay(S)]
    window, fsel, complex_timedomain
        As in the reference estimator.
    niter : int
        Number of Gibbs iterations.
    key
        jax PRNG key.

    Returns
    -------
    samples : np.ndarray[niter, nbase, ndelay(S)]
    """
    import jax
    import jax.numpy as jnp

    if key is None:
        key = jax.random.key(0)

    d_all, FTNih_all, FTNiF_all = _delay_inputs_batched(
        data, N, Ni, fsel, window, complex_timedomain
    )

    keys = jax.random.split(key, niter)
    # The whole chain runs as ONE jitted program: an eager lax.scan
    # dispatches op by op and is many times slower.
    samples = _gibbs_scan(
        d_all, FTNih_all, FTNiF_all, jnp.asarray(initial_S), keys,
        complex_timedomain,
    )
    return np.asarray(samples)


def _gibbs_scan(d_all, FTNih_all, FTNiF_all, S0, keys, complex_timedomain):
    """Jitted Gibbs chain (module-level executable cache, one per shape)."""
    global _gibbs_scan_jit
    try:
        run = _gibbs_scan_jit
    except NameError:
        import functools

        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnums=(5,))
        def run(d_all, FTNih_all, FTNiF_all, S0, keys, complex_timedomain):
            # f32-faithful dots throughout (see _gibbs_cross_scan): the
            # default bf16 dot precision can push the high-SNR system
            # indefinite inside the blocked Cholesky.
            with jax.default_matmul_precision("highest"):
                return impl(d_all, FTNih_all, FTNiF_all, S0, keys, complex_timedomain)

        def impl(d_all, FTNih_all, FTNiF_all, S0, keys, complex_timedomain):
            nbase, nd, nsamp = FTNih_all.shape[0], FTNiF_all.shape[-1], d_all.shape[-1]

            def step(S, key_i):
                k1, k2, k3 = jax.random.split(key_i, 3)
                Si = jnp.where(S > 0, 1.0 / jnp.where(S > 0, S, 1.0), 0.0)
                if complex_timedomain:
                    Si_e = 2.0 * jnp.repeat(Si, 2, axis=-1)
                else:
                    Si_e = Si
                Ci = FTNiF_all + jax.vmap(jnp.diag)(Si_e)
                L = jnp.linalg.cholesky(Ci)
                w1 = jax.random.normal(k1, (nbase, nd, nsamp))
                w2 = jax.random.normal(k2, d_all.shape)
                y = w1 * jnp.sqrt(Si_e)[:, :, None] + FTNih_all @ (d_all + w2)
                dsamp = jax.scipy.linalg.cho_solve((L, True), y)
                S_hat = dsamp.var(axis=-1)
                if complex_timedomain:
                    S_hat = S_hat[:, ::2] + S_hat[:, 1::2]
                df = nsamp
                chi2 = 2.0 * jax.random.gamma(k3, df / 2.0, shape=S_hat.shape)
                S_new = S_hat * df / chi2
                return S_new, S_new

            _, samples = jax.lax.scan(step, S0, keys)
            return samples

        _gibbs_scan_jit = run
    return run(d_all, FTNih_all, FTNiF_all, S0, keys, bool(complex_timedomain))


def delay_spectrum_gibbs_cross_batched(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    key=None,
    bchunk=None,
):
    """Batched cross-PS Gibbs: every baseline's multi-dataset chain on device.

    The device replacement of the per-baseline host loop around
    :func:`delay_spectrum_gibbs_cross` (reference delay.py:1907-2099 loops
    baselines on the host with scipy solves): the coupled ``nd*N`` joint
    signal draw runs as a batched complex Cholesky + cho_solve over a chunk
    of baselines, and the per-delay inverse-Wishart power-spectrum draw
    uses the device Bartlett sampler (:func:`..random.complex_wishart`).

    Parameters
    ----------
    data : np.ndarray[nbase, nd, nsample, nfreq] (complex)
    N : int
        Number of delays.
    Ni : np.ndarray[nbase, nd, nfreq]
        Inverse noise variance.
    initial_S : np.ndarray[nbase, nd, nd, ndelay]
    window, fsel, niter
        As in the host estimator.
    key
        jax PRNG key.
    bchunk : int
        Baselines per device batch (bounds the [bchunk, nd*N, nd*N]
        Cholesky workspace); default min(nbase, 32).

    Returns
    -------
    samples : np.ndarray[niter, nbase, nd, nd, ndelay] (complex)

    Notes
    -----
    Chains follow the jax x64 setting (complex64 on accelerator
    defaults).  A failed (non-positive-definite) chain surfaces as NaNs
    in that baseline's samples instead of aborting every chain the way
    the host variant's LinAlgError does.

    The coupled system's condition number is ~``1 + S_prior * nfreq *
    Ni``; past ~1e7 an f32 Cholesky genuinely breaks down (on any
    backend — the spectrum exceeds f32), so extremely high-SNR chains
    need the f64 host sampler.  The task wrapper
    (:class:`draco_tpu.analysis.delay.DelayCrossPowerSpectrumEstimatorBatched`)
    detects the NaNs and falls back per baseline automatically.
    """
    import jax
    import jax.numpy as jnp

    if key is None:
        key = jax.random.key(0)

    nbase, nd, nsamp, Nf = data.shape
    if fsel is None:
        fsel = np.arange(Nf)
    else:
        fsel = np.asarray(fsel)
        if len(fsel) != Nf:
            raise ValueError(
                f"The frequency selection does not cover the data channels: "
                f"{len(fsel)} selected vs {Nf} present"
            )

    F = fourier_matrix(N, fsel)  # [F, N] complex
    d = np.asarray(data).transpose(0, 1, 3, 2)  # [b, nd, F, nsamp]
    if window is not None:
        x = fsel * 1.0 / N
        w = np.asarray(tools.window_generalised(x, window=window))
        F = F * w[:, np.newaxis]
        d = d * w[None, None, :, None]

    Nih = np.sqrt(np.asarray(Ni))  # [b, nd, F]
    FTNih = F.T[None, None] * Nih[:, :, None, :]  # [b, nd, N, F]
    d = d * Nih[:, :, :, None]

    if bchunk is None:
        bchunk = min(nbase, 32)

    # the chain carry is complex (cross terms) even for a real prior
    S_init = np.asarray(initial_S).astype(np.complex128)

    def pad(x):
        # pad the tail chunk to bchunk so every chunk reuses ONE
        # compiled executable (identity prior rows: keeps the padded
        # chains' linear algebra well-posed; their output is discarded)
        if x.shape[0] == bchunk:
            return x
        reps = [(0, bchunk - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, reps)

    outs = []
    for b0 in range(0, nbase, bchunk):
        sl = slice(b0, min(b0 + bchunk, nbase))
        n_in = sl.stop - sl.start
        Sc = pad(S_init[sl])
        if n_in < bchunk:
            # identity prior on padded rows (an all-zero S is singular)
            Sc[n_in:] = np.eye(nd)[None, :, :, None]
        # fold the chunk offset into the key: reusing one key array
        # across chunks would hand chunk-aligned baselines
        # byte-identical draws (perfectly correlated chains)
        keys = jax.random.split(jax.random.fold_in(key, b0), niter)
        # ship float pairs, combine on device
        out = np.asarray(
            _gibbs_cross_scan(
                jnp.asarray(np.ascontiguousarray(pad(d[sl]).real)),
                jnp.asarray(np.ascontiguousarray(pad(d[sl]).imag)),
                jnp.asarray(np.ascontiguousarray(pad(FTNih[sl]).real)),
                jnp.asarray(np.ascontiguousarray(pad(FTNih[sl]).imag)),
                jnp.asarray(np.ascontiguousarray(Sc.real)),
                jnp.asarray(np.ascontiguousarray(Sc.imag)),
                keys,
            )
        )
        outs.append(out[:, :n_in])
    return np.concatenate(outs, axis=1)


def _gibbs_cross_scan(d_re, d_im, F_re, F_im, S_re, S_im, keys):
    """Jitted cross-Gibbs chain (module-level executable cache per shape)."""
    global _gibbs_cross_scan_jit
    try:
        run = _gibbs_cross_scan_jit
    except NameError:
        import jax
        import jax.numpy as jnp

        from . import random as drandom

        @jax.jit
        def run(d_re, d_im, F_re, F_im, S_re, S_im, keys):
            # Every dot in the chain (including the blocked Cholesky /
            # triangular solves XLA lowers internally) must run at f32
            # fidelity: with reduced-precision (TF32 or bf16) dots the
            # ~1e-2-relative errors in the design blocks swamp the small
            # S^-1 diagonal at high SNR, the system goes indefinite and
            # the factorisation returns NaN.
            with jax.default_matmul_precision("highest"):
                return _cross_impl(d_re, d_im, F_re, F_im, S_re, S_im, keys)

        def _cross_impl(d_re, d_im, F_re, F_im, S_re, S_im, keys):
            d = jax.lax.complex(d_re, d_im)
            FTNih = jax.lax.complex(F_re, F_im)
            S0 = jax.lax.complex(S_re, S_im)
            nbase, nd, N, nsamp = (
                d.shape[0],
                d.shape[1],
                FTNih.shape[2],
                d.shape[3],
            )
            cdt = d.dtype
            ar = jnp.arange(N)

            # the noise-weighted design blocks are chain-invariant:
            # block-diagonal [nd*N, nd*N] built once outside the scan
            G = jnp.einsum("bdnf,bdmf->bdnm", FTNih, jnp.conj(FTNih))
            Ci0 = jnp.zeros((nbase, nd * N, nd * N), cdt)
            for ii in range(nd):
                Ci0 = Ci0.at[
                    :, ii * N : (ii + 1) * N, ii * N : (ii + 1) * N
                ].set(G[:, ii])

            def step(S, key_i):
                # S: [b, nd, nd, N]
                k1, k2, k3 = jax.random.split(key_i, 3)
                Smat = jnp.moveaxis(S, -1, 1)  # [b, N, nd, nd]
                Si = jnp.linalg.inv(Smat)
                L = jnp.linalg.cholesky(Smat)
                Ci = Ci0
                for ii in range(nd):
                    for jj in range(nd):
                        Ci = Ci.at[:, ii * N + ar, jj * N + ar].add(
                            Si[:, :, ii, jj]
                        )
                w1 = drandom.standard_complex_normal(
                    k1, (nbase, N, nd, nsamp), dtype=cdt
                )
                w2 = drandom.standard_complex_normal(k2, d.shape, dtype=cdt)
                y = FTNih @ (d + w2)  # [b, nd, N, ns]
                # x = L^{-H} w1 has covariance S^{-1} (perturbation term)
                w1s = jax.scipy.linalg.solve_triangular(
                    jnp.conj(jnp.swapaxes(L, -1, -2)), w1, lower=False
                )
                y = y + jnp.moveaxis(w1s, 1, 2)
                Lc = jnp.linalg.cholesky(Ci)
                dsamp = jax.scipy.linalg.cho_solve(
                    (Lc, True), y.reshape(nbase, nd * N, nsamp)
                ).reshape(nbase, nd, N, nsamp)
                # per-delay sample covariance (biased, matching np.cov
                # with bias=True in the host estimator)
                X = jnp.moveaxis(dsamp, 2, 1)  # [b, N, nd, ns]
                Xc = X - X.mean(axis=-1, keepdims=True)
                Scov = (
                    jnp.einsum("bnds,bnes->bnde", Xc, jnp.conj(Xc)) / nsamp
                )
                Wi = drandom.complex_wishart(
                    k3, jnp.linalg.inv(Scov), nsamp
                ) / nsamp
                S_new = jnp.moveaxis(jnp.linalg.inv(Wi), 1, -1)
                return S_new, S_new

            _, samples = jax.lax.scan(step, S0, keys)
            # float-pair output
            return jnp.stack([samples.real, samples.imag])

        _gibbs_cross_scan_jit = run
    out = np.asarray(run(d_re, d_im, F_re, F_im, S_re, S_im, keys))
    return out[0] + 1j * out[1]


def delay_spectrum_gibbs_cross(
    data,
    N,
    Ni,
    initial_S,
    window="nuttall",
    fsel=None,
    niter=20,
    rng=None,
):
    """Gibbs sampling of the delay *cross*-power spectrum.

    (reference delay.py:1907-2099): multi-dataset joint signal draw with a
    per-delay inverse-Wishart power spectrum draw.
    """
    import scipy.linalg as la

    from . import random as drandom

    if rng is None:
        rng = np.random.default_rng()

    nd, nsamp, nchan = data.shape
    if nd == 0:
        raise ValueError("At least one dataset is required")
    if fsel is None:
        fsel = np.arange(nchan)
    elif len(fsel) != nchan:
        raise ValueError(
            f"The frequency selection does not cover the data channels: "
            f"{len(fsel)} selected vs {data.shape[-1]} present"
        )

    F = fourier_matrix(N, fsel)
    rows = data.transpose(0, 2, 1)
    if window is not None:
        taper = np.asarray(
            tools.window_generalised(fsel * 1.0 / N, window=window)
        )
        F = F * taper[:, np.newaxis]
        rows = rows * taper[:, np.newaxis]

    # block-diagonal design products, one block per dataset
    FTNih = F.T[np.newaxis, :, :] * Ni[:, np.newaxis, :] ** 0.5
    FTNiF = np.zeros((nd, N, nd, N), dtype=np.complex128)
    for di in range(nd):
        FTNiF[di, :, di] = FTNih[di] @ FTNih[di].T.conj()
    rows = rows * Ni[:, :, np.newaxis] ** 0.5

    def _joint_signal_draw(S):
        # perturbed-Wiener draw over the coupled (dataset x delay) system
        Si = np.empty_like(S)
        Sh = np.empty((N, nd, nd), dtype=S.dtype)
        for di in range(N):
            Si[:, :, di] = la.inv(S[:, :, di])
            Sh[di] = la.cholesky(S[:, :, di], lower=False)
        coupled = FTNiF.copy()
        for a in range(nd):
            for b in range(nd):
                coupled[a, :, b] += np.diag(Si[a, b])
        eps_s = drandom.complex_normal_np(size=(N, nd, nsamp), rng=rng)
        eps_n = drandom.complex_normal_np(size=rows.shape, rng=rng)
        y = FTNih @ (rows + eps_n)
        for di in range(N):
            y[:, di] += la.solve_triangular(
                Sh[di],
                eps_s[di],
                overwrite_b=True,
                lower=False,
                check_finite=False,
            )
        factor = la.cho_factor(
            coupled.reshape(nd * N, nd * N),
            overwrite_a=True,
            check_finite=False,
        )
        flat = la.cho_solve(
            factor, y.reshape(nd * N, nsamp),
            overwrite_b=True,
            check_finite=False,
        )
        return flat.reshape(nd, N, nsamp)

    def _wishart_ps_draw(d):
        # per-delay inverse-Wishart draw about the realised covariance
        S = np.empty((nd, nd, N), dtype=np.complex128)
        for di in range(N):
            S[:, :, di] = np.cov(d[:, di], bias=True)
        for di in range(N):
            scatter = la.inv(S[:, :, di])
            draw = drandom.complex_wishart_np(scatter, nsamp, rng=rng)
            S[:, :, di] = la.inv(draw / nsamp)
        return S

    draws = []
    S_samp = initial_S
    try:
        for _ in range(niter):
            d_samp = _joint_signal_draw(S_samp)
            S_samp = _wishart_ps_draw(d_samp)
            draws.append(S_samp)
    except la.LinAlgError as e:
        raise RuntimeError("Stopping the chain early: singular system") from e
    return draws


# ---------------------------------------------------------------------------
# Array manipulation helpers (reference delay.py:2209-2324)
# ---------------------------------------------------------------------------


def match_axes(dset1, dset2):
    """View of dset2 broadcastable against dset1 (reference delay.py:2209)."""
    have = set(tuple(dset2.attrs["axis"]))
    expand = tuple(
        slice(None) if ax in have else np.newaxis
        for ax in dset1.attrs["axis"]
    )
    return np.asarray(dset2[:])[expand]


def flatten_axes(dset, axes_to_keep, match_dset=None):
    """Move named axes to the back and flatten the rest.

    (reference delay.py:2238-2302).  Returns (array, flattened axis names).
    In the mesh model the flattened axis is the natural shard axis
    (SURVEY.md section 2.5 'flatten-and-shard').
    """
    names = list(dset.attrs["axis"])
    missing = [ax for ax in axes_to_keep if ax not in names]
    if missing:
        raise ValueError(f"No axis called {missing[0]} in this dataset.")

    arr = np.asarray(dset[:])
    if match_dset is not None and tuple(names) != tuple(
        match_dset.attrs["axis"]
    ):
        # broadcast up to the reference dataset's full layout first
        full = np.empty(match_dset.shape, dtype=arr.dtype)
        full[:] = match_axes(match_dset, dset)
        arr = full
        names = list(match_dset.attrs["axis"])

    back = [names.index(ax) for ax in axes_to_keep]
    front = [i for i in range(len(names)) if i not in back]
    arr = arr.transpose(front + back)
    arr = arr.reshape((-1,) + arr.shape[len(front):])
    return arr, [names[i] for i in front]


def _move_front(arr: np.ndarray, axis, shape: tuple) -> np.ndarray:
    """Move axis (or axes) to the front and flatten to 2D (delay.py:2305)."""
    if not isinstance(axis, tuple):
        return np.moveaxis(arr, axis, 0).reshape(shape[axis], -1)
    lead = int(np.prod([shape[a] for a in axis]))
    return np.moveaxis(arr, axis, range(len(axis))).reshape(lead, -1)


def _inv_move_front(arr: np.ndarray, axis, shape: tuple) -> np.ndarray:
    """Inverse of :func:`_move_front` (delay.py:2311)."""
    if not isinstance(axis, tuple):
        interim = (shape[axis], *shape[:axis], *shape[axis + 1:])
        return np.moveaxis(arr.reshape(interim), 0, axis).reshape(shape)
    lead = tuple(shape[a] for a in axis)
    norm = {a % len(shape) for a in axis}
    rest = tuple(s for i, s in enumerate(shape) if i not in norm)
    stacked = arr.reshape((*lead, *rest))
    return np.moveaxis(stacked, range(len(axis)), axis).reshape(shape)


def _take_view(arr: np.ndarray, ind: int, axis: int) -> np.ndarray:
    sl = (slice(None),) * axis
    return arr[(*sl, ind)]
