"""Delay spectrum estimation tests.

Uses synthetic delay-limited spectra with known cutoffs (the reference's
mock_freq_data strategy, reference draco/util/testing.py:47) to verify the
FFT / Wiener / Gibbs / NRML estimators and the delay filters.
"""

import numpy as np

from draco_tpu.core import containers
from draco_tpu.ops import delay as dops
from draco_tpu.analysis import delay as dtasks


def mock_freq_data(freq, ntime, delaycut, nbase=1, noise=0.0, rng=None):
    """Synthetic flat-delay-spectrum data band-limited below delaycut.

    Returns (data [nbase, ntime, nfreq], weight [nbase, nfreq]).
    """
    if rng is None:
        rng = np.random.Generator(np.random.SFC64(0))
    nfreq = len(freq)
    df = freq[1] - freq[0]
    ndelay = nfreq
    delays = np.fft.fftfreq(ndelay, d=df)
    S = (np.abs(delays) < delaycut).astype(float)
    data = np.zeros((nbase, ntime, nfreq), dtype=np.complex128)
    for b in range(nbase):
        amp = (
            rng.standard_normal((ntime, ndelay))
            + 1j * rng.standard_normal((ntime, ndelay))
        ) * np.sqrt(S / 2)
        data[b] = np.fft.fft(amp, axis=-1)
    if noise:
        data += noise * (
            rng.standard_normal(data.shape) + 1j * rng.standard_normal(data.shape)
        )
    weight = np.ones((nbase, nfreq)) / max(2 * noise**2, 1e-4)
    return data, weight


def test_fourier_matrices_consistency():
    N = 16
    # c2c matrix applied to alternating-real view == numpy fft
    rng = np.random.Generator(np.random.SFC64(1))
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    F = dops.fourier_matrix_c2c(N)
    xa = dops._complex_to_alternating_real(x[np.newaxis])[0]
    ya = F @ xa
    y = ya[0::2] + 1j * ya[1::2]
    assert np.allclose(y, np.fft.fft(x))
    # r2c matrix
    xr = rng.standard_normal(N)
    Fr = dops.fourier_matrix_r2c(N)
    ya = Fr @ xr
    y = ya[0::2] + 1j * ya[1::2]
    assert np.allclose(y, np.fft.rfft(xr))
    # c2r inverts r2c
    Fc = dops.fourier_matrix_c2r(N)
    assert np.allclose(Fc @ (Fr @ xr), xr)
    # complex fourier_matrix == dft
    Fm = dops.fourier_matrix(N)
    assert np.allclose(Fm @ x, np.fft.fft(x))


def test_gibbs_recovers_delay_cut(rng):
    """The Gibbs PS should be high below the delay cut and low above."""
    freq = np.linspace(400.0, 432.0, 33)  # 33 channels -> N = 64 delays
    data, weight = mock_freq_data(freq, ntime=64, delaycut=0.3, noise=0.01)
    N = 2 * (len(freq) - 1)
    S0 = np.ones(N) * 10.0
    samples, success = dops.delay_power_spectrum_gibbs(
        data[0], N, weight[0], S0, niter=40, rng=np.random.default_rng(3)
    )
    assert success
    spec = np.median(samples[-20:], axis=0)
    delays = np.fft.fftfreq(N, d=freq[1] - freq[0])
    inband = np.abs(delays) < 0.2
    outband = np.abs(delays) > 0.45
    assert np.median(spec[inband]) > 30 * np.median(spec[outband])


def test_gibbs_batched_matches_reference_stats(rng):
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, ntime=32, delaycut=0.4, nbase=3, noise=0.01)
    N = 2 * (len(freq) - 1)
    S0 = np.ones((3, N)) * 10.0
    samples = dops.delay_power_spectrum_gibbs_batched(
        data, N, weight, S0, niter=30
    )
    assert samples.shape == (30, 3, N)
    spec = np.median(samples[-15:], axis=0)
    delays = np.fft.fftfreq(N, d=freq[1] - freq[0])
    inband = np.abs(delays) < 0.25
    outband = np.abs(delays) > 0.45
    for b in range(3):
        assert np.median(spec[b][inband]) > 20 * np.median(spec[b][outband])


def test_wiener_filter_denoises(rng):
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, ntime=16, delaycut=0.3, noise=0.05)
    N = 2 * (len(freq) - 1)
    delays = np.fft.fftfreq(N, d=freq[1] - freq[0])
    S = np.where(np.abs(delays) < 0.3, 1.0, 1e-6)
    y = dops.delay_spectrum_wiener_filter(S, data[0], N, weight[0])
    assert y.shape == (16, N)
    # power concentrates in the signal band
    p = np.abs(y) ** 2
    assert p[:, np.abs(delays) < 0.3].mean() > 10 * p[:, np.abs(delays) > 0.4].mean()


def test_maxpost_estimator(rng):
    freq = np.linspace(400.0, 416.0, 17)
    data, weight = mock_freq_data(freq, ntime=64, delaycut=0.3, noise=0.02)
    N = 2 * (len(freq) - 1)
    from draco_tpu.analysis.delayopt import delay_power_spectrum_maxpost

    samples, success = delay_power_spectrum_maxpost(
        data[0], N, weight[0], maxiter=60
    )
    spec = samples[-1]
    delays = np.fft.fftfreq(N, d=freq[1] - freq[0])
    assert np.median(spec[np.abs(delays) < 0.2]) > 10 * np.median(
        spec[np.abs(delays) > 0.45]
    )


def make_sstream(freq, ntime, delaycut, nstack=3, noise=0.01):
    data, weight = mock_freq_data(freq, ntime, delaycut, nbase=nstack, noise=noise)
    ss = containers.SiderealStream(freq=freq, input=2, ra=ntime, stack=None,
                                   prod=np.array([[0, 0], [0, 1], [1, 1]])[:nstack])
    # vis axes [freq, stack, ra]; data is [stack, ra, freq]
    ss.vis[:] = data.transpose(2, 0, 1).astype(np.complex64)
    ss.weight[:] = np.broadcast_to(
        weight.T[:, :, None], ss.weight.shape
    ).astype(np.float32)
    return ss


def test_delay_power_spectrum_gibbs_task(rng):
    freq = np.linspace(400.0, 416.0, 17)
    ss = make_sstream(freq, ntime=32, delaycut=0.3)
    task = dtasks.DelayPowerSpectrumGibbs()
    task.read_config(
        {"nsamp": 20, "sample_axis": "ra", "seed": 11, "save_spectrum_mask": True}
    )
    out = task.process(ss)
    assert isinstance(out, containers.DelaySpectrum)
    spec = np.asarray(out.spectrum[:])
    assert spec.shape[0] == 3
    delays = out.delay
    inband = np.abs(delays) < 0.2
    outband = np.abs(delays) > 0.45
    for b in range(3):
        assert np.median(spec[b][inband]) > 10 * np.median(spec[b][outband])


def test_delay_power_spectrum_gibbs_batched_task(rng):
    freq = np.linspace(400.0, 416.0, 17)
    ss = make_sstream(freq, ntime=32, delaycut=0.3)
    task = dtasks.DelayPowerSpectrumGibbsBatched()
    task.read_config({"nsamp": 20, "sample_axis": "ra", "seed": 11})
    out = task.process(ss)
    spec = np.asarray(out.spectrum[:])
    delays = out.delay
    for b in range(3):
        assert np.median(spec[b][np.abs(delays) < 0.2]) > 10 * np.median(
            spec[b][np.abs(delays) > 0.45]
        )


def test_delay_spectrum_fft_task(rng):
    freq = np.linspace(400.0, 416.0, 17)
    ss = make_sstream(freq, ntime=8, delaycut=0.3, noise=0.001)
    # the FFT estimator only supports complex-to-complex (nfreq == ndelay)
    task = dtasks.DelaySpectrumFFT()
    task.read_config({"sample_axis": "ra", "complex_timedomain": True})
    out = task.process(ss)
    assert isinstance(out, containers.DelayTransform)
    spec = np.asarray(out.spectrum[:])
    assert spec.shape[:2] == (3, 8)
    p = np.abs(spec) ** 2
    delays = out.delay
    assert p[..., np.abs(delays) < 0.25].mean() > 5 * p[
        ..., np.abs(delays) > 0.45
    ].mean()


def test_delay_filter(rng):
    """DelayFilter removes low-delay structure."""
    from draco_tpu.telescope import UnpolarisedDishArray

    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=1, spacing_ew=5.0, num_freq=2, force_lmax=8,
        force_mmax=8, auto_correlations=True,
    )
    freq = np.linspace(400.0, 432.0, 64)
    nstack = tel.npairs
    ss = containers.SiderealStream(
        freq=freq, input=2, ra=16,
        prod=np.array([[int(a), int(b)] for a, b in tel.uniquepairs]),
    )
    # Smooth (low-delay) spectrum: constant across frequency
    ss.vis[:] = np.ones(ss.vis.shape, dtype=np.complex64)
    ss.weight[:] = 1.0
    task = dtasks.DelayFilter()
    task.read_config({"delay_cut": 0.2, "za_cut": 0.0})
    task.setup(tel)
    out = task.process(ss)
    vis = np.asarray(out.vis[:])
    # constant-in-frequency signal lives at delay 0 -> removed
    assert np.abs(vis).max() < 0.05


def test_delay_spectrum_to_power_spectrum(rng):
    freq = np.linspace(400.0, 416.0, 17)
    ss = make_sstream(freq, ntime=32, delaycut=0.3)
    t1 = dtasks.DelaySpectrumFFT()
    t1.read_config({"sample_axis": "ra", "complex_timedomain": True})
    dt = t1.process(ss)
    t2 = dtasks.DelaySpectrumToPowerSpectrum()
    t2.read_config({})
    ps = t2.process(dt)
    assert isinstance(ps, containers.DelaySpectrum)
    assert np.asarray(ps.spectrum[:]).shape == (3, len(dt.delay))


def test_cross_power_spectrum(rng):
    freq = np.linspace(400.0, 408.0, 9)
    ss1 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ss2 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    task = dtasks.DelayCrossPowerSpectrumEstimator()
    task.read_config({"nsamp": 8, "sample_axis": "ra", "seed": 21})
    out = task.process(ss1, ss2)
    assert isinstance(out, containers.DelayCrossSpectrum)
    spec = np.asarray(out.spectrum[:])
    assert spec.shape[:2] == (2, 2)
    assert np.isfinite(spec).all()


def test_cross_gibbs_batched_matches_host_stats(rng):
    """The device cross chain reproduces the host estimator's statistics."""
    freq = np.linspace(400.0, 416.0, 17)
    d1, w1 = mock_freq_data(freq, ntime=32, delaycut=0.35, nbase=3, noise=0.01)
    mix = np.random.default_rng(7)
    d2 = d1 + 0.01 * (
        mix.standard_normal(d1.shape) + 1j * mix.standard_normal(d1.shape)
    )
    N = 2 * (len(freq) - 1)
    data = np.stack([d1, d2], axis=1)  # [b, nd, nsamp, F]
    Ni = np.stack([w1, w1], axis=1)
    S0 = np.broadcast_to(
        np.eye(2)[None, :, :, None] * 10.0, (3, 2, 2, N)
    ).copy()

    samples = dops.delay_spectrum_gibbs_cross_batched(
        data, N, Ni, S0, niter=30, bchunk=2
    )
    assert samples.shape == (30, 3, 2, 2, N)
    assert np.isfinite(samples).all()
    spec = np.median(samples[-15:], axis=0)

    delays = np.fft.fftfreq(N, d=freq[1] - freq[0])
    inb, outb = np.abs(delays) < 0.25, np.abs(delays) > 0.45
    for b in range(3):
        # strong in-band / out-of-band separation on the autos
        auto = spec[b, 0, 0].real
        assert np.median(auto[inb]) > 20 * np.median(auto[outb])
        # the two datasets are nearly identical: cross tracks auto
        cross = spec[b, 0, 1].real
        assert 0.9 < np.median(cross[inb]) / np.median(auto[inb]) < 1.1
        # Hermitian cross-spectrum: S_01 = conj(S_10)
        np.testing.assert_allclose(
            spec[b, 0, 1], np.conj(spec[b, 1, 0]), rtol=1e-4, atol=1e-8
        )


def test_cross_power_spectrum_batched_task(rng):
    freq = np.linspace(400.0, 408.0, 9)
    ss1 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ss2 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    task = dtasks.DelayCrossPowerSpectrumEstimatorBatched()
    task.read_config({"nsamp": 8, "sample_axis": "ra", "seed": 21})
    out = task.process(ss1, ss2)
    assert isinstance(out, containers.DelayCrossSpectrum)
    spec = np.asarray(out.spectrum[:])
    assert spec.shape[:2] == (2, 2)
    assert np.isfinite(spec).all()
    assert (spec != 0).any()
    # matches the host estimator's output statistically: both flat-ish
    # priors over the same band-limited data
    host = dtasks.DelayCrossPowerSpectrumEstimator()
    host.read_config({"nsamp": 8, "sample_axis": "ra", "seed": 21})
    ss1b = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ss2b = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ref = np.asarray(host.process(ss1b, ss2b).spectrum[:])
    r = np.median(spec[0, 0].real, axis=-1) / np.median(ref[0, 0].real, axis=-1)
    assert np.all((r > 0.2) & (r < 5.0))


def test_cross_batched_falls_back_on_nonuniform_masks(rng):
    freq = np.linspace(400.0, 408.0, 9)
    ss1 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ss2 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    # give baseline 1 its own dead channel -> non-uniform mask
    w = np.asarray(ss1.weight[:])
    w[3, 1, :] = 0.0
    ss1.weight[:] = w
    task = dtasks.DelayCrossPowerSpectrumEstimatorBatched()
    task.read_config({"nsamp": 8, "sample_axis": "ra", "seed": 21})
    out = task.process(ss1, ss2)
    spec = np.asarray(out.spectrum[:])
    assert np.isfinite(spec).all()
    # both the batched and fallback baselines produced spectra
    assert (spec[..., 0, :] != 0).any() and (spec[..., 1, :] != 0).any()


def test_cross_batched_f64_fallback_on_nan_chains(rng, monkeypatch):
    """Chains the f32 factorisation cannot handle fall back to f64.

    At cond ~ 1 + S_prior*nfreq*Ni > ~1e7 the f32 Cholesky genuinely
    breaks down (on any backend) and the device chain surfaces NaNs;
    the batched task must detect those chains and resample them with
    the host sampler rather than writing zeros.  Stub the device op to
    poison one baseline's chain deterministically.
    """
    real_op = dtasks.delay_spectrum_gibbs_cross_batched

    def poisoned(data, N, Ni, S0, **kw):
        s = real_op(data, N, Ni, S0, **kw)
        s[:, 0] = np.nan  # first batched baseline's whole chain
        return s

    monkeypatch.setattr(
        dtasks, "delay_spectrum_gibbs_cross_batched", poisoned
    )
    freq = np.linspace(400.0, 408.0, 9)
    ss1 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    ss2 = make_sstream(freq, ntime=32, delaycut=0.5, nstack=2)
    task = dtasks.DelayCrossPowerSpectrumEstimatorBatched()
    task.read_config({"nsamp": 8, "sample_axis": "ra", "seed": 21})
    out = task.process(ss1, ss2)
    spec = np.asarray(out.spectrum[:])
    assert np.isfinite(spec).all()
    # the poisoned baseline was resampled, not left zeroed
    assert (spec[0, 0, 0] != 0).any()
    assert (spec[0, 0, 1] != 0).any()


def test_cross_batched_chunks_draw_independent_randomness(rng):
    """Chunk-aligned baselines must NOT share PRNG draws.

    Reusing one key array across baseline chunks hands baseline i and
    baseline i+bchunk byte-identical w1/w2/Wishart draws — perfectly
    correlated Monte-Carlo errors that silently break cross-baseline
    averaging.  Identical data in different chunks must still yield
    distinct chains (and a non-multiple tail chunk must work).
    """
    freq = np.linspace(400.0, 408.0, 9)
    d1, w1 = mock_freq_data(freq, ntime=16, delaycut=0.4, nbase=1, noise=0.05)
    N = 2 * (len(freq) - 1)
    nbase = 3  # bchunk=2 -> chunks of 2 and 1 (tail padding exercised)
    data = np.broadcast_to(d1[0][None, None], (nbase, 1, 16, 9)).copy()
    Ni = np.broadcast_to(w1[0][None, None], (nbase, 1, 9)).copy()
    S0 = np.ones((nbase, 1, 1, N)) * 10.0

    s = dops.delay_spectrum_gibbs_cross_batched(
        data, N, Ni, S0, niter=6, bchunk=2
    )
    assert s.shape == (6, nbase, 1, 1, N)
    assert np.isfinite(s).all()
    # same data, same chunk-slot, different chunk: chains must differ
    assert not np.allclose(s[:, 0], s[:, 2])
    # and within one chunk the draws differ too
    assert not np.allclose(s[:, 0], s[:, 1])


def test_delayopt_device_matches_host(rng, monkeypatch):
    """The jitted LogLikePS core equals the scipy host path (VERDICT r3).

    value/gradient/hessian from the device program must match the host
    factorisation at f64 on the same inputs.
    """
    from draco_tpu.analysis.delayopt import GaussianProcessPrior, LogLikePS

    nchan, ndelay, nsamp = 24, 32, 6
    rows = rng.standard_normal((nsamp, nchan)) + 1j * rng.standard_normal(
        (nsamp, nchan)
    )
    MF = rng.standard_normal((nchan, ndelay)) + 1j * rng.standard_normal(
        (nchan, ndelay)
    )
    N = rng.uniform(0.5, 2.0, nchan)
    X = (rows.T @ rows.conj()) / nsamp
    logs = np.log(rng.uniform(0.5, 2.0, ndelay))

    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("DRACO_TPU_DELAYOPT_DEVICE", mode)
        f = LogLikePS(X, MF, N, nsamp)
        outs[mode] = (f.value(logs), f.gradient(logs), f.hessian(logs))

    v0, g0, h0 = outs["0"]
    v1, g1, h1 = outs["1"]
    assert np.isclose(v0, v1, rtol=1e-8)
    np.testing.assert_allclose(g0, g1, rtol=1e-7, atol=1e-9 * np.abs(g0).max())
    np.testing.assert_allclose(h0, h1, rtol=1e-6, atol=1e-8 * np.abs(h0).max())

    # the prior is host-side either way; sanity that the sum path works
    p = GaussianProcessPrior(ndelay)
    assert np.isfinite(p.value(logs))


def test_delayopt_f32_device_mode_parity():
    """Production runs with x64 OFF, so the device core factorises in
    complex64 — its value/gradient must track the host float64 path to
    f32-appropriate tolerance (round-3 advisor finding: this mode was
    untested).  Subprocess: the test session pins x64 on."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(
        """
        import os
        import numpy as np
        import jax
        jax.config.update("jax_platforms", "cpu")
        assert not jax.config.jax_enable_x64
        from draco_tpu.analysis.delayopt import LogLikePS

        rng = np.random.Generator(np.random.SFC64(11))
        nchan, ndelay, nsamp = 24, 32, 6
        rows = rng.standard_normal((nsamp, nchan)) + 1j * rng.standard_normal(
            (nsamp, nchan))
        MF = rng.standard_normal((nchan, ndelay)) + 1j * rng.standard_normal(
            (nchan, ndelay))
        N = rng.uniform(0.5, 2.0, nchan)
        X = (rows.T @ rows.conj()) / nsamp
        logs = np.log(rng.uniform(0.5, 2.0, ndelay))

        outs = {}
        for mode in ("0", "1"):
            os.environ["DRACO_TPU_DELAYOPT_DEVICE"] = mode
            f = LogLikePS(X, MF, N, nsamp)
            outs[mode] = (f.value(logs), f.gradient(logs))
        v0, g0 = outs["0"]  # host float64 scipy
        v1, g1 = outs["1"]  # device complex64
        assert np.isclose(v0, v1, rtol=2e-5), (v0, v1)
        np.testing.assert_allclose(
            g0, g1, rtol=5e-3, atol=1e-4 * np.abs(g0).max()
        )
        print("F32PARITY-OK")
        """
    )
    import os

    env = {
        k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"
    }
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "F32PARITY-OK" in r.stdout


def test_delayopt_f32_nonfinite_falls_back_to_host(monkeypatch):
    """A non-finite f32 device factorisation must fall through to the
    host float64 path (matching the reference's always-float64 scipy)
    instead of raising."""
    from draco_tpu.analysis import delayopt as dmod

    rng = np.random.Generator(np.random.SFC64(12))
    nchan, ndelay, nsamp = 12, 16, 4
    rows = rng.standard_normal((nsamp, nchan)) + 1j * rng.standard_normal(
        (nsamp, nchan)
    )
    MF = rng.standard_normal((nchan, ndelay)) + 1j * rng.standard_normal(
        (nchan, ndelay)
    )
    N = rng.uniform(0.5, 2.0, nchan)
    X = (rows.T @ rows.conj()) / nsamp
    logs = np.log(rng.uniform(0.5, 2.0, ndelay))

    monkeypatch.setenv("DRACO_TPU_DELAYOPT_DEVICE", "1")
    f = dmod.LogLikePS(X, MF, N, nsamp)
    calls = {"n": 0}

    def fake_device(x, s):
        calls["n"] += 1
        return False  # simulate non-finite f32 Cholesky

    monkeypatch.setattr(f, "_precompute_device", fake_device)
    v = f.value(logs)
    assert calls["n"] == 1
    assert np.isfinite(v)  # host f64 path produced the answer
