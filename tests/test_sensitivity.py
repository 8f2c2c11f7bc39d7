"""Tests for sensitivity, fringestop, wavelet and testing-util modules."""

import numpy as np
import pytest

from draco_tpu.analysis import fringestop, sensitivity, wavelet
from draco_tpu.core import containers
from draco_tpu.ops import wavelet as wavelet_ops
from draco_tpu.telescope import PolarisedCylinderTelescope
from draco_tpu.util import testing as testutil


@pytest.fixture()
def ptel():
    return PolarisedCylinderTelescope(
        num_cylinders=1, num_feeds=2, feed_spacing=6.0, latitude=45.0,
        freq_lower=400.0, freq_upper=420.0, num_freq=2,
        auto_correlations=True,
    )


def _unstacked_timestream(tel, ntime=4):
    nfeed = tel.nfeed
    triu = np.triu_indices(nfeed)
    nprod = len(triu[0])
    prod = np.zeros(nprod, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"], prod["input_b"] = triu

    stack = np.zeros(nprod, dtype=[("prod", int), ("conjugate", bool)])
    stack["prod"] = np.arange(nprod)

    ts = containers.TimeStream(
        freq=tel.frequencies,
        input=tel.input_index,
        prod=prod,
        stack=stack,
        time=1e9 + 10.0 * np.arange(ntime),
    )
    rev = np.zeros(nprod, dtype=[("stack", int), ("conjugate", bool)])
    rev["stack"] = np.arange(nprod)
    ts.create_reverse_map("stack", rev)
    return ts, prod


def test_compute_system_sensitivity(ptel):
    ts, prod = _unstacked_timestream(ptel)
    A = 50.0
    w0 = 4.0

    vis = np.zeros(ts.vis.shape, dtype=np.complex64)
    autos = prod["input_a"] == prod["input_b"]
    vis[:, autos, :] = A
    ts.vis[:] = vis
    ts.weight[:] = np.full(ts.weight.shape, w0, dtype=np.float32)
    ts.input_flags[:] = np.ones(ts.input_flags.shape, dtype=np.float32)

    task = sensitivity.ComputeSystemSensitivity()
    task.read_config({})
    task.setup(ptel)
    metrics = task.process(ts)

    pols = list(metrics.pol)
    assert pols == ["XX", "XY", "YY"]
    assert metrics.measured.shape == (2, 3, 4)

    meas = np.asarray(metrics.measured[:])
    radi = np.asarray(metrics.radiometer[:])
    assert (meas > 0).all() and (radi > 0).all()

    # Hand-checked radiometric value for the XX estimate:
    # 2 X autos -> 4 ordered pairs, counter=4, sum=4 A^2
    tint = 10.0
    dnu = np.median(ts.index_map["freq"]["width"]) * 1e6
    nint = dnu * tint
    expect_xx = np.sqrt(2 * 4 * A**2 / (nint * 16))
    assert np.allclose(radi[:, 0, :], expect_xx, rtol=1e-5)

    # Measured noise for XX: pscale-weighted average of 1/w0
    ipol_xx_scale = []  # 2 - auto_flag per XX baseline
    pola = np.asarray(ptel.polarisation)[prod["input_a"]]
    polb = np.asarray(ptel.polarisation)[prod["input_b"]]
    for pa, pb, a, b in zip(pola, polb, prod["input_a"], prod["input_b"]):
        if "".join(sorted(pa + pb)) == "XX":
            ipol_xx_scale.append(1.0 if a == b else 2.0)
    counter = np.sum(ipol_xx_scale)
    expect_meas = np.sqrt(2 / (w0 * counter))
    assert np.allclose(meas[:, 0, :], expect_meas, rtol=1e-5)


def test_downmix_upmix_roundtrip(ptel):
    nstack = ptel.npairs
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"] = ptel.uniquepairs[:, 0]
    prod["input_b"] = ptel.uniquepairs[:, 1]
    ss = containers.SiderealStream(
        freq=ptel.frequencies, stack=nstack, input=ptel.nfeed, prod=prod, ra=16
    )
    ss.create_index_map(
        "stack", np.zeros(nstack, dtype=[("prod", int), ("conjugate", bool)])
    )
    ss.index_map["stack"]["prod"] = np.arange(nstack)

    rng = np.random.default_rng(1)
    vis0 = (
        rng.standard_normal(ss.vis.shape) + 1j * rng.standard_normal(ss.vis.shape)
    ).astype(np.complex64)
    ss.vis[:] = vis0
    ss.weight[:] = np.ones(ss.weight.shape, dtype=np.float32)

    down = fringestop.DownMix()
    down.read_config({})
    down.setup(ptel)
    ss = down.process(ss)
    assert ss.attrs["fringestopped"]
    mixed = np.asarray(ss.vis[:])

    up = fringestop.UpMix()
    up.read_config({})
    up.setup(ptel)
    ss = up.process(ss)
    assert not ss.attrs["fringestopped"]
    assert np.allclose(np.asarray(ss.vis[:]), vis0, atol=1e-5)

    # EW baselines must actually have been rotated by the mix
    ew = (
        ptel.feedpositions[prod["input_a"], 0]
        - ptel.feedpositions[prod["input_b"], 0]
    )
    changed = ~np.isclose(mixed, vis0, atol=1e-6).all(axis=(0, 2))
    assert np.array_equal(changed, np.abs(ew) > 1e-8)


def test_downmix_removes_fringe(ptel):
    """A pure source-at-centre fringe becomes constant after down-mixing."""
    C = 299792458.0
    nstack = ptel.npairs
    prod = np.zeros(nstack, dtype=[("input_a", int), ("input_b", int)])
    prod["input_a"] = ptel.uniquepairs[:, 0]
    prod["input_b"] = ptel.uniquepairs[:, 1]
    ss = containers.SiderealStream(
        freq=ptel.frequencies, stack=nstack, input=ptel.nfeed, prod=prod, ra=32
    )
    ss.create_index_map(
        "stack", np.zeros(nstack, dtype=[("prod", int), ("conjugate", bool)])
    )
    ss.index_map["stack"]["prod"] = np.arange(nstack)

    phi = np.radians(np.asarray(ss.ra))
    ew = (
        ptel.feedpositions[prod["input_a"], 0]
        - ptel.feedpositions[prod["input_b"], 0]
    )
    cos_dec = np.cos(np.radians(ptel.latitude))
    freq = ptel.frequencies
    lam = C / (freq * 1e6)
    omega = 2 * np.pi * ew[None, :] * cos_dec / lam[:, None]
    fringe = np.exp(-1.0j * omega[:, :, None] * phi[None, None, :])
    ss.vis[:] = fringe.astype(np.complex64)
    ss.weight[:] = np.ones(ss.weight.shape, dtype=np.float32)

    task = fringestop.DownMix()
    task.read_config({})
    task.setup(ptel)
    out = task.process(ss)
    v = np.asarray(out.vis[:])
    # After down-mixing the fringe is stopped: constant in RA
    assert np.allclose(v, 1.0, atol=1e-4)


def test_cwt_localises_tone():
    """The Morlet CWT peaks at the scale matching a pure tone."""
    n = 256
    t = np.arange(n)
    f_true = 0.05  # cycles/sample
    x = np.cos(2 * np.pi * f_true * t)

    freqs = np.linspace(0.01, 0.2, 40)
    scales = wavelet_ops.frequency2scale(freqs)
    W = np.asarray(wavelet_ops.cwt_morlet(x, scales))
    power = np.mean(np.abs(W[:, n // 4 : -n // 4]) ** 2, axis=-1)
    f_peak = freqs[np.argmax(power)]
    assert abs(f_peak - f_true) < 0.01


def test_wavelet_spectrum_estimator(rng):
    nfreq, nra = 64, 16
    freq = np.linspace(400.0, 464.0, nfreq, endpoint=False)
    ss = containers.SiderealStream(freq=freq, stack=2, input=3, prod=2, ra=nra)

    # Data band-limited in delay below 0.1 us
    d, w = testutil.mock_freq_data(freq, nra, 0.08, ndata=2, noise=0.01, rng=rng)
    ss.vis[:] = np.moveaxis(d, 0, 1).astype(np.complex64)  # [freq, stack, ra]
    ss.weight[:] = np.moveaxis(
        np.broadcast_to(w[:1], d.shape), 0, 1
    ).astype(np.float32)

    # Delay spectrum estimate: flat below the cut
    delays = np.fft.fftshift(np.fft.fftfreq(nfreq, 1.0))
    dspec = containers.DelaySpectrum(baseline=2, delay=delays)
    spec = np.where(np.abs(delays) < 0.08, 1.0, 1e-8)
    dspec.spectrum[:] = np.broadcast_to(spec, (2, nfreq))

    task = wavelet.WaveletSpectrumEstimator()
    task.read_config({"average_axis": "ra", "ndelay": 16, "chunks": 2})
    out = task.process(ss, dspec)

    assert out.spectrum.shape == (2, 16, nfreq)
    ws = np.asarray(out.spectrum[:])
    assert np.isfinite(ws).all() and (ws >= 0).all()
    # Power concentrated at delays below the cut
    delay_axis = np.asarray(out.index_map["delay"])
    below = ws[:, delay_axis < 0.1].mean()
    above = ws[:, delay_axis > 0.3].mean()
    assert below > 10 * above


def test_dummy_task_and_random_freq_data():
    task = testutil.DummyTask()
    task.read_config({"total_len": 2, "tag": "abc"})
    c1 = task.process()
    assert c1.attrs["tag"] == "abc"
    task.process()
    from draco_tpu.core.task import PipelineStopIteration

    with pytest.raises(PipelineStopIteration):
        task.process()

    gen = testutil.RandomFreqData()
    gen.read_config(
        {"num_realisation": 1, "num_ra": 8, "num_base": 3, "num_freq": 32,
         "delay_cut": 0.1, "noise": 0.01, "seed": 42}
    )
    ss = gen.next()
    assert ss.vis.shape == (32, 3, 8)
    assert (np.asarray(ss.weight[:]) > 0).all()
    with pytest.raises(PipelineStopIteration):
        gen.next()
