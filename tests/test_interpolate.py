"""DPSS inpainting tests: basis properties, gap recovery, task end-to-end."""

import numpy as np
import pytest

from draco_tpu.analysis import interpolate
from draco_tpu.core import containers
from draco_tpu.ops import dpss


def _bandlimited_signal(rng, n, halfwidth, nsrc=6):
    """Random signal whose spectrum lives inside |tau| < halfwidth."""
    t = np.arange(n, dtype=np.float64)
    x = np.zeros(n)
    for _ in range(nsrc):
        f = rng.uniform(-0.8 * halfwidth, 0.8 * halfwidth)
        x += rng.standard_normal() * np.cos(2 * np.pi * f * t)
        x += rng.standard_normal() * np.sin(2 * np.pi * f * t)
    return x


def test_make_covariance_real_and_complex():
    s = np.arange(16.0)
    c = dpss.make_covariance(s, [0.1], [0.0])
    assert not np.iscomplexobj(c)
    assert np.allclose(np.diag(c), 1.0)
    c2 = dpss.make_covariance(s, [0.1], [0.05])
    assert np.iscomplexobj(c2)
    # Hermitian
    assert np.allclose(c2, c2.conj().T)

    with pytest.raises(ValueError):
        dpss.make_covariance(s, [0.1, 0.2], [0.0])


def test_get_basis_orthonormal():
    s = np.arange(64.0)
    cov = dpss.make_covariance(s, 0.05, 0.0)
    A = dpss.get_basis(cov, dtype=np.float64)
    # 2NW theorem: roughly 2 * n * hw significant modes
    assert 4 <= A.shape[1] <= 16
    assert np.allclose(A.T @ A, np.eye(A.shape[1]), atol=1e-10)


def test_inpaint_recovers_gap(rng):
    n, hw = 128, 0.04
    x = _bandlimited_signal(rng, n, hw)
    Ni = np.ones(n)
    W = np.ones(n, dtype=bool)
    # A moderate interior gap
    W[50:58] = False
    Ni[~W] = 0.0

    cov = dpss.make_covariance(np.arange(n), hw * 1.5, 0.0)
    A = dpss.get_basis(cov, dtype=np.float64)

    xi, wi = dpss.inpaint_batched(x[None], Ni[None], A, W[None])
    xi = np.asarray(xi)[0]
    wi = np.asarray(wi)[0]

    # Unflagged samples are untouched (compared at the working dtype:
    # chip-smoke mode runs without x64, so xi is f32 of the f64 input)
    assert np.array_equal(xi[W], x[W].astype(xi.dtype))
    err = np.abs(xi[~W] - x[~W])
    assert err.max() < 0.05 * np.abs(x).max()
    # Inpainted weights are finite and positive in the gap
    assert (wi[~W] > 0).all() and np.isfinite(wi).all()


def test_inpaint_complex_data(rng):
    n, hw = 96, 0.05
    x = _bandlimited_signal(rng, n, hw) + 1j * _bandlimited_signal(rng, n, hw)
    Ni = np.ones(n)
    W = np.ones(n, dtype=bool)
    W[30:35] = False
    Ni[~W] = 0.0

    A = dpss.get_basis(dpss.make_covariance(np.arange(n), hw * 1.5, 0.0), dtype=np.float64)
    xi, _ = dpss.inpaint_batched(x[None], Ni[None], A, W[None])
    from draco_tpu.ops.tools import device_to_numpy

    xi = device_to_numpy(xi)[0]
    assert np.abs(xi[~W] - x[~W]).max() < 0.05 * np.abs(x).max()


def test_solve_zero_row_stays_zero():
    n = 32
    A = dpss.get_basis(dpss.make_covariance(np.arange(n), 0.1, 0.0))
    xf, wf = dpss.solve_batched(np.ones((2, n)), np.zeros((2, n)), A)
    assert np.all(np.asarray(xf) == 0)
    assert np.all(np.asarray(wf) == 0)


def test_flag_above_cutoff():
    W = np.ones((1, 20), dtype=bool)
    W[0, 5:8] = False  # width-3 run -> dist 2
    W[0, 12:13] = False  # width-1 run -> dist 0
    m = dpss.flag_above_cutoff(W, fc=2.0)
    # Wide gap flagged, narrow gap kept
    assert not m[0, 5:8].any()
    assert m[0, 12]
    assert m[0, :5].all() and m[0, 13:].all()

    # Edges beyond the first/last valid sample are always flagged
    W2 = np.ones((1, 10), dtype=bool)
    W2[0, :3] = False
    W2[0, -2:] = False
    m2 = dpss.flag_above_cutoff(W2, fc=100.0)
    assert not m2[0, :3].any() and not m2[0, -2:].any()
    assert m2[0, 3:-2].all()

    # fc=None passthrough
    assert dpss.flag_above_cutoff(W, None) is W


def test_accumulate_variance_interpolates():
    n = 16
    wo = np.full((1, n), 4.0)  # variance 0.25 everywhere
    W = np.ones((1, n), dtype=bool)
    W[0, 6:9] = False
    wo[0, 6:9] = 0.0
    wi = np.full((1, n), 10.0)  # inpainted variance 0.1
    wacc = dpss.accumulate_variance(wo, wi, W)
    # In the gap: v = 0.1 + interpolated 0.25 -> w = 1/0.35
    assert np.allclose(wacc[0, 6:9], 1 / 0.35, rtol=1e-6)


@pytest.fixture()
def gap_stream(rng):
    """A sidereal stream with band-limited spectra and some flagged channels."""
    nfreq, nstack, nra = 64, 3, 4
    freq = np.linspace(400.0, 464.0, nfreq, endpoint=False)
    ss = containers.SiderealStream(
        freq=freq, stack=nstack, input=4, prod=nstack, ra=nra
    )
    hw = 0.08  # per-MHz units: delay cut 0.08 us
    vis = np.zeros((nfreq, nstack, nra), dtype=np.complex64)
    for i in range(nstack):
        for j in range(nra):
            vis[:, i, j] = _bandlimited_signal(
                rng, nfreq, hw
            ) + 1j * _bandlimited_signal(rng, nfreq, hw)
    ss.vis[:] = vis
    w = np.ones((nfreq, nstack, nra), dtype=np.float32)
    w[20:24] = 0.0
    ss.weight[:] = w
    return ss, vis, hw


def test_dpss_filter_task(gap_stream):
    ss, vis, hw = gap_stream
    task = interpolate.DPSSFilter()
    task.read_config(
        {"axis": "freq", "centres": [0.0], "halfwidths": [1.5 * hw]}
    )
    task.setup()
    out = task.process(ss)

    v = np.asarray(out.vis[:])
    w = np.asarray(out.weight[:])
    # Valid samples unchanged
    assert np.allclose(v[:20], vis[:20]) and np.allclose(v[24:], vis[24:])
    # Gap recovered
    err = np.abs(v[20:24] - vis[20:24])
    assert err.max() < 0.1 * np.abs(vis).max()
    assert (w[20:24] > 0).all()


def test_dpss_filter_mask_container(gap_stream):
    ss, vis, hw = gap_stream
    # Mask container selects a DIFFERENT gap than the weights
    mask = containers.SiderealRFIMask(axes_from=ss)
    marr = np.zeros(mask.mask.shape, dtype=bool)
    marr[40:42] = True
    mask.mask[:] = marr

    task = interpolate.DPSSFilter()
    task.read_config(
        {"axis": "freq", "centres": [0.0], "halfwidths": [1.5 * hw]}
    )
    task.setup(mask)
    out = task.process(ss)
    v = np.asarray(out.vis[:])
    err = np.abs(v[40:42] - vis[40:42])
    assert err.max() < 0.15 * np.abs(vis).max()


def test_dpss_filter_delay_stokesi(gap_stream):
    from draco_tpu.telescope import UnpolarisedDishArray

    ss, vis, hw = gap_stream
    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0, latitude=45.0,
        freq_lower=400.0, freq_upper=464.0, num_freq=4,
    )
    # Make a fake 'stack' index map of baseline vectors for StokesI selection
    task = interpolate.DPSSFilterDelayStokesI()
    task.read_config(
        {"centres": [0.0], "halfwidths": [hw], "telescope_orientation": "none"}
    )
    task.setup(tel)

    # Patch the stack index map with baseline coordinates
    bl = np.zeros(3, dtype=[("ew", np.float64), ("ns", np.float64)])
    bl["ew"] = [0.0, 6.0, 12.0]

    class _SS:
        pass

    # Use the real container but override .stack access via the mixin path
    cuts_holder = {}

    orig_set = interpolate.StokesIMixin._set_sel

    def fake_set(self, data):
        self._baselines = np.stack([bl["ew"], bl["ns"]], axis=-1)
        cuts_holder["b"] = self._baselines

    interpolate.StokesIMixin._set_sel = fake_set
    try:
        out = task.process(ss)
    finally:
        interpolate.StokesIMixin._set_sel = orig_set

    v = np.asarray(out.vis[:])
    # Short baselines get the minimum (configured) cut; recovery still works
    err = np.abs(v[20:24] - vis[20:24])
    assert err.max() < 0.2 * np.abs(vis).max()
