"""Banded Wiener regridding against a dense numpy / scipy reference."""

import numpy as np
import pytest
import scipy.linalg

from draco_tpu.ops import banded, regrid


def _problem(kw, batch, m, n, seed):
    """Lanczos transfer matrix R [m, n] from an irregular n-sample axis."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, n))
    grid = np.linspace(times[0], times[-1], m)
    R = regrid.lanczos_forward_matrix(grid, times, kw).T
    Ni = rng.uniform(0.5, 2.0, (batch, n))
    y = rng.standard_normal((batch, n))
    Si = np.full(m, 1e-2)
    return R, Ni, Si, y


@pytest.mark.parametrize(
    "kw, batch, m, n",
    [(2, 1, 20, 37), (3, 4, 33, 64), (5, 3, 50, 41)],
)
def test_band_wiener_matches_dense_reference(kw, batch, m, n):
    """band_wiener == per-row dense covariance + scipy's banded solve.

    The Lanczos operator of width ``kw`` makes R N^-1 R^T exactly
    banded with bandwidth 2 kw - 1 (the regridder's own choice), so the
    band storage drops nothing.
    """
    bw = 2 * kw - 1
    R, Ni, Si, y = _problem(kw, batch, m, n, seed=kw)
    xh, nw = regrid.band_wiener(R, Ni, Si, y, bw)
    xh, nw = np.asarray(xh), np.asarray(nw)
    assert xh.shape == nw.shape == (batch, m)
    for k in range(batch):
        C = (R * Ni[k]) @ R.T
        i, j = np.indices(C.shape)
        assert np.abs(C[np.abs(i - j) > bw]).max(initial=0.0) == 0.0
        ab = np.zeros((bw + 1, m))
        for d in range(bw + 1):
            ab[d, : m - d] = np.diagonal(C, -d)
        ab[0] += Si
        want = scipy.linalg.solveh_banded(ab, R @ (Ni[k] * y[k]), lower=True)
        np.testing.assert_allclose(xh[k], want, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(nw[k], np.diag(C), rtol=1e-10)


def test_banded_covariance_matches_dense():
    R, Ni, _, _ = _problem(3, 1, 30, 55, seed=7)
    bw = 5
    ab = np.asarray(banded.banded_covariance(R, Ni[0], bw))
    C = (R * Ni[0]) @ R.T
    for d in range(bw + 1):
        np.testing.assert_allclose(ab[d, : 30 - d], np.diagonal(C, -d),
                                   rtol=1e-10, atol=1e-14)
        assert not ab[d, 30 - d :].any()


def test_band_wiener_rejects_complex_transfer():
    R, Ni, Si, y = _problem(2, 1, 10, 17, seed=1)
    with pytest.raises(TypeError, match="real transfer matrix"):
        regrid.band_wiener(R.astype(complex), Ni, Si, y, 3)
