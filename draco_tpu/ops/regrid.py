"""Regridding of irregular time axes: Lanczos / banded-Wiener filters.

Re-provides reference ``draco/util/regrid.py`` (band_wiener:14,
lanczos_kernel:91, lanczos_forward_matrix:108, lanczos_inverse_matrix:138,
rebin_matrix:161, grad_1d:214, taylor_coeff:273) with the banded-Wiener hot
path running as batched device kernels on the scan-based banded Cholesky in
:mod:`draco_tpu.ops.banded` instead of Cython + LAPACK.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import banded

__all__ = [
    "band_wiener",
    "lanczos_kernel",
    "lanczos_forward_matrix",
    "lanczos_inverse_matrix",
    "rebin_matrix",
    "grad_1d",
    "taylor_coeff",
]


def band_wiener(R, Ni, Si, y, bw: int):
    """Banded Wiener filter: solve (R N^-1 R^T + S^-1) x = R N^-1 y.

    Semantics match reference regrid.band_wiener (regrid.py:14-88):
    the returned noise weight is diag(R N^-1 R^T) *without* the signal
    contribution.  Batched over the leading axis of ``Ni``/``y`` as one
    device computation.

    Parameters
    ----------
    R : [m, n] transfer matrix (regular grid m, samples n)
    Ni : [k, n] inverse noise (diagonal)
    Si : [m] inverse signal variance (diagonal)
    y : [k, n] data
    bw : bandwidth of the output covariance

    Returns
    -------
    xh : [k, m] filtered data
    nw : [k, m] inverse-variance estimate per output point
    """
    import jax

    R = jnp.asarray(R)
    if jnp.iscomplexobj(R):
        # the banded covariance below is built WITHOUT conjugation
        # (C = R Ni R^T, the reference's real-R formula); factoring that
        # under the Hermitian banded Cholesky would be silently wrong
        raise TypeError(
            "band_wiener requires a real transfer matrix R (the "
            "reference's Lanczos/rebin operators are real)."
        )
    Ni = jnp.atleast_2d(jnp.asarray(Ni))
    y = jnp.atleast_2d(jnp.asarray(y))
    Si = jnp.asarray(Si)

    # Dirty estimate
    yN = y * Ni
    xh_dirty = yN @ R.T  # [k, m]

    # Banded covariance per batch element: vmap the build over k
    def one(Ni_k, d_k):
        ab = banded.banded_covariance(R, Ni_k, bw)  # [bw+1, m]
        nw = ab[0]
        abS = ab.at[0].add(Si)
        xh = banded.solveh_banded_lower(abS, d_k, bw)
        return xh, nw

    xh, nw = jax.vmap(one)(Ni, xh_dirty)
    return xh, nw


def lanczos_kernel(x, a: int):
    """Lanczos kernel (regrid.py:91)."""
    x = np.asarray(x)
    inside = np.abs(x) < a
    return np.where(inside, np.sinc(x) * np.sinc(x / a), 0.0)


def lanczos_forward_matrix(x, y, a: int = 5, periodic: bool = False):
    """Lanczos interpolation matrix from grid ``x`` onto points ``y``.

    (regrid.py:108) — returns [len(y), len(x)].
    """
    x = np.asarray(x)
    y = np.asarray(y)
    step = x[1] - x[0]
    offsets = np.subtract.outer(-y, -x) / step
    if periodic:
        n = len(x)
        far = np.abs(offsets) > n // 2
        offsets = np.where(far, n - np.abs(offsets), offsets)
    return lanczos_kernel(offsets, a)


def lanczos_inverse_matrix(x, y, a: int = 5, cond: float = 1e-1):
    """Pseudo-inverse Lanczos regridding matrix (regrid.py:138)."""
    lz = lanczos_forward_matrix(x, y, a)
    return np.linalg.pinv(lz, rcond=cond)


def rebin_matrix(tra: np.ndarray, ra: np.ndarray, width_t: float = 0.0) -> np.ndarray:
    """Linear rebinning matrix from time samples onto RA bins.

    (regrid.py:161) — fractional overlap of each time sample with the two
    neighbouring RA bins.
    """
    tra = np.asarray(tra)
    ra = np.asarray(ra)
    width_t = width_t or 1e-10
    half_t = width_t / 2.0
    half_ra = np.median(np.abs(np.diff(ra))) / 2.0

    # vectorised fractional-overlap assignment of each time sample onto
    # the bin at/after it and the bin before it
    above = np.searchsorted(ra, tra)
    below = above - 1
    out = np.zeros((ra.shape[0], tra.shape[0]))

    cols = np.arange(tra.shape[0])
    up_ok = (above < len(ra)) & (tra + half_t > ra[0] - half_ra)
    frac_up = np.clip(
        (tra + half_t - (ra[above % len(ra)] - half_ra)) / width_t, 0.0, 1.0
    )
    out[above[up_ok], cols[up_ok]] = frac_up[up_ok]

    dn_ok = (below >= 0) & (tra - half_t < ra[-1] + half_ra)
    frac_dn = np.clip(
        ((ra[below] + half_ra) - (tra - half_t)) / width_t, 0.0, 1.0
    )
    out[below[dn_ok], cols[dn_ok]] = frac_dn[dn_ok]
    return out


def grad_1d(x, si, mask, period: float | None = None):
    """Gradient of masked samples; masked/edge points return zero.

    Periodic inputs are handled by wrapping one sample from each end
    before differencing.  The returned mask additionally covers every
    point adjacent to a masked one (their central differences are
    contaminated).  Semantics of reference regrid.py:214-270.
    """

    x = np.asarray(x)
    si = np.asarray(si)
    bad = np.asarray(mask).astype(bool)
    view = slice(None)
    if period is not None:
        wrap = np.ceil(si[-1] / period) * period
        x = np.concatenate(([x[-1]], x, [x[0]]))
        si = np.concatenate(([si[-1] - wrap], si, [si[0] + wrap]))
        bad = np.concatenate(([bad[-1]], bad, [bad[0]]))
        view = slice(1, -1)

    # a masked neighbour poisons the central difference on either side
    left = np.zeros_like(bad)
    left[1:] = bad[:-1]
    right = np.zeros_like(bad)
    right[:-1] = bad[1:]
    bad = bad | left | right

    with np.errstate(divide="ignore", invalid="ignore"):
        slope = np.gradient(x, si)
    bad |= ~np.isfinite(slope)
    slope = np.where(bad, 0.0, slope)
    return slope[view], bad[view]


def taylor_coeff(
    x: np.ndarray,
    N: int,
    M: int,
    Ni: np.ndarray,
    Si: float,
    period: float | None = None,
    xc: np.ndarray | None = None,
):
    """Sparse local Taylor-expansion estimator matrices.

    For every location, a regularised weighted least-squares fit of an
    order-``M`` Taylor expansion to the ``2N+1`` nearest samples; the
    returned list holds one sparse CSR operator per expansion
    coefficient.  Role of reference regrid.py:273-350, with two
    DELIBERATE fixes over the reference: periodic offsets wrap into
    [-period/2, period/2) before the Vandermonde fit (the reference
    feeds ~±period offsets through stencils crossing the wrap), and the
    non-periodic branch honours ``xc`` (the reference's re-centering is
    dead code there).

    Parameters
    ----------
    x : sample locations [nx]
    N : half-width of the fit stencil
    M : number of expansion coefficients
    Ni : per-sample inverse noise [nx]
    Si : ridge regularisation added to the normal matrix diagonal
    period : optional wrap period for circular axes
    xc : optional expansion centres (defaults to the samples)
    """
    import scipy.sparse as ss

    x = np.asarray(x)
    weights = np.asarray(Ni)
    nx = x.shape[0]
    centres = x if xc is None else np.asarray(xc)

    stencil = np.arange(-N, N + 1)
    neighbour = np.arange(nx)[:, None] + stencil[None, :]

    if period is not None:
        neighbour %= nx
        offsets = x[neighbour] - centres[:, None]
        offsets = (offsets + period / 2) % period - period / 2
        w = weights[neighbour]
    else:
        oob = (neighbour < 0) | (neighbour >= nx)
        neighbour = np.clip(neighbour, 0, nx - 1)
        offsets = x[neighbour] - centres[:, None]
        w = np.where(oob, 0.0, weights[neighbour])

    # weighted normal equations per location, solved batched
    V = offsets[..., None] ** np.arange(M)  # [nx, 2N+1, M] Vandermonde
    VtW = np.swapaxes(V * w[..., None], 1, 2)  # [nx, M, 2N+1]
    normal = VtW @ V + Si * np.eye(M)
    coeff_w = np.linalg.solve(normal, VtW)  # [nx, M, 2N+1]

    row_starts = (2 * N + 1) * np.arange(nx + 1)
    return [
        ss.csr_array(
            (coeff_w[:, m].ravel(), neighbour.ravel(), row_starts),
            shape=(nx, nx),
        )
        for m in range(M)
    ]
