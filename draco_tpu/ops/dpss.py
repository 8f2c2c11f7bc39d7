"""DPSS (Slepian-sequence) inpainting primitives.

Re-provides reference ``draco/util/dpss.py`` capabilities (make_covariance:9,
get_basis:67, project:121, solve:154, accumulate_variance:254,
flag_above_cutoff:307, filter:359, inpaint:407), redesigned for the device:

* The reference iterates rows in Python, Cholesky-solving one covariance at
  a time on the host (dpss.py:206-246).  Here the whole batch is one jitted
  ``vmap`` — every row's ``A^H N A`` Gram matrix, Cholesky factorisation and
  solve run as batched matmuls.
* The reference forms the full ``[nsamp, nsamp]`` operator ``A @ beta`` to
  extract the variance diagonal (dpss.py:240).  That intermediate never
  exists here: with ``K = A^H diag(Ni) A = Ci - Si*I`` the diagonal is

      var_i = einsum("ik,kl,il->i", A, Ci^-1 K Ci^-H, conj(A))

  which is O(nsamp * nmodes^2) and keeps everything in the small mode basis.
* Basis construction (a one-time eigendecomposition of a small covariance)
  stays on the host in numpy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .tools import invert_no_zero

__all__ = [
    "make_covariance",
    "get_basis",
    "project",
    "solve_batched",
    "filter_batched",
    "inpaint_batched",
    "accumulate_variance",
    "flag_above_cutoff",
]


# ---------------------------------------------------------------------------
# Basis construction (host, one-time)
# ---------------------------------------------------------------------------


def make_covariance(samples, halfwidths, centres) -> np.ndarray:
    """Signal covariance: sum of Fourier-space top-hats (reference dpss.py:9).

    ``cov[i, j] = sum_k exp(-2 pi i c_k (s_i - s_j)) sinc(2 w_k (s_i - s_j))``.
    Real if every centre is zero.
    """
    if np.isscalar(halfwidths):
        halfwidths = [halfwidths]
    if np.isscalar(centres):
        centres = [centres]
    if len(centres) != len(halfwidths):
        raise ValueError(
            "One centre is needed per halfwidth. "
            f"halfwidths={halfwidths} vs centres={centres}"
        )

    samples = np.asarray(samples, dtype=np.float64)
    ds = samples[:, None] - samples[None, :]
    cov = np.zeros(ds.shape, dtype=np.complex128)
    for ct, hw in zip(centres, halfwidths):
        cov += np.exp(-2.0j * np.pi * ct * ds) * np.sinc(2.0 * hw * ds)

    if np.isreal(cov).all():
        cov = np.ascontiguousarray(cov.real)

    return cov


def get_basis(cov, threshold: float = 1e-12, dtype=np.float32) -> np.ndarray:
    """Slepian basis: eigenvectors above ``threshold * max(eval)``.

    (reference dpss.py:67-118).  Order is decreasing eigenvalue.
    """
    evals, evecs = np.linalg.eigh(cov)
    idx = np.argsort(evals)[::-1]
    evals = evals[idx]
    evecs = evecs[:, idx]

    nmodes = int((evals > threshold * evals.max()).sum())

    rdt = np.dtype(dtype).type(0).real.dtype
    if np.iscomplexobj(evecs):
        out_dt = {"float32": np.complex64, "float64": np.complex128}[rdt.name]
    else:
        out_dt = rdt

    return np.ascontiguousarray(evecs[:, :nmodes]).astype(out_dt)


# ---------------------------------------------------------------------------
# Batched Wiener solve (device)
# ---------------------------------------------------------------------------


def project(x, Ni, A):
    """Noise-weighted projection into the basis: ``A^H (Ni * x)``.

    (reference dpss.py:121-151).  ``x, Ni`` have samples on the LAST axis
    here (batch-first layout); ``A`` is ``[nsamp, nmodes]``.
    """
    A = jnp.asarray(A)
    return jnp.einsum("sm,...s->...m", A.conj(), jnp.asarray(Ni) * jnp.asarray(x))


def _solve_rows(x, Ni, A, Si):
    """One row of the inpainting operator (vmapped).

    x, Ni: [nsamp]; A: [nsamp, nmodes].  Returns (xfilt[nsamp], winp[nsamp]).
    """
    cdt = A.dtype
    Ni_c = Ni.astype(cdt)
    AH = A.conj().T  # [m, s]
    ATNi = AH * Ni_c[None, :]
    K = ATNi @ A  # [m, m] = A^H diag(Ni) A
    Ci = K + Si * jnp.eye(A.shape[1], dtype=cdt)

    L, lower = jax.scipy.linalg.cho_factor(Ci, lower=False)

    # Coefficients of the inpainted data
    xp = AH @ (Ni_c * x.astype(cdt))
    b = jax.scipy.linalg.cho_solve((L, lower), xp)
    xfilt = A @ b

    # Variance diagonal: A Ci^-1 K Ci^-H A^H without the [s, s] intermediate
    CiK = jax.scipy.linalg.cho_solve((L, lower), K)  # Ci^-1 K
    C = jax.scipy.linalg.cho_solve((L, lower), CiK.conj().T).conj().T  # Ci^-1 K Ci^-H
    var = jnp.einsum("sk,kl,sl->s", A, C, A.conj()).real
    winp = invert_no_zero(var)

    # Rows with no valid data produce nothing (reference dpss.py:209 skips)
    ok = jnp.any(Ni > 0)
    return jnp.where(ok, xfilt, 0), jnp.where(ok, winp, 0)


@functools.partial(jax.jit, static_argnames=("Si",))
def solve_batched(x, Ni, A, Si: float = 1e-3):
    """Apply the inpainting operator to a batch of rows.

    Batched replacement for the reference's Python loop (dpss.py:154-251).

    Parameters
    ----------
    x : [..., nsamp] data (real or complex)
    Ni : [..., nsamp] inverse-variance weights (0 = flagged)
    A : [nsamp, nmodes] basis from :func:`get_basis`
    Si : scalar regulariser (expected inverse signal variance)

    Returns
    -------
    xfilt, winp : same shape as ``x`` / ``Ni``.
    """
    x = jnp.asarray(x)
    Ni = jnp.asarray(Ni)
    A = jnp.asarray(A)
    if jnp.iscomplexobj(x) and not jnp.iscomplexobj(A):
        A = A.astype(jnp.result_type(A.dtype, x.dtype))

    shape = x.shape
    xf, wf = jax.vmap(_solve_rows, in_axes=(0, 0, None, None))(
        x.reshape(-1, shape[-1]), Ni.reshape(-1, shape[-1]), A, Si
    )
    return xf.reshape(shape), wf.reshape(shape)


@functools.partial(jax.jit, static_argnames=("Si",))
def filter_batched(x, Ni, A, W, Si: float = 1e-3):
    """DPSS-filter rows: mean-subtract, solve, re-add (reference dpss.py:359).

    The variance accumulation step (interpolating the original weights over
    the gaps) is host-side — apply :func:`accumulate_variance` to the
    returned weights.
    """
    x = jnp.asarray(x)
    W = jnp.asarray(W)
    nvalid = jnp.sum(W, axis=-1, keepdims=True)
    xhat = jnp.sum(x * W, axis=-1, keepdims=True) * invert_no_zero(
        nvalid.astype(x.real.dtype)
    )
    xfilt, wfilt = solve_batched(x - xhat, Ni, A, Si)
    return xfilt + xhat, wfilt


def inpaint_batched(x, Ni, A, W, Si: float = 1e-3):
    """Inpaint rows: filtered values only where flagged (reference dpss.py:407).

    Samples where ``W`` is True keep the input data and weights.
    """
    from .tools import as_device

    x = as_device(x)
    Ni = jnp.asarray(Ni)
    W = jnp.asarray(W)
    xf, wf = filter_batched(x, Ni, A, W, Si)
    return jnp.where(W, x, xf), jnp.where(W, Ni, wf)


# ---------------------------------------------------------------------------
# Weight post-processing (host)
# ---------------------------------------------------------------------------


def accumulate_variance(wo, wi, W) -> np.ndarray:
    """PCHIP-interpolate original variances over gaps and accumulate.

    (reference dpss.py:254-304).  Samples are on the LAST axis here.
    ``wo`` are the original inverse-variance weights, ``wi`` the inpainted
    weights from :func:`solve_batched`, ``W`` the keep-mask.
    """
    from scipy.interpolate import PchipInterpolator

    wo = np.asarray(wo)
    wi = np.asarray(wi)
    W = np.asarray(W)

    vo = np.asarray(invert_no_zero(wo))
    vi = np.asarray(invert_no_zero(wi)).copy()

    nsamp = vo.shape[-1]
    samples = np.arange(nsamp)

    vo2 = vo.reshape(-1, nsamp)
    vi2 = vi.reshape(-1, nsamp)
    W2 = W.reshape(-1, nsamp)

    for ii in range(vo2.shape[0]):
        sel = W2[ii]
        if sel.sum() < 2:
            continue
        pchip = PchipInterpolator(samples[sel], vo2[ii][sel], extrapolate=True)
        wint = pchip(samples)
        wint[wint < 0] = 0
        vi2[ii] += wint

    return np.asarray(invert_no_zero(vi2.reshape(vi.shape)))


# ---------------------------------------------------------------------------
# Reference-layout compatibility API (samples on the FIRST axis, matching
# reference dpss.py:121-489; the batched device kernels above use samples
# LAST)
# ---------------------------------------------------------------------------


def atleast_Nd(x, N: int, lax: int = -1):
    """Expand to at least N dims, new axes grouped after ``lax``.

    (reference dpss.py:446-489).  Returns (expanded, inverse-indexer).
    """
    x = np.asarray(x)
    if x.ndim >= N:
        return x, (slice(None),) * x.ndim

    newdims = (np.newaxis,) * (N - x.ndim)
    if lax == -1:
        lax = x.ndim
    slobj = (slice(None),) * max(x.ndim - lax, 0)

    add = (..., *newdims, *slobj)
    inv = (..., *(0 for _ in newdims), *slobj)
    return x[add], inv


def solve(xp, Ni, A, Si: float = 1e-3):
    """Apply the inpainting operator to projected data (reference dpss.py:154).

    ``xp`` is the output of the reference-layout :func:`project`; samples
    are on the first axis of ``Ni``.  Runs as one batched device solve.
    """
    A = np.asarray(A)
    nmodes = A.shape[1]
    nsamp = A.shape[0]

    xp = np.asarray(xp)
    Ni = np.asarray(Ni)
    # Reference layout: modes/samples on the FIRST axis (positional —
    # locating them by size match silently picks a batch axis whenever
    # nbatch happens to equal nmodes or nsamp)
    if xp.shape[0] != nmodes:
        raise ValueError(
            f"xp must have modes on axis 0 (expected {nmodes}, got "
            f"shape {xp.shape})"
        )
    if Ni.shape[0] != nsamp:
        raise ValueError(
            f"Ni must have samples on axis 0 (expected {nsamp}, got "
            f"shape {Ni.shape})"
        )
    si = 0
    xp2 = np.moveaxis(xp, 0, -1)
    Ni2 = np.moveaxis(Ni, 0, -1)

    xf, wf = _solve_from_projection_batched(
        jnp.asarray(xp2.reshape(-1, nmodes)),
        jnp.asarray(np.broadcast_to(Ni2, xp2.shape[:-1] + (nsamp,)).reshape(-1, nsamp)),
        jnp.asarray(A),
        Si,
    )
    xf = np.asarray(xf).reshape(xp2.shape[:-1] + (nsamp,))
    wf = np.asarray(wf).reshape(xp2.shape[:-1] + (nsamp,))
    return np.moveaxis(xf, -1, si), np.moveaxis(wf, -1, si)


@functools.partial(jax.jit, static_argnames=("Si",))
def _solve_from_projection_batched(xp, Ni, A, Si):
    def one(xp_b, Ni_b):
        cdt = A.dtype
        Ni_c = Ni_b.astype(cdt)
        AH = A.conj().T
        ATNi = AH * Ni_c[None, :]
        K = ATNi @ A
        Ci = K + Si * jnp.eye(A.shape[1], dtype=cdt)
        L = jax.scipy.linalg.cho_factor(Ci, lower=False)
        b = jax.scipy.linalg.cho_solve(L, xp_b.astype(cdt))
        xfilt = A @ b
        CiK = jax.scipy.linalg.cho_solve(L, K)
        C = jax.scipy.linalg.cho_solve(L, CiK.conj().T).conj().T
        var = jnp.einsum("sk,kl,sl->s", A, C, A.conj()).real
        winp = invert_no_zero(var)
        ok = jnp.any(Ni_b > 0)
        return jnp.where(ok, xfilt, 0), jnp.where(ok, winp, 0)

    return jax.vmap(one)(xp, Ni)


def filter(x, Ni, A, W, Si: float = 1e-3):  # noqa: A001 - reference name
    """Reference-layout DPSS filter (samples first; reference dpss.py:359).

    ``Ni``/``W`` expand with TRAILING axes (atleast_Nd) before
    broadcasting, so a 1-D Ni[nsamp] aligns with the sample axis of
    x[nsamp, nbatch] — plain broadcast_to would pair it with the batch
    axis.
    """
    x = np.asarray(x)
    Ni_b, _ = atleast_Nd(np.asarray(Ni), x.ndim)
    W_b, _ = atleast_Nd(np.asarray(W), x.ndim)
    x2 = np.moveaxis(x, 0, -1)
    Ni2 = np.moveaxis(np.broadcast_to(Ni_b, x.shape), 0, -1)
    W2 = np.moveaxis(np.broadcast_to(W_b, x.shape), 0, -1)

    xf, wf = filter_batched(x2, Ni2, A, W2, Si)
    wf = accumulate_variance(Ni2, np.asarray(wf), W2)
    return np.moveaxis(np.asarray(xf), -1, 0), np.moveaxis(wf, -1, 0)


def inpaint(x, Ni, A, W, Si: float = 1e-3):
    """Reference-layout DPSS inpainting (reference dpss.py:407)."""
    xinp, winp = filter(x, Ni, A, W, Si)
    x = np.broadcast_to(np.asarray(x), xinp.shape)
    Ni_b, _ = atleast_Nd(np.asarray(Ni), winp.ndim)
    W_b, _ = atleast_Nd(np.asarray(W), xinp.ndim)
    Ni = np.broadcast_to(Ni_b, winp.shape)
    Wb = np.broadcast_to(W_b, xinp.shape)
    xinp = np.where(Wb, x, xinp)
    winp = np.where(Wb, Ni, winp)
    return xinp, winp


def flag_above_cutoff(W, fc=None) -> np.ndarray:
    """Mask gaps wider than ``fc`` samples (reference dpss.py:307-356).

    Samples on the LAST axis.  The reference loops over columns and flagged
    runs in Python; here the run widths come from two vectorised
    running-extrema passes (prev-valid / next-valid index per sample).
    Edge regions outside the first/last valid sample are always flagged.
    """
    W = np.asarray(W, dtype=bool)
    if fc is None:
        return W

    n = W.shape[-1]
    idx = np.arange(n)
    # Index of the most recent valid sample at or before each position
    pv = np.where(W, idx, -1)
    pv = np.maximum.accumulate(pv, axis=-1)
    # Index of the next valid sample at or after each position
    nv = np.where(W, idx, n)
    nv = np.minimum.accumulate(nv[..., ::-1], axis=-1)[..., ::-1]

    # Width of the flagged run containing each sample (run length - 1,
    # matching reference dpss.py:351), 0 on valid samples, 2*fc at edges
    dist = (nv - pv - 2).astype(np.float64)
    dist[W] = 0.0
    dist[(pv < 0) | (nv >= n)] = 2.0 * fc

    return dist < fc
