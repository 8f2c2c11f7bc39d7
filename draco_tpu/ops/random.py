"""Random sampling: complex normals and complex Wishart matrices.

JAX-PRNG re-design of reference ``draco/util/random.py``: the Bartlett
decomposition of the Wishart draw (reference random.py:106-137) is fully
vectorised over batch dimensions — per (freq, time) sample-covariance draws
become one batched kernel instead of a Python loop (the SampleNoise hot
loop, reference draco/synthesis/noise.py:344-372).

Both jax (``key=``) and numpy (``rng=``) entry points are provided; the jax
path is the production one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "complex_normal",
    "standard_complex_normal",
    "standard_complex_wishart",
    "complex_wishart",
    "complex_normal_np",
    "standard_complex_wishart_np",
    "complex_wishart_np",
]


def complex_normal(key, size=(), loc=0.0, scale=1.0, dtype=jnp.complex64):
    """Complex normal variates with E|x|^2 = scale^2 (reference random.py:7)."""
    rdtype = jnp.finfo(dtype).dtype
    shape = tuple(size) + (2,)
    z = jax.random.normal(key, shape, dtype=rdtype)
    out = jax.lax.complex(z[..., 0], z[..., 1]) * (scale / np.sqrt(2))
    return out.astype(dtype) + loc


def standard_complex_normal(key, shape, dtype=jnp.complex64):
    """Standard complex normal (unit total variance) (reference random.py:86)."""
    return complex_normal(key, size=shape, dtype=dtype)


def standard_complex_wishart(key, m: int, n, batch_shape=(), dtype=jnp.complex64):
    """Standard complex Wishart draws via the Bartlett decomposition.

    W = T T^H with T lower-triangular: strict lower triangle filled with
    standard complex normals / sqrt(2)... matching the reference scaling
    (random.py:126-137): off-diagonals are CN(0,1) (variance 1 total), the
    diagonal is sqrt(Gamma(n - i)).

    Parameters
    ----------
    key
        jax PRNG key.
    m
        Matrix dimension.
    n
        Degrees of freedom (may be an array broadcasting against
        ``batch_shape`` for per-sample dof).
    batch_shape
        Leading batch dims; one independent draw each.
    """
    rdtype = jnp.finfo(dtype).dtype
    kn, kg = jax.random.split(key)
    z = jax.random.normal(kn, (*batch_shape, m, m, 2), dtype=rdtype)
    T = jax.lax.complex(z[..., 0], z[..., 1]) / np.sqrt(2)
    T = jnp.tril(T, k=-1)

    i = jnp.arange(m)
    alpha = jnp.broadcast_to(
        jnp.asarray(n, dtype=rdtype)[..., None] - i, (*batch_shape, m)
    )
    g = jax.random.gamma(kg, alpha, dtype=rdtype)
    T = T + jnp.zeros_like(T).at[..., i, i].set(jnp.sqrt(g).astype(dtype))
    return T @ jnp.conj(jnp.swapaxes(T, -1, -2))


def complex_wishart(key, C, n, batch_shape=(), dtype=None):
    """Complex Wishart draws with mean n*C (reference random.py:140).

    ``C`` may carry batch dims; an independent standard Wishart is drawn per
    batch element and transformed by the Cholesky factor of C.
    """
    C = jnp.asarray(C)
    if dtype is None:
        dtype = C.dtype
    m = C.shape[-1]
    if batch_shape == ():
        # independent draws PER batch element of C by default — a
        # single [m, m] draw broadcast over the batch would make every
        # 'sample' perfectly correlated
        batch_shape = C.shape[:-2]
    L = jnp.linalg.cholesky(C)
    A = standard_complex_wishart(key, m, n, batch_shape=batch_shape, dtype=dtype)
    return L @ A @ jnp.conj(jnp.swapaxes(L, -1, -2))


# ---------------------------------------------------------------------------
# numpy twins (host-side parity with the reference API)
# ---------------------------------------------------------------------------


def complex_normal_np(loc=0.0, scale=1.0, size=None, dtype=np.complex128, rng=None):
    if rng is None:
        rng = np.random.default_rng()
    if size is None:
        size = (1,)
    rtype = np.float32 if dtype == np.complex64 else np.float64
    z = rng.standard_normal((*tuple(size), 2)).astype(rtype)
    out = (z[..., 0] + 1j * z[..., 1]).astype(dtype) * (scale / np.sqrt(2))
    return out + loc


def standard_complex_wishart_np(m, n, rng=None):
    if rng is None:
        rng = np.random.default_rng()
    T = np.zeros((m, m), dtype=np.complex128)
    ntri = m * (m - 1) // 2
    T[np.tril_indices(m, k=-1)] = (
        rng.standard_normal(ntri) + 1j * rng.standard_normal(ntri)
    ) / np.sqrt(2)
    for i in range(m):
        T[i, i] = rng.gamma(n - i) ** 0.5
    return T @ T.conj().T


def complex_wishart_np(C, n, rng=None):
    import scipy.linalg as la

    L = la.cholesky(np.asarray(C), lower=True)
    A = standard_complex_wishart_np(C.shape[0], n, rng=rng)
    return L @ A @ L.conj().T
