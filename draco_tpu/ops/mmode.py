"""m-mode pack/unpack transforms.

The core of the m-mode formalism data path: FFT a periodic sidereal (RA)
axis and pack positive/negative harmonic orders into the ``[m, msign, ...]``
layout used by the MModes containers.  Semantics (including the odd/even RA
handling and the conjugation of negative modes) match the reference
``_make_marray``/``_unpack_marray`` (reference
draco/analysis/transform.py:644-705 and 820-851), but run as single batched
device FFTs over all leading axes rather than per-row FFTW calls.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "make_marray",
    "unpack_marray",
    "mmodes_to_sidereal",
    "default_mmax",
    "fast_fft_size",
]


def fast_fft_size(n: int) -> int:
    """Smallest 5-smooth size >= n.

    FFT libraries fall back to Bluestein for sizes with large prime
    factors (e.g. the natural minimal sidereal length 2*mmax + 1 =
    1535 = 5 x 307), which costs several radix-friendly transforms of
    ~2x the length.  Internal sidereal axes should round up to the next
    2/3/5-smooth size instead — the extra samples are mathematically
    inert (the m-mode pack/unpack keeps the same modes).
    """
    best = 1
    while best < n:
        best *= 2
    m = best  # power of two >= n is always a candidate
    p3 = 1
    while p3 <= m:
        p35 = p3
        while p35 <= m:
            # smallest power of 2 lifting p35 over n
            p = p35
            while p < n:
                p *= 2
            m = min(m, p)
            p35 *= 5
        p3 *= 3
    return m


def default_mmax(nra: int) -> int:
    """The natural mmax for an RA axis of length nra."""
    return nra // 2


def make_marray(ts, mmax: int | None = None, dtype=None):
    """Pack a sidereal stream into m-modes.

    Parameters
    ----------
    ts
        Time stream with RA as the *last* axis, shape [..., nra].
    mmax
        Maximum m to keep (defaults to nra // 2).
    dtype
        Output complex dtype (defaults to the FFT result dtype).

    Returns
    -------
    mmodes
        Array of shape [mmax+1, 2, ...] where ``mmodes[m, 0] = V_m`` and
        ``mmodes[m, 1] = conj(V_{-m})`` with FFT normalisation 1/nra.
    """
    from .tools import as_device

    ts = as_device(ts)
    N = ts.shape[-1]
    if mmax is None:
        mmax = default_mmax(N)

    # Negative/positive mode count bookkeeping (reference
    # transform.py:678-679): the FFT of N samples holds N//2 (+1 if odd)
    # usable positive modes and N//2 - 1 + N%2 negative modes.
    mlim = min(N // 2, mmax)
    mlim_neg = N // 2 - 1 + N % 2 if mmax >= N // 2 else mmax

    m_fft = jnp.fft.fft(ts, axis=-1) / N
    m_fft = jnp.moveaxis(m_fft, -1, 0)  # [nra, ...]
    if dtype is not None:
        m_fft = m_fft.astype(dtype)

    shape = (mmax + 1, 2, *ts.shape[:-1])
    out = jnp.zeros(shape, dtype=m_fft.dtype)
    out = out.at[: mlim + 1, 0].set(m_fft[: mlim + 1])
    # Negative modes: frequencies N-1, N-2, ... map to m = -1, -2, ...
    out = out.at[1 : mlim_neg + 1, 1].set(
        jnp.conj(m_fft[-1 : -(mlim_neg + 1) : -1])
    )
    return out


def unpack_marray(mmodes, n: int | None = None, oddra: bool | None = None):
    """Unpack [m, msign, ...] m-modes into a full FFT spectrum [..., ntime].

    Mirrors reference ``_unpack_marray`` (transform.py:820-851): the number
    of output samples defaults to Nyquist (2*mmax (+1 if odd)); modes beyond
    the Nyquist limit of a requested ``n`` are clipped.
    """
    from .tools import as_device

    mmodes = as_device(mmodes)
    mmax_plus = mmodes.shape[0] - 1
    if oddra is None:
        # The largest negative m is unfilled for an even RA count.
        # NOTE: this autodetect is ambiguous when the m = -mmax mode is
        # exactly zero in genuinely odd-RA data (it will then infer an
        # even grid, one sample short) — callers that know the grid
        # should pass ``oddra`` (the MModes container carries it).
        from .tools import device_to_numpy

        top = device_to_numpy(mmodes[mmax_plus, 1])
        oddra = bool(np.any(top != 0))
    mmax_minus = mmax_plus if oddra else mmax_plus - 1

    if n is None:
        ntimes = mmax_plus + mmax_minus + 1
    else:
        ntimes = n
        mmax_plus = min(ntimes // 2, mmax_plus)
        mmax_minus = min((ntimes - 1) // 2, mmax_minus)

    shape = mmodes.shape[2:]
    marray = jnp.zeros((*shape, ntimes), dtype=mmodes.dtype)
    pos = jnp.moveaxis(mmodes[:, 0], 0, -1)  # [..., mmax_plus+1]
    neg = jnp.conj(jnp.moveaxis(mmodes[:, 1], 0, -1))

    marray = marray.at[..., : mmax_plus + 1].set(pos[..., : mmax_plus + 1])
    if mmax_minus > 0:
        # m = 1..mmax_minus into bins -1..-mmax_minus
        marray = marray.at[..., -mmax_minus:].set(
            neg[..., 1 : mmax_minus + 1][..., ::-1]
        )
    return marray


def make_marray_device(ts, mmax: int | None = None):
    """Jitted :func:`make_marray` for TASK-BODY use on device arrays.

    The plain function is eager (fine when traced inside a larger jit,
    its usual habitat); called eagerly it dispatches op by op.
    """
    import functools

    import jax

    @functools.lru_cache(maxsize=None)
    def jitted(mmax_static):
        return jax.jit(lambda x: make_marray(x, mmax=mmax_static))

    return jitted(mmax)(ts)


def mmodes_to_sidereal(mmodes, n: int | None = None, oddra: bool | None = None):
    """Inverse m-mode transform: [m, msign, ...] -> sidereal [..., ntime].

    Equivalent of reference ``_make_ssarray`` (transform.py:814-817):
    inverse FFT scaled so a forward :func:`make_marray` round-trips.
    """
    marray = unpack_marray(mmodes, n=n, oddra=oddra)
    return jnp.fft.ifft(marray * marray.shape[-1], axis=-1)
