"""On-device RFI excision: SumThreshold and the scale-invariant-rank operator.

JAX re-design of the algorithms in reference ``draco/util/rfi.py``
(sumthreshold_py:8, scale_invariant_rank:205, sir:260):

* **SumThreshold** (Offringa et al., see the SumThreshold technical report)
  flags progressively longer runs of contaminated samples.  The reference
  walks ``scipy.ndimage.correlate1d`` over the array per window length; here
  every windowed sum is a cumulative-sum difference on the accelerator, so
  the whole multi-scale pass is one fused XLA program batched over all
  leading axes.

* **SIR** (scale-invariant rank, arXiv:1201.3364) extends a mask to any
  window in which the flagged fraction exceeds ``1 - eta``.  Sample ``i``
  is flagged iff some window ``[a, b)`` containing it satisfies
  ``sum_{j in [a,b)} (mask[j] - 1 + eta) >= 0``; writing ``P`` for the
  prefix sums of that weight this is ``max_{b > i} P[b] >= min_{a <= i}
  P[a]``, which maps onto two directional ``lax.cummax``/``cummin`` scans.

Inputs and outputs are host numpy arrays (masks are consumed by host-side
container bookkeeping); all heavy lifting runs under ``jit``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "sumthreshold",
    "sumthreshold_py",
    "scale_invariant_rank",
    "sir1d",
    "sir",
]


def _float_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _trailing_window_sum(x, m: int):
    """``y[i] = sum(x[i-m+1 : i+1])`` along the last axis, edge-replicated.

    Matches the alignment of the reference's window-sum correlation
    (``correlate1d(..., origin=(m-1)//2, mode="nearest")``).
    """
    if m == 1:
        return x
    n = x.shape[-1]
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(m - 1, 0)], mode="edge")
    c = jnp.cumsum(xp, axis=-1)
    c0 = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
    return c0[..., m:] - c0[..., :n]


def _leading_window_any(mask, m: int):
    """``y[i] = any(mask[i : i+m])`` along the last axis, edge-replicated.

    The back-spread step: a window whose sum trips the threshold has its
    right edge at the hit position, so every sample it covered is ``m-1``
    or fewer places to the *left*; equivalently each output looks ``m-1``
    places to the right.
    """
    if m == 1:
        return mask
    n = mask.shape[-1]
    xp = jnp.pad(
        mask.astype(jnp.int32),
        [(0, 0)] * (mask.ndim - 1) + [(0, m - 1)],
        mode="edge",
    )
    c = jnp.cumsum(xp, axis=-1)
    c0 = jnp.concatenate([jnp.zeros_like(c[..., :1]), c], axis=-1)
    return (c0[..., m:] - c0[..., :n]) > 0


def _masked_quantile(x, valid, q: float):
    """Quantile of ``x[valid]`` with numpy's linear interpolation."""
    xf = jnp.ravel(x)
    vf = jnp.ravel(valid)
    s = jnp.sort(jnp.where(vf, xf, jnp.inf))
    n = jnp.sum(vf)
    pos = q * (jnp.maximum(n, 1) - 1)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_m",
        "axes",
        "only_positive",
        "correct_for_missing",
        "remove_median",
        "use_variance",
        "use_threshold",
    ),
)
def _sumthreshold_device(
    data,
    flag,
    variance,
    threshold1,
    rho,
    *,
    max_m: int,
    axes: tuple,
    only_positive: bool,
    correct_for_missing: bool,
    remove_median: bool,
    use_variance: bool,
    use_threshold: bool,
):
    valid = ~flag
    if remove_median:
        data = data - _masked_quantile(data, valid, 0.5)
    if not use_threshold:
        threshold1 = _masked_quantile(data, valid, 0.95)

    m = 1
    while m <= max_m:
        thresh = threshold1 / rho ** (np.log2(m))
        for axis in axes:
            d = jnp.where(flag, 0.0, data)
            if use_variance:
                cnt = jnp.where(flag, 0.0, variance)
            else:
                cnt = (~flag).astype(data.dtype)

            d = jnp.moveaxis(d, axis, -1)
            cnt = jnp.moveaxis(cnt, axis, -1)
            dsum = _trailing_window_sum(d, m)
            csum = _trailing_window_sum(cnt, m)
            if correct_for_missing:
                csum = jnp.sqrt(csum)

            excess = dsum if only_positive else jnp.abs(dsum)
            hit = excess > csum * thresh
            flag = flag | jnp.moveaxis(_leading_window_any(hit, m), -1, axis)
        m *= 2

    return flag


def sumthreshold(
    data,
    max_m: int = 16,
    start_flag=None,
    threshold1=None,
    remove_median: bool = True,
    correct_for_missing: bool = True,
    variance=None,
    rho=None,
    axes=None,
    only_positive: bool = False,
):
    """Multi-scale SumThreshold outlier mask, computed on device.

    Parameters mirror reference ``draco/util/rfi.py:8-140``: window lengths
    double from 1 to ``max_m``; ``threshold1`` is the single-sample
    threshold (default: 95th percentile of the unflagged data, or required
    in units of sigma when ``variance`` is supplied); ``rho`` controls the
    per-octave threshold falloff; ``axes`` lists the axes to sweep (default
    all, last first).  Non-finite samples and ``start_flag`` seed the mask.

    Returns a boolean numpy mask of the same shape as ``data``.
    """
    arr = np.asarray(data)

    if axes is None:
        axes = tuple(range(arr.ndim - 1, -1, -1))
    elif np.isscalar(axes):
        axes = (int(axes),)
    else:
        axes = tuple(int(a) for a in axes)

    use_variance = variance is not None
    if use_variance:
        correct_for_missing = True
        if threshold1 is None:
            raise RuntimeError(
                "sumthreshold: supplying a variance estimate requires an "
                "explicit threshold1 (in units of sigma)."
            )
    if rho is None:
        rho = 0.9428 if correct_for_missing else 1.5

    fdt = _float_dtype()
    d = jnp.asarray(arr, dtype=fdt)
    flag0 = ~jnp.isfinite(d)
    if start_flag is not None:
        flag0 = flag0 | jnp.asarray(np.asarray(start_flag), dtype=bool)

    var = (
        jnp.asarray(np.asarray(variance), dtype=fdt)
        if use_variance
        else jnp.zeros((), dtype=fdt)
    )
    thr = (
        jnp.asarray(threshold1, dtype=fdt)
        if threshold1 is not None
        else jnp.zeros((), dtype=fdt)
    )

    out = _sumthreshold_device(
        d,
        flag0,
        var,
        thr,
        jnp.asarray(float(rho), dtype=fdt),
        max_m=int(max_m),
        axes=axes,
        only_positive=bool(only_positive),
        correct_for_missing=bool(correct_for_missing),
        remove_median=bool(remove_median),
        use_variance=use_variance,
        use_threshold=threshold1 is not None,
    )
    return np.asarray(out)


def sumthreshold_py(*args, **kwargs):
    """Alias kept for reference-path compatibility (the reference exposes
    its pure-python implementation under this name)."""
    return sumthreshold(*args, **kwargs)


@functools.partial(jax.jit, static_argnames=("axis",))
def _sir_device(mask, eta, axis: int):
    mask = jnp.moveaxis(mask, axis, -1)
    # mask + (eta - 1), kept in this exact form: flagged samples weigh
    # 1 + (eta - 1) which differs from `eta` in the last bit, and the >=
    # comparison below ties on exactly these values (reference parity).
    w = mask.astype(eta.dtype) + (eta - 1.0)
    p = jnp.cumsum(w, axis=-1)
    p0 = jnp.concatenate([jnp.zeros_like(p[..., :1]), p], axis=-1)
    # best window start at or before i / best window end strictly after
    # i, INCLUDING windows ending at the array end (every i sees P[n]).
    # The reference's in-place reverse max-accumulate skips its final
    # prefix sum for all but the last sample (draco/util/rfi.py:194-198),
    # under-dilating runs that touch the right edge — here the
    # definitional SIR (arXiv:1201.3364) is applied symmetrically.
    best_start = jax.lax.cummin(p0[..., :-1], axis=mask.ndim - 1)
    best_end = jax.lax.cummax(p0[..., 1:], axis=mask.ndim - 1, reverse=True)
    return jnp.moveaxis(mask | (best_end >= best_start), -1, axis)


def sir1d(basemask, eta: float = 0.2, axis: int = -1):
    """Scale-invariant-rank dilation of a boolean mask along one axis.

    A sample is flagged when it lies inside any window whose flagged
    fraction is at least ``1 - eta`` (arXiv:1201.3364); ``eta = 0``
    returns the mask unchanged, ``eta = 1`` flags everything.  Runs as two
    directional scans on device, batched over all other axes.  Semantics
    of reference ``draco/util/rfi.py:147-204``; windows whose flagged
    fraction is *exactly* ``1 - eta`` sit on a float tie whose direction
    depends on summation order (XLA's prefix scan vs numpy's sequential
    cumsum), so individual tie samples may differ from a CPU evaluation.
    """
    m = jnp.asarray(np.asarray(basemask), dtype=bool)
    out = _sir_device(
        m, jnp.asarray(float(eta), dtype=_float_dtype()), axis % m.ndim
    )
    return np.asarray(out)


def scale_invariant_rank(basemask, eta=0.2, axis=-1):
    """SIR applied independently along each listed axis, OR-combined.

    Each axis dilates the *original* mask; results are unioned.  ``eta``
    may be a scalar or a per-axis sequence.  Semantics of reference
    ``draco/util/rfi.py:205-259``.
    """
    basemask = np.asarray(basemask, dtype=bool)
    if basemask.ndim < 1:
        raise ValueError("scale_invariant_rank: mask must be at least 1-D.")

    axis = (axis,) if np.isscalar(axis) else tuple(axis)
    eta = (eta,) * len(axis) if np.isscalar(eta) else tuple(eta)
    if len(eta) != len(axis):
        raise ValueError(
            f"scale_invariant_rank: got {len(eta)} eta values for "
            f"{len(axis)} axes; they must pair up one-to-one."
        )

    out = np.zeros_like(basemask)
    for ax, et in zip(axis, eta):
        out |= sir1d(basemask, eta=et, axis=ax)
    return out


def sir(
    basemask,
    eta: float = 0.2,
    only_freq: bool = False,
    only_time: bool = False,
):
    """SIR over the freq and time axes of a ``[freq, prod, time]`` mask.

    Deprecated in the reference (``draco/util/rfi.py:260``) but kept for
    parity.
    """
    basemask = np.asarray(basemask, dtype=bool)
    if basemask.ndim != 3:
        raise ValueError(
            f"sir expects a [freq, prod, time] mask; got {basemask.ndim}-D."
        )
    if only_freq and only_time:
        raise ValueError("sir: only_freq and only_time are mutually exclusive.")

    axes = []
    if not only_time:
        axes.append(0)
    if not only_freq:
        axes.append(2)
    return basemask | scale_invariant_rank(basemask, eta=eta, axis=tuple(axes))
