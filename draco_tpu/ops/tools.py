"""Miscellaneous numeric tools (device-first).

Re-provides reference ``draco/util/tools.py`` (and the pieces of
``caput.algorithms`` draco uses): triangle index maps, gain application,
redundancy counting, apodisation windows, phase wrapping.  Hot paths are
vectorised jnp kernels (gathers + segment sums) instead of the reference's
Cython loops (reference draco/util/_fast_tools.pyx:134, tools.py:210).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "invert_no_zero",
    "cmap",
    "icmap",
    "unique_pair_indices",
    "find_key",
    "find_keys",
    "find_inputs",
    "broadcast_weights",
    "apply_gain",
    "extract_diagonal",
    "calculate_redundancy",
    "window_generalised",
    "correct_phase_wrap",
    "threefloat_split",
    "phase_frac3",
    "taper_mask",
    "find_contiguous_slices",
    "unpack_product_array",
]


def invert_no_zero(x, out=None):
    """Reciprocal returning exactly zero where the input is (near) zero.

    Equivalent of ``caput.algorithms.invert_no_zero`` (used throughout the
    reference, e.g. draco/analysis/transform.py:600).  Works on numpy or jax
    arrays; tiny values (below ~1/max_float) are treated as zero.
    """
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = np.asarray(x)
        rdt = np.finfo(
            x.dtype if np.issubdtype(x.dtype, np.inexact) else np.float64
        )
        thresh = 2.0 / rdt.max
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            res = np.where(np.abs(x) < thresh, 0.0, 1.0 / x)
        if out is not None:
            out[:] = res
            return out
        return res
    x = jnp.asarray(x)
    # Use the smallest *normal* number as the cut: XLA flushes subnormals to
    # zero, so a subnormal threshold like 1/max would compare as 0.
    thresh = jnp.finfo(x.real.dtype).tiny
    small = jnp.abs(x) < thresh
    return jnp.where(small, jnp.zeros_like(x), 1.0 / jnp.where(small, jnp.ones_like(x), x))


def cmap(i, j, n):
    """Pair index of feeds (i, j) in upper-triangle order (tools.py:21)."""
    i, j = np.minimum(i, j), np.maximum(i, j)
    return (n * (n + 1) // 2) - ((n - i) * (n - i + 1) // 2) + (j - i)


def icmap(ix, n):
    """Feed indices (i, j) for pair index ix (tools.py:42). Vectorised."""
    ix = np.asarray(ix)
    # Solve i: largest i with cmap(i, i, n) <= ix
    # cmap(i,i,n) = n(n+1)/2 - (n-i)(n-i+1)/2
    t = n * (n + 1) // 2 - ix
    # (n-i)(n-i+1)/2 >= t  ->  n-i >= (sqrt(8t+1)-1)/2
    k = np.ceil((np.sqrt(8 * t.astype(np.float64) + 1) - 1) / 2).astype(np.int64)
    i = n - k
    j = ix - cmap(i, i, n) + i
    if np.ndim(ix) == 0:
        return int(i), int(j)
    return i, j


def unique_pair_indices(n: int, autos: bool = True) -> np.ndarray:
    """All upper-triangle feed pairs [(i, j)] for n feeds."""
    i, j = np.triu_indices(n, k=0 if autos else 1)
    return np.stack([i, j], axis=-1)


def find_key(key_list, key):
    """Index of ``key`` in ``key_list`` or None (tools.py:66)."""
    try:
        entries = [tuple(x) for x in key_list]
        key = tuple(key)
    except TypeError:
        entries = list(key_list)
    try:
        return entries.index(key)
    except ValueError:
        return None


def _norm_key(k):
    """Normalise a key element: HDF5 round trips turn unicode into bytes."""
    if isinstance(k, bytes):
        return k.decode()
    if isinstance(k, np.str_):
        return str(k)
    return k


def find_keys(key_list, keys, require_match: bool = False):
    """Indices of ``keys`` in ``key_list`` (tools.py:95).

    String keys compare equal across the bytes/unicode divide (HDF5
    stores fixed-width strings as bytes).
    """
    def _tup(kk):
        # str/bytes are iterable but are scalar keys, not tuples
        if isinstance(kk, (str, bytes, np.str_, np.bytes_)):
            raise TypeError
        return tuple(_norm_key(x) for x in kk)

    try:
        positions = {_tup(kk): ii for ii, kk in enumerate(key_list)}
        found = [positions.get(_tup(key)) for key in keys]
    except TypeError:
        positions = {_norm_key(kk): ii for ii, kk in enumerate(key_list)}
        found = [positions.get(_norm_key(key)) for key in keys]
    if require_match and None in found:
        raise ValueError("Some requested keys are absent.")
    return found


def find_inputs(input_index, inputs, require_match: bool = False):
    """Indices of ``inputs`` in ``input_index`` keyed on channel id.

    (tools.py:130)
    """
    names = input_index.dtype.names or ()
    if "correlator_input" in names:
        field = "correlator_input"
    elif "chan_id" in names:
        field = "chan_id"
    else:
        return find_keys(input_index, inputs, require_match=require_match)
    if inputs.dtype.names and field not in inputs.dtype.names:
        raise ValueError(f"`inputs` array does not have a `{field}` field.")
    return find_keys(
        input_index[field], inputs[field], require_match=require_match
    )


def redefine_stack_index_map(telescope, inputs, prod, stack, reverse_stack):
    """Re-pick stack representatives using only unmasked telescope inputs.

    (reference tools.py:359-414).  Returns (stack_new, stack_flag) where
    ``stack_flag`` is False for stacks with no valid representative.
    """
    tel_index = find_inputs(telescope.input_index, inputs, require_match=False)

    stack_new = stack.copy()
    stack_flag = np.zeros(stack_new.size, dtype=bool)
    prod_pairs = np.stack([prod["input_a"], prod["input_b"]], axis=-1)

    def product_ok(pind):
        a, b = prod_pairs[pind]
        ta, tb = tel_index[a], tel_index[b]
        return (
            ta is not None and tb is not None and telescope.feedmask[ta, tb]
        )

    for sind in range(stack_new.size):
        if product_ok(stack["prod"][sind]):
            stack_flag[sind] = True
            continue
        # representative masked out: pick any surviving member product
        for member in np.flatnonzero(reverse_stack["stack"] == sind):
            if product_ok(member):
                stack_new["prod"][sind] = member
                stack_new["conjugate"][sind] = reverse_stack[member][
                    "conjugate"
                ]
                stack_flag[sind] = True
                break

    return stack_new, stack_flag


def broadcast_weights(waxis_names, daxis_names):
    """Slice tuple broadcasting a weight array onto a data array.

    (tools.py:173)
    """
    extra = set(waxis_names) - set(daxis_names)
    if extra:
        raise ValueError(f"The weight carries axes the data lacks: {extra}")
    in_data_order = [ax for ax in daxis_names if ax in waxis_names]
    if in_data_order != list(waxis_names):
        raise ValueError(
            f"Weight axes {waxis_names} do not appear in data axes "
            f"{daxis_names} in the correct order."
        )
    kept = set(waxis_names)
    return tuple(slice(None) if ax in kept else None for ax in daxis_names)


def apply_gain(vis, gain, axis: int = 1, out=None, prod_map=None):
    """Apply per-input gains to products: out_p = vis_p * g_i * conj(g_j).

    Vectorised gather version of the reference per-product loop
    (tools.py:210-272).  ``prod_map`` gives (input_a, input_b) per product;
    if omitted the upper-triangle ordering is assumed.
    """
    vis = as_device(vis)
    gain = as_device(gain)
    nprod = vis.shape[axis]
    ninput = gain.shape[axis]

    if prod_map is None:
        if nprod != ninput * (ninput + 1) // 2:
            raise ValueError("Number of inputs does not match number of products.")
        pm = unique_pair_indices(ninput)
        ia, ib = pm[:, 0], pm[:, 1]
    else:
        if len(prod_map) != nprod:
            raise ValueError(
                "prod_map must list exactly one entry per product."
            )
        pm = np.asarray(prod_map)
        if pm.dtype.names:
            ia, ib = pm["input_a"], pm["input_b"]
        else:
            ia, ib = pm[:, 0], pm[:, 1]

    ga = jnp.take(gain, jnp.asarray(ia), axis=axis)
    gb = jnp.conj(jnp.take(gain, jnp.asarray(ib), axis=axis))
    result = vis * ga * gb
    if out is not None:
        out[:] = np.asarray(result)
        return out
    return result


@partial(jax.jit, static_argnames=("axis",))
def _take_axis_jit(utmat, idx, *, axis: int):
    return jnp.take(utmat, idx, axis=axis)


@partial(jax.jit, static_argnames=("axis", "nside"))
def _unpack_product_jit(utmat, pidx, conj, *, axis: int, nside: int):
    gathered = jnp.take(utmat, pidx, axis=axis)
    new_shape = utmat.shape[:axis] + (nside, nside) + utmat.shape[axis + 1 :]
    gathered = gathered.reshape(new_shape)
    cmask = conj.reshape(
        (1,) * axis + (nside, nside) + (1,) * (utmat.ndim - axis - 1)
    )
    return jnp.where(cmask, jnp.conj(gathered), gathered)


def extract_diagonal(utmat, axis: int = 1):
    """Extract the autocorrelations from an upper-triangle product axis.

    (tools.py:275)
    """
    utmat = as_device(utmat)
    nside = int((2 * utmat.shape[axis]) ** 0.5)
    if utmat.shape[axis] != nside * (nside + 1) // 2:
        raise RuntimeError(
            f"Array length ({utmat.shape[axis]}) of axis {axis} does not "
            "correspond to upper triangle of a square matrix"
        )
    diag_ind = jnp.asarray(
        np.asarray([cmap(ii, ii, nside) for ii in range(nside)], dtype=np.int32)
    )
    # jitted gather
    return _take_axis_jit(utmat, diag_ind, axis=axis)


def unpack_product_array(utmat, axis: int = 1, nside: int | None = None):
    """Expand an upper-triangle product axis into a Hermitian [n, n] pair.

    Device equivalent of the Cython ``_unpack_product_array_fast``
    (reference draco/util/_fast_tools.pyx:91): a gather + conjugate mask
    instead of a scatter loop.
    """
    utmat = as_device(utmat)
    nprod = utmat.shape[axis]
    n_full = int((2 * nprod) ** 0.5)
    if n_full * (n_full + 1) // 2 != nprod:
        raise ValueError(
            f"axis length {nprod} is not a triangular number."
        )
    if nside is None:
        nside = n_full
    elif nside != n_full:
        # indexing a feed SUBSET still requires cmap over the FULL
        # packing n — computing it with the subset size gathers
        # unrelated products with no error
        raise NotImplementedError(
            f"feed subsets (nside={nside} != packing n={n_full}) are "
            "not supported; pass the full feed count."
        )
    ii, jj = np.meshgrid(np.arange(nside), np.arange(nside), indexing="ij")
    pidx = cmap(ii, jj, nside)  # [n, n] product index (upper-tri symmetric)
    conj = (ii > jj)
    # ONE jitted program
    return _unpack_product_jit(
        utmat,
        jnp.asarray(pidx.ravel().astype(np.int32)),
        jnp.asarray(conj),
        axis=axis,
        nside=nside,
    )


def calculate_redundancy(input_flags, prod_map, stack_index, nstack: int):
    """Per-stack redundancy counts from per-input flags.

    Device segment-sum formulation of the Cython ``_calc_redundancy``
    (reference draco/util/_fast_tools.pyx:134, tools.py:313):
    redundancy[s, t] = sum over products p in stack s of
    flag[input_a(p), t] * flag[input_b(p), t].
    """
    input_flags = np.asarray(input_flags)
    if not input_flags.any():
        input_flags = np.ones_like(input_flags)
    flags = jnp.asarray(input_flags, dtype=jnp.float32)

    pm = np.asarray(prod_map)
    if pm.dtype.names:
        ia, ib = pm["input_a"].astype(int), pm["input_b"].astype(int)
    else:
        ia, ib = pm[:, 0], pm[:, 1]
    stack_index = np.asarray(stack_index).astype(int)
    valid = (stack_index >= 0) & (stack_index < nstack)
    seg = np.where(valid, stack_index, nstack)  # invalid -> overflow bucket

    pair_flags = flags[jnp.asarray(ia)] * flags[jnp.asarray(ib)]  # [nprod, nt]
    red = jax.ops.segment_sum(
        pair_flags, jnp.asarray(seg), num_segments=nstack + 1
    )[:nstack]
    return red.astype(jnp.float32)


def polarization_map(index_map, telescope, exclude_autos: bool = True):
    """Map each stack entry to pol = ['XX', 'XY', 'YX', 'YY'].

    (reference tools.py:417-500, vectorised).  Entries that are autos
    (when excluded) or use non-standard feeds map to -1.
    """
    teltype = getattr(telescope, "stack_type", "redundant")
    if teltype != "redundant":
        raise RuntimeError(
            f"Telescope stack type needs to be 'redundant'. Is {teltype}"
        )

    inp = np.asarray(index_map["input"])
    input_map = inp["chan_id"] if inp.dtype.names else inp

    stack = np.asarray(index_map["stack"])
    prod = np.asarray(index_map["prod"])

    pi = stack["prod"] if stack.dtype.names else stack[:, 0]
    pa = prod[pi]["input_a"] if prod.dtype.names else prod[pi, 0]
    pb = prod[pi]["input_b"] if prod.dtype.names else prod[pi, 1]
    ipt0 = input_map[pa].astype(int)
    ipt1 = input_map[pb].astype(int)

    bc0 = telescope.beamclass[ipt0]
    bc1 = telescope.beamclass[ipt1]
    good = (bc0 <= 1) & (bc1 <= 1)
    if exclude_autos:
        good &= ipt0 != ipt1

    conj = telescope.feedconj[ipt0, ipt1]
    b0 = np.where(conj, bc1, bc0)
    b1 = np.where(conj, bc0, bc1)

    # pol index in ['XX', 'XY', 'YX', 'YY'] = 2*b0 + b1
    polmap = 2 * b0 + b1
    return np.where(good, polmap, -1).astype(int)


def baseline_vector(index_map, telescope):
    """Baseline vectors in metres, shape [2, nstack].

    (reference tools.py:503-543, vectorised)
    """
    inp = np.asarray(index_map["input"])
    input_map = inp["chan_id"] if inp.dtype.names else inp

    stack = np.asarray(index_map["stack"])
    prod = np.asarray(index_map["prod"])

    pi = stack["prod"] if stack.dtype.names else stack[:, 0]
    pa = prod[pi]["input_a"] if prod.dtype.names else prod[pi, 0]
    pb = prod[pi]["input_b"] if prod.dtype.names else prod[pi, 1]
    ipt0 = input_map[pa].astype(int)
    ipt1 = input_map[pb].astype(int)

    unique_index = telescope.feedmap[ipt0, ipt1]
    return telescope.baselines[unique_index].T.astype(np.float64)


def penalized_least_squares_1d(
    y, reweight_func, mask=None, lam: float = 1e2, epsilon: float = 1e-2,
    max_iter: int = 100,
):
    """Iteratively reweighted penalised-least-squares baseline.

    (reference tools.py:600-714).  Solves ``(W + lam D2^T D2) z = W y`` with
    a banded Cholesky solve, iterating the weights via ``reweight_func``.
    """
    import warnings

    from scipy import linalg as la
    from scipy.sparse import dia_array

    y = np.squeeze(np.asarray(y, dtype=np.float64))
    if y.ndim != 1:
        raise ValueError(f"Expected 1D data array - got shape {y.shape}")

    n = y.shape[0]

    if mask is None:
        mask = np.zeros(n, dtype=bool)
    elif np.all(mask):
        warnings.warn("Every sample is masked; nothing to fit.")
        return np.zeros_like(y)
    mask = np.squeeze(np.asarray(mask, dtype=bool))

    # lower-banded lam * D2 D2^T for the second-difference operator D2
    stencil = np.tile([[1.0], [-2.0], [1.0]], (1, n - 1))
    d2 = dia_array((stencil, [-2, -1, 0]), shape=(n, n - 2))
    smooth = lam * (d2 @ d2.T)
    bands = np.ones((3, n), dtype=np.float64)
    for off in range(3):
        bands[off, : n - off] = smooth.diagonal(off)

    weights = np.zeros((3, n), dtype=np.float64)
    weights[0] = 1.0

    fit = np.zeros_like(y)
    for it in range(max_iter):
        weights[:, mask] = 0.0
        w = weights[0]
        fit = la.solveh_banded(
            bands + weights, w * y, lower=True, check_finite=False
        )
        w_next = reweight_func(y - fit, mask, it)
        if la.norm(w - w_next) / max(la.norm(w), 1e-30) < epsilon:
            break
        weights[0] = w_next
    else:
        warnings.warn(f"Baseline fit still moving after {max_iter} iterations.")

    return fit


def arPLS_1d(y, mask=None, lam: float = 1e2, epsilon: float = 1e-2,
             max_iter: int = 100):
    """Asymmetrically reweighted PLS baseline (reference tools.py:717-780)."""
    y = np.asarray(y, dtype=np.float64)
    exp_cap = np.log(np.finfo(y.dtype).max)

    def _reweight(resid, m, it):
        below = (resid < 0) & ~m
        if not below.any():
            return np.full_like(resid, 0.5)
        mu = np.mean(resid, where=below)
        sigma = np.std(resid, where=below)
        arg = 2 * (resid - (2 * sigma - mu)) * np.asarray(invert_no_zero(sigma))
        arg = np.clip(arg, -exp_cap, exp_cap)
        return np.asarray(invert_no_zero(np.exp(arg) + 1.0))

    return penalized_least_squares_1d(y, _reweight, mask, lam, epsilon, max_iter)


def IarPLS_1d(y, mask=None, lam: float = 1e2, epsilon: float = 1e-2,
              max_iter: int = 100):
    """Improved asymmetrically reweighted PLS baseline (tools.py:783-841)."""
    y = np.asarray(y, dtype=np.float64)
    sqr_cap = np.finfo(y.dtype).max ** 0.5
    exp_cap = np.log(np.finfo(y.dtype).max)

    def _reweight(resid, m, it):
        below = (resid < 0) & ~m
        sigma = np.std(resid, where=below) if below.any() else 0.0
        gain = np.exp(np.clip(it + 1, -exp_cap, exp_cap))
        arg = gain * (resid - 2 * sigma) * np.asarray(invert_no_zero(sigma))
        arg = np.clip(arg, -sqr_cap, sqr_cap)
        shrink = arg * np.asarray(invert_no_zero(np.hypot(1.0, arg)))
        return 0.5 * (1 - shrink)

    return penalized_least_squares_1d(y, _reweight, mask, lam, epsilon, max_iter)


def apply_hysteresis_threshold(image, low, high):
    """Hysteresis thresholding (skimage.filters.apply_hysteresis_threshold).

    Points above ``high`` are kept, plus any points above ``low`` connected
    (8-connectivity in 2D / full connectivity in nD) to a point above
    ``high``.
    """
    from scipy import ndimage

    image = np.asarray(image)
    mask_low = image > low
    mask_high = image > high

    structure = np.ones((3,) * image.ndim, dtype=bool)
    labels, num = ndimage.label(mask_low, structure=structure)
    if num == 0:
        return mask_high

    sums = np.bincount(labels.ravel(), weights=mask_high.ravel(), minlength=num + 1)
    good_label = sums > 0
    good_label[0] = False
    return good_label[labels]
def window_generalised(x, window: str = "nuttall"):
    """High-order apodisation windows at arbitrary locations in [0, 1].

    (tools.py:547; same window table.)
    """
    x = jnp.asarray(x)
    if window == "triangular":
        w = 1.0 - 2.0 * jnp.abs(x - 0.5)
    elif window.startswith("tukey"):
        r = float(window.split("-")[1])
        alpha = 0.5 * r
        w = jnp.ones_like(x)
        w = jnp.where(
            x < alpha, 0.5 * (1.0 + jnp.cos(jnp.pi * (x - alpha) / alpha)), w
        )
        w = jnp.where(
            x >= (1.0 - alpha),
            0.5 * (1.0 + jnp.cos(jnp.pi * (x - (1.0 - alpha)) / alpha)),
            w,
        )
    else:
        a = jnp.asarray(_COSINE_WINDOW_COEFFS[window], dtype=x.dtype)
        t = 2 * jnp.pi * jnp.arange(4)[:, None] * x.reshape(-1)[None, :]
        w = (a[:, None] * jnp.cos(t)).sum(axis=0).reshape(x.shape)
    return jnp.where((x >= 0) & (x <= 1), w, jnp.zeros_like(w))


# Generalised-cosine window coefficient table (a0..a3); values follow the
# standard published definitions of each window
_COSINE_WINDOW_COEFFS = {
    "uniform": (1.0, 0.0, 0.0, 0.0),
    "hann": (0.5, -0.5, 0.0, 0.0),
    "hamming": (0.53836, -0.46164, 0.0, 0.0),
    "blackman": (0.42, -0.5, 0.08, 0.0),
    "nuttall": (0.355768, -0.487396, 0.144232, -0.012604),
    "blackman_nuttall": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
    "blackman_harris": (0.35875, -0.48829, 0.14128, -0.01168),
}
_COSINE_WINDOW_COEFFS["hanning"] = _COSINE_WINDOW_COEFFS["hann"]


def correct_phase_wrap(phi, deg: bool = False):
    """Wrap phase into (-pi, pi] or (-180, 180] (tools.py:894)."""
    period = 180.0 if deg else np.pi
    phi = jnp.asarray(phi)
    return ((phi + period) % (2 * period)) - period


def taper_mask(mask, nwidth: int, outer: bool = False):
    """Taper a 2D mask along the last axis with a Hann kernel.

    (tools.py:844)
    """
    mask = jnp.atleast_2d(jnp.asarray(mask))
    width = 2 * nwidth - 1
    kernel = jnp.asarray(np.hanning(width))
    kernel = kernel / kernel.sum()

    tapered = jnp.zeros(
        (mask.shape[0], mask.shape[-1] + 2 * width), dtype=jnp.float64
    )
    tapered = tapered.at[:, width:-width].set(mask.astype(jnp.float64))
    tapered = tapered.at[:, :width].set(tapered[:, width][:, None])
    tapered = tapered.at[:, -width:].set(tapered[:, -width - 1][:, None])
    if outer:
        tapered = 1.0 - tapered

    def conv(x):
        return jax.vmap(
            lambda row: jnp.convolve(row, kernel, mode="same")
        )(x)

    tapered = jnp.isclose(conv(tapered), 1.0).astype(jnp.float64)
    tapered = conv(tapered)
    if outer:
        tapered = 1.0 - tapered
    return tapered[:, width:-width]


def find_contiguous_slices(index):
    """Convert indices into contiguous slices (tools.py:916)."""
    index = list(index)
    slices = []
    if not index:
        return slices
    start = prev = index[0]
    for x in index[1:]:
        if x == prev + 1:
            prev = x
            continue
        slices.append(slice(start, prev + 1))
        start = prev = x
    slices.append(slice(start, prev + 1))
    return slices


def device_to_numpy(x) -> np.ndarray:
    """Fetch a (possibly device) array to a host numpy array.

    Arrays spanning multiple processes (global ``jax.Array``s on a
    multi-host mesh) are first replicated — a compiled all-gather every
    process participates in — then read from the local replica.
    """
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.sharding import NamedSharding, PartitionSpec

        rep = NamedSharding(x.sharding.mesh, PartitionSpec())
        x = jax.jit(lambda a: a, out_shardings=rep)(x)
        x = x.addressable_data(0)  # fully replicated by now
    return np.asarray(x)


def numpy_to_device(x):
    """Put a host array on the default device."""
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x))


def as_device(x):
    """Return ``x`` as a device array; jax arrays pass through."""
    import jax
    import jax.numpy as jnp

    if isinstance(x, jax.Array):
        return x
    return jnp.asarray(np.asarray(x))


# -- exact fringe phases -----------------------------------------------------
#
# Fringe phases are periodic, so only frac(b . n) matters — but a plain
# f32 dot loses ~|b . n| * eps_f32 ABSOLUTE accuracy (2e-4 rad at
# u ~ 500 wavelengths), above the 1e-5 end-to-end budget.  Every fringe
# builder (fused round trip, streaming projections, beam-transfer
# generation) splits the f64 baselines and pixel vectors into three f32
# parts whose high products are exact, and reduces each term mod 1:
# frac error ~ eps_f32 regardless of baseline length.  Purely
# elementwise — XLA fuses it into the trig, leaving the GEMMs untouched.


def threefloat_split(a64: np.ndarray):
    """Split an f64 array into three f32 parts (12 + 12 + 24-bit mantissas).

    ``a64 ~= a + b + c`` with ``a``/``b`` carrying at most 12 significant
    bits each (the top and bottom halves of ``float32(a64)``'s mantissa)
    and ``c`` the f32 of the remainder.  Products of two 12-bit parts
    fit the 24-bit f32 significand EXACTLY, which makes downstream
    compensated phase arithmetic immune to compiler FMA contraction —
    XLA's CPU and GPU backends fuse ``mul``+``add`` pairs into FMAs,
    which silently breaks classic runtime Dekker/TwoSum schemes (an FMA
    result differs from the rounded product the compensation assumes),
    but cannot change the value of an exactly-representable product.
    """
    a64 = np.asarray(a64, dtype=np.float64)
    hi = a64.astype(np.float32)
    # mask the low 12 explicit mantissa bits -> <= 12 significant bits
    a = (hi.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    b = hi - a  # exact: the masked-off low bits, <= 12 significant bits
    c = (a64 - hi.astype(np.float64)).astype(np.float32)
    return a, b, c


def phase_frac3(ba, bb, bc, va, vb, vc):
    """``frac(b . n)`` from three-part operands (:func:`threefloat_split`).

    ba/bb/bc [..., 3] broadcast against va/vb/vc [K, 3] -> turns
    [..., K].  The six high products per component (a*a, a*b, b*a) are
    exact f32 values reduced mod 1 term by term; the remaining cross
    terms are ~2^-24 relative and summed directly.  Unlike a runtime
    Dekker split this is FMA-contraction-proof (see
    :func:`threefloat_split`), so it is bit-stable across the GPU and
    CPU backends.  Absolute error ~3e-7 turns independent of |b . n|.
    """
    y = None
    for x in range(3):
        b_a = ba[..., x][..., None]
        b_b = bb[..., x][..., None]
        b_c = bc[..., x][..., None]
        v_a = va[:, x]
        v_b = vb[:, x]
        v_c = vc[:, x]
        paa = b_a * v_a  # exact (12b x 12b)
        pab = b_a * v_b  # exact
        pba = b_b * v_a  # exact
        r = (paa - jnp.round(paa)) + (pab - jnp.round(pab))
        r = r + (pba - jnp.round(pba))
        small = b_b * v_b + (b_a * v_c + b_c * v_a) + (b_b * v_c + b_c * v_b)
        rc = r + small
        rc = rc - jnp.round(rc)  # keep the running sum near [-0.5, 0.5]
        y = rc if y is None else y + rc
    return y - jnp.round(y)


def sincos_turns(t):
    """(cos, sin) of ``2*pi*t`` for turns ``t`` already near [-0.5, 0.5].

    The fringe builders produce phases as fractional turns (the output
    of :func:`phase_frac3`), so the full argument reduction inside XLA's
    ``sin``/``cos`` is redundant.  This reduces to the nearest quarter
    turn and evaluates two short odd/even polynomials on the residual
    (|x| <= pi/4), then rotates by the quadrant with selects.  Max abs
    error ~1e-7 vs f64, well under the 1e-5 end-to-end budget.

    Safe for any finite ``t`` (the quarter-turn reduction is exact for
    the |t| <~ 1 range the callers produce).  float64 inputs (the CPU
    truth path) fall back to exact ``jnp.cos``/``jnp.sin`` so reference
    runs are not limited by the polynomial truncation.
    """
    if jnp.asarray(t).dtype == jnp.float64:
        ph = 2 * jnp.pi * t
        return jnp.cos(ph), jnp.sin(ph)
    q = jnp.round(4.0 * t)
    x = 2 * jnp.pi * (t - 0.25 * q)  # residual angle, |x| <= pi/4
    x2 = x * x
    # Taylor to x^8 / x^9: truncation < 3e-7 abs on [-pi/4, pi/4]
    c = 1.0 + x2 * (
        -0.5 + x2 * (1.0 / 24 + x2 * (-1.0 / 720 + x2 * (1.0 / 40320)))
    )
    s = x * (
        1.0
        + x2
        * (-1.0 / 6 + x2 * (1.0 / 120 + x2 * (-1.0 / 5040 + x2 / 362880)))
    )
    # rotate (c, s) by q quarter turns: q mod 4 in {0,1,2,3}
    qm = q - 4.0 * jnp.floor(q * 0.25)
    odd = (qm == 1.0) | (qm == 3.0)
    neg_c = (qm == 1.0) | (qm == 2.0)
    neg_s = (qm == 2.0) | (qm == 3.0)
    cos_v = jnp.where(odd, s, c)
    sin_v = jnp.where(odd, c, s)
    cos_v = jnp.where(neg_c, -cos_v, cos_v)
    sin_v = jnp.where(neg_s, -sin_v, sin_v)
    return cos_v, sin_v
