"""Per-m SVD filtering of m-modes.

Re-provides reference ``draco/analysis/svdfilter.py`` (SVDSpectrumEstimator:11,
SVDFilter:60, svd_em:148): global per-m SVD across (freq x msign*baseline)
to find and remove bright correlated modes, with EM infilling of masked
entries.

Device design: every m shares the [nfreq, 2*nstack] matrix shape, so the
per-m host loop of the reference becomes ONE batched device program —
``jnp.linalg.svd`` over the leading m axis, with the EM infilling
iterations unrolled inside the same jit.  The mode cuts (which depend on
the global maximum singular value across m) are a couple of reductions
and a masked reconstruction, so the whole filter is two device
dispatches instead of 2(mmax+1) host SVDs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers
from ..core.task import ContainerTask
from ..ops import tools


@functools.partial(jax.jit, static_argnames=("niter", "rank"))
def _svd_em_batched(A, mask, *, niter: int, rank: int):
    """EM-infilled SVD of a batch of equally-shaped matrices.

    A : [B, n, p] (real or complex); mask : [B, n, p] bool (True = missing).
    Returns ``(u, sig, vh)`` of the final EM iterate, batched over B.
    """
    iscomplex = jnp.iscomplexobj(A)

    def masked_median(x):
        """Per-batch median of the unmasked entries (0 if none)."""
        x = jnp.where(mask, jnp.nan, x)
        med = jnp.nanmedian(x.reshape(x.shape[0], -1), axis=-1)
        return jnp.nan_to_num(med)

    if iscomplex:
        fill = jax.lax.complex(
            masked_median(A.real), masked_median(A.imag)
        )
    else:
        fill = masked_median(A)
    A = jnp.where(mask, fill[:, None, None], A)

    def body(_, carry):
        A, _, _, _ = carry
        u, sig, vh = jnp.linalg.svd(A, full_matrices=False)
        low_rank = jnp.einsum(
            "bnk,bk,bkp->bnp", u[:, :, :rank], sig[:, :rank], vh[:, :rank]
        )
        A = jnp.where(mask, low_rank, A)
        return A, u, sig, vh

    k = min(A.shape[1], A.shape[2])
    u0 = jnp.zeros(A.shape[:2] + (k,), A.dtype)
    vh0 = jnp.zeros((A.shape[0], k, A.shape[2]), A.dtype)
    sig0 = jnp.zeros((A.shape[0], k), jnp.real(A).dtype)
    _, u, sig, vh = jax.lax.fori_loop(
        0, max(niter, 1), body, (A, u0, sig0, vh0)
    )
    return u, sig, vh


def svd_em(A, mask, niter: int = 5, rank: int = 5, full_matrices: bool = False):
    """SVD with missing entries via EM infilling (reference svdfilter.py:148).

    Single-matrix form; delegates to the batched device kernel.
    ``full_matrices`` is accepted for API parity but only the economy
    form is computed.
    """
    del full_matrices
    A = tools.as_device(np.asarray(A))
    mask = jnp.asarray(np.asarray(mask, dtype=bool))
    u, sig, vh = _svd_em_batched(
        A[None], mask[None], niter=niter, rank=rank
    )
    return (
        tools.device_to_numpy(u[0]),
        np.asarray(sig[0]),
        tools.device_to_numpy(vh[0]),
    )


def _mmode_matrices(mmodes):
    """Device views of MModes vis/mask as per-m matrices.

    vis [m, 2, f, b] -> A [m, f, 2b]; mask True where weight == 0.
    """
    vis = tools.as_device(np.asarray(mmodes.vis[:], dtype=np.complex64))
    weight = jnp.asarray(np.asarray(mmodes.weight[:], dtype=np.float32))
    M, _, F, B = vis.shape
    A = vis.transpose(0, 2, 1, 3).reshape(M, F, 2 * B)
    mask = (weight == 0.0).transpose(0, 2, 1, 3).reshape(M, F, 2 * B)
    return A, mask


class SVDSpectrumEstimator(ContainerTask):
    """Calculate the per-m SVD spectrum of m-modes (reference svdfilter.py:11)."""

    niter = config.int_prop(5)

    def process(self, mmodes):
        mmodes.redistribute("m")
        A, mask = _mmode_matrices(mmodes)
        nmode = min(A.shape[1], A.shape[2])

        spec = containers.SVDSpectrum(
            singularvalue=np.arange(nmode), axes_from=mmodes
        )
        _, sig, _ = _svd_em_batched(A, mask, niter=self.niter, rank=5)
        spec.spectrum[:] = tools.device_to_numpy(sig[:, :nmode])
        return spec


@functools.partial(jax.jit, static_argnames=("niter",))
def _svd_filter_device(A, mask, *, niter, global_threshold, local_threshold):
    """EM SVD + bright-mode cut + reconstruction, one program."""
    u, sig, vh = _svd_em_batched(A, mask, niter=niter, rank=5)
    sv_max = jnp.max(sig)
    # per-m cut: modes above either threshold (counts of a sorted-descending
    # spectrum, so a rank mask by index is equivalent to the count cut)
    global_cut = (sig > global_threshold * sv_max).sum(axis=-1)
    local_cut = (sig > local_threshold * sig[:, :1]).sum(axis=-1)
    cut = jnp.maximum(global_cut, local_cut)
    idx = jnp.arange(sig.shape[-1])
    sig_cut = jnp.where(idx[None] < cut[:, None], 0.0, sig)
    filtered = jnp.einsum("bnk,bk,bkp->bnp", u, sig_cut, vh)
    return filtered, sv_max


class SVDFilter(ContainerTask):
    """Remove the most correlated SVD modes per m (reference svdfilter.py:60).

    Attributes
    ----------
    niter : int
        EM iterations for masked values.
    local_threshold, global_threshold : float
        Cut modes above these fractions of the per-m / global maximum
        singular value.
    """

    niter = config.int_prop(5)
    global_threshold = config.float_prop(1e-3)
    local_threshold = config.float_prop(1e-2)

    def process(self, mmodes):
        mmodes.redistribute("m")
        A, mask = _mmode_matrices(mmodes)
        M, F, B2 = A.shape

        filtered, sv_max = _svd_filter_device(
            A,
            mask,
            niter=self.niter,
            global_threshold=self.global_threshold,
            local_threshold=self.local_threshold,
        )
        self.log.debug(
            "Largest singular value across all m: %.2g",
            float(np.asarray(sv_max)),
        )
        vis = tools.device_to_numpy(
            filtered.reshape(M, F, 2, B2 // 2).transpose(0, 2, 1, 3)
        )
        mmodes.vis[:] = vis.astype(mmodes.vis.dtype)
        return mmodes
