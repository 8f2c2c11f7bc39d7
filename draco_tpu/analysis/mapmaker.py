"""Map making from m-modes (the m-mode formalism inverse problem).

Re-provides reference ``draco/analysis/mapmaker.py`` (BaseMapMaker:11,
DirtyMapMaker:143, MaximumLikelihoodMapMaker:171, WienerMapMaker:204,
pinv_svd:287).

Device design: the reference's nested per-m / per-freq solve loop
(reference mapmaker.py:79-94) becomes m-chunked *batched* linear algebra —
one batched einsum for the dirty map, batched SVD pseudo-inverses for ML,
and batched HPD solves (dual form chosen by ntel vs nsky, reference
mapmaker.py:266-278) for the Wiener map — followed by a single batched
inverse SHT.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import sht, tools
from ..ops.tools import find_keys


class BaseMapMaker(ContainerTask):
    """m-mode map maker base (reference mapmaker.py:11).

    Attributes
    ----------
    nside : int
        Resolution of the output HEALPix map.
    m_chunk : int
        Number of m values per batched solve (memory/throughput knob).
    """

    nside = config.int_prop(256)
    m_chunk = config.int_prop(32)
    # Use the streaming (factorised) projection: the beam-transfer tensors
    # are never materialised — required when nbase x lmax x mmax exceeds
    # device memory.  Supported by the dirty map maker.
    streaming = config.bool_prop(False)
    baseline_chunk = config.int_prop(256)

    # Only makers that implement a factorised (never-materialised)
    # projection support streaming; others must fail loudly instead of
    # skipping bt.generate() and crashing deep in the solve.
    _supports_streaming = False

    def setup(self, bt):
        """Set the beam transfer matrices (BeamTransfer or ProductManager)."""
        self.beamtransfer = io.get_beamtransfer(bt)

    def process(self, mmodes: containers.MModes) -> containers.Map:
        """Make a map from m-mode visibilities."""
        bt = self.beamtransfer
        if self.streaming and not self._supports_streaming:
            raise RuntimeError(
                f"{type(self).__name__} does not support streaming "
                "map-making (only the dirty-map adjoint factorises); "
                "unset `streaming` or use DirtyMapMaker."
            )
        if not self.streaming:
            bt.generate()
        tel = bt.telescope
        lmax = tel.lmax
        mmax = min(tel.mmax, len(mmodes.index_map["m"]) - 1)
        nfreq = len(mmodes.index_map["freq"])
        npol = tel.num_pol_sky

        # Map frequencies onto the beam transfer channels
        bt_freq = tel.frequencies
        mm_freq = mmodes.index_map["freq"]["centre"]
        freq_ind = find_keys(bt_freq, mm_freq, require_match=True)

        # collective-safe host pulls: process-spanning global arrays
        # gather through a compiled all-gather every process runs
        vis = tools.device_to_numpy(mmodes.vis[:])[: mmax + 1]
        weight = tools.device_to_numpy(mmodes.weight[:])[: mmax + 1]
        # [m, msign, freq, stack] -> [m, msign, freq, nbase]
        nbase = tel.npairs
        vis = vis.reshape(mmax + 1, 2, nfreq, nbase)
        weight = weight.reshape(mmax + 1, 2, nfreq, nbase)

        alm = self._solve_all_m(vis, weight, freq_ind, mmax)

        # Pad the m axis to the full lmax+1 and synthesise maps
        if alm.shape[-1] < lmax + 1:
            alm = jnp.pad(alm, ((0, 0),) * 3 + ((0, lmax + 1 - alm.shape[-1]),))
        maps = sht.sphtrans_inv_sky(alm, self.nside)

        m = containers.Map(
            nside=self.nside,
            polarisation=npol == 4,
            axes_from=mmodes,
            attrs_from=mmodes,
        )
        m.map[:] = tools.device_to_numpy(maps)
        return m

    # -- solver helpers ----------------------------------------------------
    def _bt_tensors(self, freq_ind):
        """Bp/Bm tensors channel-matched: [nfreq, nbase, npol, L+1, M+1]."""
        bt = self.beamtransfer
        fsel = jnp.asarray(np.asarray(freq_ind, dtype=int))
        return bt._bp[fsel], bt._bm[fsel]

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        """Return alm [nfreq, npol, lmax+1, mmax+1]; override per maker."""
        raise NotImplementedError

    def _m_chunks(self, mmax):
        for m0 in range(0, mmax + 1, self.m_chunk):
            yield m0, min(m0 + self.m_chunk, mmax + 1)


class DirtyMapMaker(BaseMapMaker):
    r"""Dirty map: :math:`\hat{a} = B^\dagger N^{-1} v`.

    (reference mapmaker.py:143-168) — a single batched adjoint einsum.
    """

    _supports_streaming = True

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        if self.streaming:
            tel = self.beamtransfer.telescope
            if list(np.asarray(freq_ind)) != list(range(tel.nfreq)):
                raise ValueError(
                    "streaming map-making requires the m-mode frequencies "
                    "to match the telescope channels exactly"
                )
            vis = np.asarray(vis)
            weight = np.asarray(weight)
            pad_m = tel.mmax - mmax
            if pad_m > 0:
                vis = np.pad(vis, ((0, pad_m),) + ((0, 0),) * 3)
                weight = np.pad(weight, ((0, pad_m),) + ((0, 0),) * 3)
            alm = self.beamtransfer.project_telescope_to_sky_dirty_streaming(
                vis, weight, chunk=self.baseline_chunk
            )
            return alm[..., : mmax + 1]
        bp, bm = self._bt_tensors(freq_ind)

        vis = np.asarray(vis)
        return _dirty_adjoint(
            mmax,
            bp,
            bm,
            jnp.asarray(np.ascontiguousarray(vis.real, dtype=np.float32)),
            jnp.asarray(np.ascontiguousarray(vis.imag, dtype=np.float32)),
            jnp.asarray(np.asarray(weight, dtype=np.float32)),
        )


@functools.partial(jax.jit, static_argnums=(0,))
def _dirty_adjoint(mmax, bp, bm, v_r, v_i, w):
    """Noise-weighted adjoint over all m at once.

    Module-scope jit (a per-call closure recompiled every container).
    """
    wv = jax.lax.complex(v_r, v_i) * w
    bp = bp[..., : mmax + 1]
    bm = bm[..., : mmax + 1]
    a = jnp.einsum("fbplm,mfb->fplm", jnp.conj(bp), wv[:, 0].astype(bp.dtype))
    a += jnp.einsum("fbplm,mfb->fplm", jnp.conj(bm), wv[:, 1].astype(bm.dtype))
    return a


def pinv_svd(M, acond: float = 1e-4, rcond: float = 1e-3):
    """SVD pseudo-inverse with the reference's dual threshold.

    (reference mapmaker.py:287-300): singular values kept where
    s > rcond * s_max AND s > acond.  Batched over leading dims.
    """
    M = jnp.asarray(M)
    u, s, vh = jnp.linalg.svd(M, full_matrices=False)
    smax = jnp.max(s, axis=-1, keepdims=True)
    keep = (s > rcond * smax) & (s > acond)
    s_inv = jnp.where(keep, 1.0 / jnp.where(keep, s, 1.0), 0.0)
    # pinv = V s^-1 U^H
    return jnp.swapaxes(jnp.conj(vh), -1, -2) @ (
        s_inv[..., :, None] * jnp.swapaxes(jnp.conj(u), -1, -2)
    )


@functools.partial(
    jax.jit, static_argnames=("mc", "dims", "acond", "rcond")
)
def _ml_chunk(bp, bm, vis, weight, m0, *, mc, dims, acond, rcond):
    """One m-chunk of the ML solve (module-scope jit: an inner-function
    jit would retrace and recompile on every task invocation —
    round-4 advisor finding)."""
    nfreq, nbase, npol, L1 = dims
    nsky = npol * L1
    bpc = jax.lax.dynamic_slice_in_dim(bp, m0, mc, axis=-1)
    bmc = jax.lax.dynamic_slice_in_dim(bm, m0, mc, axis=-1)
    B = jnp.concatenate([bpc, bmc], axis=1)  # [f, ntel, p, L1, mc]
    B = jnp.moveaxis(B, -1, 0).reshape(mc, nfreq, 2 * nbase, nsky)
    vc = jax.lax.dynamic_slice_in_dim(vis, m0, mc, axis=0)
    wc = jax.lax.dynamic_slice_in_dim(weight, m0, mc, axis=0)
    v = jnp.moveaxis(vc, 1, 2).reshape(mc, nfreq, 2 * nbase)
    Ni = jnp.moveaxis(wc, 1, 2).reshape(mc, nfreq, 2 * nbase)
    Nh = jnp.sqrt(Ni).astype(B.dtype)
    ib = pinv_svd(B * Nh[..., None], acond=acond, rcond=rcond)
    a = jnp.einsum("mfst,mft->mfs", ib, (Nh * v).astype(ib.dtype))
    return a.reshape(mc, nfreq, npol, L1)


@jax.jit
def _concat_moveaxis(parts):
    return jnp.moveaxis(jnp.concatenate(parts, axis=0), 0, -1)


class MaximumLikelihoodMapMaker(BaseMapMaker):
    r"""ML map: :math:`\hat{a} = (N^{-1/2}B)^+ N^{-1/2} v`.

    (reference mapmaker.py:171-201) — m-chunked batched SVD pseudo-inverses.

    Attributes
    ----------
    acond, rcond : float
        Absolute and relative singular-value cuts of the pseudo-inverse
        (reference defaults, mapmaker.py:287).
    """

    acond = config.float_prop(1e-4)
    rcond = config.float_prop(1e-3)

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        bp, bm = self._bt_tensors(freq_ind)
        nfreq, nbase, npol, L1 = bp.shape[:4]

        from ..ops import tools as _tools

        vis_d = _tools.as_device(vis)
        weight_d = _tools.as_device(weight)
        out = [
            _ml_chunk(
                bp, bm, vis_d, weight_d, m0,
                mc=m1 - m0,
                dims=(nfreq, nbase, npol, L1),
                acond=self.acond,
                rcond=self.rcond,
            )
            for m0, m1 in self._m_chunks(mmax)
        ]
        return _concat_moveaxis(out)  # [f, p, L1, M+1]


class WienerMapMaker(BaseMapMaker):
    r"""Wiener map with a power-law signal prior.

    :math:`\hat{a} = (S^{-1} + B^\dagger N^{-1} B)^{-1} B^\dagger N^{-1} v`
    (reference mapmaker.py:204-284).  The ``l < m`` block of B is zero so
    the prior regularises it to zero automatically — no per-m trimming is
    needed and the solves stay uniform for batching (SURVEY.md 'hard parts'
    (a)).  The dual (telescope-space) form is used when nsky > ntel.

    Attributes
    ----------
    prior_amp, prior_tilt : float
        Power-law prior: C_l = prior_amp^2 * l^(-prior_tilt).
    """

    prior_amp = config.float_prop(1.0)
    prior_tilt = config.float_prop(0.5)

    def _solve_all_m(self, vis, weight, freq_ind, mmax):
        bt = self.beamtransfer
        tel = bt.telescope
        bp, bm = self._bt_tensors(freq_ind)
        nfreq, nbase, npol, L1 = bp.shape[:4]
        nsky = npol * L1
        ntel = 2 * nbase

        ell = np.arange(L1)
        ell[0] = 1
        cl_TT = self.prior_amp**2 * ell.astype(float) ** (-self.prior_tilt)
        S_diag = jnp.asarray(np.tile(cl_TT, npol))  # [nsky]
        Si_diag = 1.0 / S_diag

        from ..ops import tools as _tools

        vis_d = _tools.as_device(vis)
        weight_d = _tools.as_device(weight)
        out = [
            _wiener_chunk(
                bp, bm, vis_d, weight_d, S_diag, Si_diag, m0,
                mc=m1 - m0,
                dims=(nfreq, nbase, npol, L1),
            )
            for m0, m1 in self._m_chunks(mmax)
        ]
        return _wiener_combine(out, L1=L1)


@functools.partial(jax.jit, static_argnames=("mc", "dims"))
def _wiener_chunk(bp, bm, vis, weight, S_diag, Si_diag, m0, *, mc, dims):
    """One m-chunk of the Wiener solve (module-scope jit — see
    :func:`_ml_chunk` for why)."""
    nfreq, nbase, npol, L1 = dims
    nsky = npol * L1
    ntel = 2 * nbase
    bpc = jax.lax.dynamic_slice_in_dim(bp, m0, mc, axis=-1)
    bmc = jax.lax.dynamic_slice_in_dim(bm, m0, mc, axis=-1)
    B = jnp.concatenate([bpc, bmc], axis=1)
    B = jnp.moveaxis(B, -1, 0).reshape(mc, nfreq, ntel, nsky)
    vc = jax.lax.dynamic_slice_in_dim(vis, m0, mc, axis=0)
    wc = jax.lax.dynamic_slice_in_dim(weight, m0, mc, axis=0)
    v = jnp.moveaxis(vc, 1, 2).reshape(mc, nfreq, ntel)
    Ni = jnp.moveaxis(wc, 1, 2).reshape(mc, nfreq, ntel)
    Nh = jnp.sqrt(Ni).astype(B.dtype)

    Bt = B * Nh[..., None]  # pre-whitened beam
    vt = (Nh * v.astype(B.dtype))

    if ntel > nsky:
        # primal: (S^-1 + B^H B) a = B^H v
        BhB = jnp.einsum("mfts,mftr->mfsr", jnp.conj(Bt), Bt)
        Ci = BhB + jnp.diag(Si_diag.astype(B.dtype))[None, None]
        rhs = jnp.einsum("mfts,mft->mfs", jnp.conj(Bt), vt)
        a = jnp.linalg.solve(Ci, rhs[..., None])[..., 0]
    else:
        # dual: a = S B^H (I + B S B^H)^-1 v
        BS = Bt * S_diag[None, None, None, :].astype(B.dtype)
        pCi = jnp.einsum("mfts,mfrs->mftr", BS, jnp.conj(Bt))
        pCi = pCi + jnp.eye(ntel, dtype=B.dtype)[None, None]
        v_int = jnp.linalg.solve(pCi, vt[..., None])[..., 0]
        a = S_diag[None, None].astype(B.dtype) * jnp.einsum(
            "mfts,mft->mfs", jnp.conj(Bt), v_int
        )
    return a.reshape(mc, nfreq, npol, L1)


@functools.partial(jax.jit, static_argnames=("L1",))
def _wiener_combine(parts, *, L1):
    a_all = jnp.concatenate(parts, axis=0)
    # zero the l < m block explicitly (it is prior-suppressed but
    # tiny numerical leakage is removed for exact parity)
    M1 = a_all.shape[0]
    lgrid = jnp.arange(L1)[None, :]
    mgrid = jnp.arange(M1)[:, None]
    mask = (lgrid >= mgrid)[:, None, None, :]
    return jnp.moveaxis(a_all * mask, 0, -1)
