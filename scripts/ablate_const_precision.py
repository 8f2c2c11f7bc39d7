"""Which f32-stored constant family dominates the round-trip error?

Runs the production fused round trip on CPU x64 (f64 accumulation) with
each constant family selectively promoted to f64, against an exact f64
truth.  With f64 accumulation the remaining error is pure constant
quantization, so the family whose promotion collapses the error is the
one to carry as a two-float (hi, lo) pair on the device.

Families: lam (split Legendre + ring plan), band (windowed Legendre
band), window (Ecf/Esf DFT factors), beam (u_re/u_im products).

Usage: python scripts/ablate_const_precision.py [nside]
"""

from __future__ import annotations

import os
import sys

import numpy as np

# a CPU x64 study: never open an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "scripts"))

from check_accuracy_production import build_problem  # noqa: E402

from draco_tpu.ops import healpix, mmode, sht, sht_window  # noqa: E402
from draco_tpu.telescope import beamtransfer as btmod  # noqa: E402
from draco_tpu.telescope import roundtrip as rtmod  # noqa: E402

NSIDE = int(sys.argv[1]) if len(sys.argv) > 1 else 64
FEEDS = int(sys.argv[2]) if len(sys.argv) > 2 else 4


def truth_and_sky():
    tel, bt = build_problem(NSIDE, FEEDS)
    lmax = tel.lmax
    npix = healpix.npix_of(NSIDE)
    omega = 4 * np.pi / npix
    s = sht.get_sht(NSIDE, lmax)
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal(npix)
    u_idx, bprod = bt._beam_products(0)
    bprod = np.asarray(bprod)[:, 0]
    vec = np.asarray(healpix.pix2vec(NSIDE), np.float64)
    bl3 = tel.baseline_vectors_3d().astype(np.float64) / float(
        tel.wavelengths[0]
    )
    fringe = np.exp(2j * np.pi * (bl3 @ vec.T))
    bmap = bprod[u_idx] * fringe
    alm = s._analysis_impl(jnp.asarray(sky))
    ap = s._analysis_impl(jnp.asarray(bmap))
    ac = s._analysis_impl(jnp.asarray(np.conj(bmap)))
    bp = jnp.conj(ac) / omega
    bm = jnp.conj(ap) / omega
    vp = jnp.einsum("blm,lm->mb", bp, alm.astype(bp.dtype))
    vm = jnp.einsum("blm,lm->mb", bm, alm.astype(bm.dtype))
    vis = jnp.stack([vp, vm], 1)
    stream = mmode.mmodes_to_sidereal(vis, n=2 * lmax + 1, oddra=True)
    vis2 = mmode.make_marray(stream, mmax=lmax)
    a = jnp.einsum("blm,mb->lm", jnp.conj(bp), vis2[:, 0])
    a = a + jnp.einsum("blm,mb->lm", jnp.conj(bm), vis2[:, 1])
    m64 = np.asarray(s._synthesis_impl(a.astype(jnp.complex128)))
    return m64, sky


def run_with(promote: set[str], m64, sky):
    """Round-trip error with the families in ``promote`` stored f64."""
    orig_stream = btmod.BeamTransfer._streaming_ops2
    orig_lam = sht_window.WindowedSHT._ensure_lam
    orig_trig = sht_window.WindowedSHT.__dict__["_trig_f32"]
    orig_beam_prep = rtmod._beam_prep

    if "lam" in promote or "lamsplit" in promote or "plan" in promote:
        lam64 = "lam" in promote or "lamsplit" in promote
        plan64 = "lam" in promote or "plan" in promote

        def _streaming_ops2(self):
            if getattr(self, "_stream_ops2", None) is None:
                s = sht.get_sht(
                    self.beam_nside, self.telescope.lmax, self.telescope.mmax
                )
                lam = s.precompute_legendre_split(
                    jnp.float64 if lam64 else jnp.float32
                )
                plan = s.precompute_ring_plan(
                    jnp.complex128 if plan64 else jnp.complex64
                )
                self._stream_ops2 = (s, lam, None, plan)
            return self._stream_ops2

        btmod.BeamTransfer._streaming_ops2 = _streaming_ops2

    if "band" in promote:

        def _ensure_lam(self):
            if self._lam_band is None:
                s = self.sht
                parts = []
                for m_vals in s._m_chunks():
                    blk = s._legendre_block(m_vals, jnp.float64)
                    parts.append(jnp.take(blk, jnp.asarray(self.band), axis=2))
                self._lam_band = jnp.concatenate(parts, axis=1)
            return self._lam_band

        sht_window.WindowedSHT._ensure_lam = _ensure_lam

    if "window" in promote:

        @staticmethod
        def _trig_f64(phi_rows, m, w_rows):
            arg = phi_rows[..., None] * m
            w = w_rows[..., None]
            return np.cos(arg) * w, np.sin(arg) * w

        sht_window.WindowedSHT._trig_f32 = _trig_f64

    if "beam" in promote:

        def _beam_prep64(bt, nfreq, npad, nbase, gather, order=None):
            u_res, u_ims, uidx = [], [], None
            for fi in range(nfreq):
                u_idx, bprod = bt._beam_products(fi)
                bw = gather(bprod)
                u_res.append(bw.real)
                u_ims.append(bw.imag)
                uidx = u_idx
            uidx_pad = np.zeros(npad, np.int32)
            uidx_pad[:nbase] = (
                uidx if order is None else np.asarray(uidx)[order]
            )
            u_re_h = np.stack(u_res)
            u_im_h = np.stack(u_ims)
            uniform_real = u_re_h.shape[1] == 1 and not u_im_h.any()
            return u_re_h, u_im_h, uidx_pad, uniform_real

        rtmod._beam_prep = _beam_prep64

    try:
        tel, bt = build_problem(NSIDE, FEEDS)
        out = rtmod.fused_simulate_to_map(bt, sky[None, None])
        m = np.asarray(out)[0, 0]
        return np.abs(m - m64).max() / np.abs(m64).max()
    finally:
        btmod.BeamTransfer._streaming_ops2 = orig_stream
        sht_window.WindowedSHT._ensure_lam = orig_lam
        sht_window.WindowedSHT._trig_f32 = orig_trig
        rtmod._beam_prep = orig_beam_prep


def main():
    m64, sky = truth_and_sky()
    print("truth done", flush=True)
    configs = [
        {"lamsplit"},
        {"plan"},
        {"lamsplit", "band"},
    ]
    for promote in configs:
        rel = run_with(promote, m64, sky)
        name = "+".join(sorted(promote)) or "none"
        print(f"promote [{name:28s}] -> rel err {rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
