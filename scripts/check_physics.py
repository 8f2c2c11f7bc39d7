"""Engine-independent physics truth at the PRODUCTION shape.

The production accuracy check (``check_accuracy_production.py``) compares
the f32 fused path against THIS framework's own SHT at f64 — a shared
algorithmic error would cancel.  This script anchors the simulate spine
to physics computed WITHOUT the framework's SHT/beam-transfer code, at
nside=256 (the production shape):

* the sky is a sum of ~10 isolated (l, m) modes pixelised with SCIPY
  spherical harmonics (``sph_harm_y``) — l up to 600 (scipy's stable
  range at nside=256 polar colatitudes; NaN beyond ~650);
* truth visibilities are the direct f64 pixel sum
  ``V_b(ra) = Omega sum_pix beam_i beam_j* exp(2 pi i b.n/lambda)
  T(theta, phi + ra)`` with the sky rotated ANALYTICALLY
  (mode coefficients picking up exp(i m ra));
* truth m-modes are ``G_m[b] = Omega sum_pix BF_b (c Y_lm)`` and
  ``H_m[b] = Omega sum_pix BF_b conj(c Y_lm)`` per injected mode —
  compared against the engine's packed (m, +/-) visibilities
  (packing convention of reference draco/analysis/transform.py:644-705).

A conjugation, +-m packing, normalisation or rotation-direction error
anywhere in SHT / beam transfer / m-mode code breaks this at O(1); the
expected agreement is quadrature-limited (~1e-4..1e-3 relative).

Mirrors the role of the reference's healpy anchor
(/root/reference/draco/synthesis/stream.py:85).

Usage: python scripts/check_physics.py [--nside N] [--json]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

NSIDE = 256
if "--nside" in sys.argv:
    NSIDE = int(sys.argv[sys.argv.index("--nside") + 1])
EMIT_JSON = "--json" in sys.argv

# Isolated sky modes spanning the l/m band (l <= 600: scipy's stable
# evaluation range at production colatitudes).
MODES = [
    (0, 0),
    (6, 4),
    (33, 0),
    (50, 30),
    (150, 149),
    (201, 117),
    (300, 250),
    (420, 399),
    (520, 68),
    (600, 550),
    (600, 600),
]
N_RA_CHECK = 24  # RA samples to check the time-domain visibilities at


def main():
    import jax

    # Persistent XLA compile cache: the engine leg is compile-dominated
    # at small nside (~16 programs; 101 s cold vs <25 s warm on a CPU),
    # and the CI canary (tests/test_physics_canary.py) runs this script
    # on every suite run.
    from draco_tpu import enable_compile_cache

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

    from scipy.special import sph_harm_y

    from draco_tpu.core import containers
    from draco_tpu.ops import healpix
    from draco_tpu.synthesis.stream import SimulateSidereal
    from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray

    t_start = time.time()
    # Production-shape geometry at a truth-affordable feed count
    # (same family as check_accuracy_production.build_problem)
    f0 = 299.792458 / 0.6  # MHz
    tel = UnpolarisedDishArray(
        grid_ew=3,
        grid_ns=3,
        spacing_ew=7.0,
        spacing_ns=7.0,
        latitude=35.0,
        freq_lower=f0,
        freq_upper=f0 + 20.0,
        num_freq=1,
        dish_width=6.0,
        auto_correlations=True,
        force_lmax=3 * NSIDE - 1,
        force_mmax=3 * NSIDE - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=NSIDE)

    rng = np.random.Generator(np.random.SFC64(2024))
    modes = [(l, m) for (l, m) in MODES if l <= tel.lmax and m <= tel.mmax]
    coeff = {
        (l, m): (
            rng.standard_normal()
            + (1j * rng.standard_normal() if m > 0 else 0.0)
        )
        for (l, m) in modes
    }

    theta, phi = healpix.pix2ang(NSIDE)
    npix = theta.size
    omega = 4.0 * np.pi / npix

    # The scipy pixelisations are pure functions of (nside, modes) and
    # cost ~1 min at nside=256 — cache them on disk so the per-round
    # bench pays only the engine run and the pixel-sum truth.
    cache_dir = os.path.join(_REPO, ".jax_cache")
    mode_tag = "-".join(f"{l}_{m}" for l, m in modes)
    ypath = os.path.join(cache_dir, f"physics_Y_{NSIDE}_{mode_tag}.npz")
    Y = {}
    if os.path.exists(ypath):
        try:
            with np.load(ypath) as z:
                Y = {lm: z[f"{lm[0]}_{lm[1]}"] for lm in modes}
            print(f"[physics] loaded {len(Y)} cached scipy modes")
        except Exception:
            Y = {}
    if not Y:
        print(
            f"[physics] pixelising {len(modes)} scipy modes at nside={NSIDE}"
        )
        for l, m in modes:
            Ylm = sph_harm_y(l, m, theta, phi)
            if not np.isfinite(Ylm).all():
                raise RuntimeError(
                    f"scipy Y_{l}{m} not finite at nside={NSIDE}"
                )
            Y[(l, m)] = Ylm
        try:
            os.makedirs(cache_dir, exist_ok=True)
            np.savez(
                ypath, **{f"{l}_{m}": Y[(l, m)] for l, m in modes}
            )
        except Exception:
            pass
    sky = np.zeros(npix)
    for (l, m), c in coeff.items():
        sky += np.real(c * Y[(l, m)]) * (1.0 if m == 0 else 2.0)

    # --- engine path: the production streaming simulate spine ---------
    mcont = containers.Map(
        nside=NSIDE, polarisation=False, freq=tel.frequencies
    )
    mcont.map[:] = sky[np.newaxis, np.newaxis, :]
    sim = SimulateSidereal()
    sim.read_config({})
    sim.setup(bt)
    t0 = time.time()
    ss = sim.process(mcont)
    v_eng = np.asarray(ss.vis[:])[0].astype(np.complex128)  # [npairs, nra]
    t_eng = time.time() - t0
    ra = np.radians(np.asarray(ss.ra))
    npairs, nra = v_eng.shape
    print(f"[physics] engine sim: {npairs} pairs x {nra} ra in {t_eng:.1f}s")

    # --- truth: direct f64 pixel sums, no SHT anywhere ----------------
    lam = tel.wavelengths[0]
    vec = healpix.pix2vec(NSIDE)
    bl3 = tel.baseline_vectors_3d()
    pairs = tel.uniquepairs
    beams = {f: np.asarray(tel.beam(f, 0, NSIDE), np.float64) for f in set(pairs.ravel())}
    BF = np.stack(
        [
            beams[i]
            * np.conj(beams[j])
            * np.exp(2j * np.pi * (b @ vec.T) / lam)
            for (i, j), b in zip(pairs, bl3)
        ]
    )  # [npairs, npix] complex128

    # baseline integrals per azimuthal number m (modes sharing an m —
    # e.g. two m=0 entries — land in the same engine m-bin, so the
    # truth sums over them)
    G = {}  # coefficient of exp(+i m ra)
    H = {}  # coefficient of exp(-i m ra)
    for (l, m), c in coeff.items():
        cy = c * Y[(l, m)]
        G[m] = G.get(m, 0) + omega * (BF @ cy)
        H[m] = H.get(m, 0) + omega * (BF @ np.conj(cy))

    # time-domain check at a subset of RA samples
    k_check = np.linspace(0, nra - 1, N_RA_CHECK, dtype=int)
    m_set = sorted(G)
    v_truth = np.zeros((npairs, len(k_check)), dtype=np.complex128)
    for j, k in enumerate(k_check):
        for m in m_set:
            ph = np.exp(1j * m * ra[k])
            v_truth[:, j] += G[m] * ph
            if m > 0:
                v_truth[:, j] += H[m] * np.conj(ph)
    scale = np.abs(v_truth).max()
    err_vis = np.abs(v_eng[:, k_check] - v_truth).max() / scale

    # rotation-direction sanity: the opposite convention must NOT match
    v_flip = np.zeros_like(v_truth)
    for j, k in enumerate(k_check):
        for m in m_set:
            ph = np.exp(-1j * m * ra[k])
            v_flip[:, j] += G[m] * ph
            if m > 0:
                v_flip[:, j] += H[m] * np.conj(ph)
    err_flip = np.abs(v_eng[:, k_check] - v_flip).max() / scale

    # --- m-mode packing check -----------------------------------------
    from draco_tpu.analysis.transform import MModeTransform

    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)
    mvis = np.asarray(ma.vis[:]).astype(np.complex128)  # [m, 2, f, b]
    err_mm = 0.0
    mscale = max(np.abs(v[:]).max() for v in G.values())
    for m in m_set:
        g_eng = mvis[m, 0, 0]  # + part: coefficient of exp(+i m ra)
        h_eng = np.conj(mvis[m, 1, 0])  # - part stored conjugated
        err_mm = max(err_mm, np.abs(g_eng - G[m]).max() / mscale)
        if m > 0:
            err_mm = max(err_mm, np.abs(h_eng - H[m]).max() / mscale)

    # Measured: ~5e-6 for both checks at nside=256 (the pixel-sum
    # quadrature of band-limited products is near-exact at production
    # resolution); 5e-4 leaves two orders of headroom there while
    # catching any real convention or normalisation error at O(1).
    # Small test nsides are quadrature-limited (1.5e-3 at nside=32,
    # ~8e-3 at nside=16 — beam x fringe x sky exceeds the band limit).
    tol = 5e-4 if NSIDE >= 128 else (5e-3 if NSIDE >= 32 else 2e-2)
    ok = bool(err_vis < tol and err_mm < tol and err_flip > 0.05)
    result = {
        "nside": NSIDE,
        "npairs": int(npairs),
        "n_modes": len(modes),
        "max_l": int(max(l for l, _ in modes)),
        "max_m": int(max(m for _, m in modes)),
        "rel_err_vis": float(err_vis),
        "rel_err_mmode": float(err_mm),
        "flip_separation": float(err_flip),
        "tol": tol,
        "ok": ok,
        "total_s": round(time.time() - t_start, 1),
    }
    if EMIT_JSON:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"  {k}: {v}")
        print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
