"""End-to-end accuracy of the PRODUCTION fused round trip vs f64 truth.

This measures the library path a user actually runs:
``telescope.roundtrip.fused_simulate_to_map`` on a ``BeamTransfer`` built
from a real telescope model — including the three-float exact fringe
phases, the turns-based sincos, the beam-band window and the m-support
truncation.  The f64 truth is the mathematical spec of the round trip
(full-sphere, exact trig, complex128 SHT) evaluated from the SAME
telescope's beam products and baselines in a CPU x64 subprocess.

This is the measurement behind the north-star accuracy contract
(BASELINE.md: "matching CPU reference maps to 1e-5 relative error"; the
reference carries the spine in complex128 —
/root/reference/draco/core/containers.py:1178-1193).

Usage:  python scripts/check_accuracy_production.py [nside] [--feeds N]
        [--tol T] [--json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

# Arg parsing only applies when run as a script; the truth subprocess
# imports this module for build_problem() with its own argv.
NSIDE, FEEDS, TOL, EMIT_JSON = 64, 4, 1e-5, False
if __name__ == "__main__":
    _args = [a for a in sys.argv[1:] if not a.startswith("-")]
    NSIDE = int(_args[0]) if _args else 64
    FEEDS = 4  # feeds per side (4 -> 16 feeds, 136 pairs)
    if "--feeds" in sys.argv:
        FEEDS = int(sys.argv[sys.argv.index("--feeds") + 1])
    TOL = 1e-5
    if "--tol" in sys.argv:
        TOL = float(sys.argv[sys.argv.index("--tol") + 1])
    EMIT_JSON = "--json" in sys.argv


def build_problem(nside: int, nfeed_side: int):
    """The bench telescope geometry at a truth-affordable feed count."""
    from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray

    f0 = 299.792458 / 0.6  # MHz
    tel = UnpolarisedDishArray(
        grid_ew=nfeed_side,
        grid_ns=nfeed_side,
        spacing_ew=7.0,
        spacing_ns=7.0,
        jitter=1.0,
        jitter_seed=1,
        latitude=45.0,
        dish_width=5.0,
        fwhm_factor=1.0,
        freq_lower=f0,
        freq_upper=f0,
        num_freq=1,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    return tel, bt


# Truth: run in a CPU-only child process (JAX_PLATFORMS=cpu in its
# environment), so it never opens the GPU the calling process holds and
# the x64 switch cannot leak into the calling process.
_TRUTH_PROG = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

sys.path.insert(0, sys.argv[3])
from draco_tpu.ops import healpix, mmode, sht

out_path, nside = sys.argv[1], int(sys.argv[2])
import importlib
mod = importlib.import_module("check_accuracy_production")
tel, bt = mod.build_problem(nside, int(sys.argv[4]))

lmax = tel.lmax
npix = healpix.npix_of(nside)
omega = 4 * np.pi / npix
s = sht.get_sht(nside, lmax)

rng = np.random.Generator(np.random.SFC64(1))
sky = rng.standard_normal(npix)

# exact f64 fringe x beam maps from the telescope's own products
u_idx, bprod = bt._beam_products(0)           # [nuniq, npol, npix], omega in
bprod = np.asarray(bprod)[:, 0]               # unpolarised: npol == 1
vec = np.asarray(healpix.pix2vec(nside), np.float64)
bl3 = tel.baseline_vectors_3d().astype(np.float64) / float(tel.wavelengths[0])
fringe = np.exp(2j * np.pi * (bl3 @ vec.T))   # [nbase, npix] exact f64 trig
bmap = bprod[u_idx] * fringe

alm = s._analysis_impl(jnp.asarray(sky))
ap = s._analysis_impl(jnp.asarray(bmap))
ac = s._analysis_impl(jnp.asarray(np.conj(bmap)))
bp = jnp.conj(ac) / omega
bm = jnp.conj(ap) / omega
vp = jnp.einsum("blm,lm->mb", bp, alm.astype(bp.dtype))
vm = jnp.einsum("blm,lm->mb", bm, alm.astype(bm.dtype))
vis = jnp.stack([vp, vm], 1)
# the sidereal-stream round trip is the identity on the m-modes
stream = mmode.mmodes_to_sidereal(vis, n=2 * lmax + 1, oddra=True)
vis2 = mmode.make_marray(stream, mmax=lmax)
a = jnp.einsum("blm,mb->lm", jnp.conj(bp), vis2[:, 0])
a = a + jnp.einsum("blm,mb->lm", jnp.conj(bm), vis2[:, 1])
m64 = np.asarray(s._synthesis_impl(a.astype(jnp.complex128)))
np.savez(out_path, m64=m64, sky=sky)
"""


def f64_truth(nside: int, feeds: int) -> dict:
    """The f64 truth map and its input sky, from a CPU-only child."""
    with tempfile.TemporaryDirectory() as td:
        truth = os.path.join(td, "truth.npz")
        subprocess.run(
            [
                sys.executable,
                "-c",
                _TRUTH_PROG,
                truth,
                str(nside),
                os.path.join(_REPO, "scripts"),
                str(feeds),
            ],
            check=True,
            cwd=_REPO,
            env={**os.environ, "PYTHONPATH": _REPO, "JAX_PLATFORMS": "cpu"},
        )
        with np.load(truth) as z:
            return {k: z[k] for k in z.files}


def production_relerr(nside: int, feeds: int) -> float:
    """Max-norm relative error of the production fused path, run on
    this process's default device, against the f64 truth."""
    from draco_tpu.telescope.roundtrip import fused_simulate_to_map

    d = f64_truth(nside, feeds)
    _, bt = build_problem(nside, feeds)
    sky = d["sky"].astype(np.float32)[None, None]
    m32 = np.asarray(fused_simulate_to_map(bt, sky))[0, 0]
    return float(np.abs(m32 - d["m64"]).max() / np.abs(d["m64"]).max())


def main() -> int:
    print(
        f"computing f64 truth (nside={NSIDE}, {FEEDS * FEEDS} feeds) "
        "on CPU ...",
        file=sys.stderr,
    )
    t0 = time.time()
    d = f64_truth(NSIDE, FEEDS)
    print(f"truth done in {time.time() - t0:.1f}s", file=sys.stderr)

    import jax

    from draco_tpu.telescope.roundtrip import fused_simulate_to_map

    tel, bt = build_problem(NSIDE, FEEDS)
    sky = d["sky"].astype(np.float32)[None, None]

    print(f"running production fused path on {jax.devices()} ...",
          file=sys.stderr)
    t0 = time.time()
    m32 = np.asarray(fused_simulate_to_map(bt, sky))[0, 0]
    warm = time.time() - t0
    t0 = time.time()
    m32 = np.asarray(fused_simulate_to_map(bt, sky))[0, 0]
    steady = time.time() - t0

    rel = np.abs(m32 - d["m64"]).max() / np.abs(d["m64"]).max()
    win = bt._beam_window() is not None
    print(
        f"nside={NSIDE} feeds={FEEDS * FEEDS} windowed={win}: production "
        f"f32-vs-f64 relative error {rel:.3e}  (warm {warm:.1f}s, "
        f"steady {steady:.3f}s)"
    )
    ok = rel < TOL
    if EMIT_JSON:
        print(json.dumps({
            "nside": NSIDE,
            "feeds": FEEDS * FEEDS,
            "windowed": bool(win),
            "rel_err": float(f"{rel:.3e}"),
            "tol": TOL,
            "ok": bool(ok),
        }))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
