"""Run draco_tpu's main path once on an NVIDIA GPU and check every result.

Usage::

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: only the sharded paths

Phases, in order, one output line each:

1. ``device``: the card (``nvidia-smi`` name and power limit), JAX's view
   of it, versions, ``XLA_FLAGS``, the compile-cache directory and whether
   PyYAML and h5py are installed.
2. ``roundtrip_windowed``: the fused simulate -> map program (the
   :class:`~draco_tpu.telescope.roundtrip.SimulateAndMap` task) for 64
   jittered 5 m dishes (2017 unique pairs) at nside 256, lmax = mmax =
   767, one frequency near 500 MHz; compared with an independent float64
   evaluation of the round trip (:func:`f64_roundtrip`) and with the
   composed streaming stages, both run on the same card.
3. ``roundtrip_fullsphere``: the non-windowable cylinder program on the
   4 x 256-feed unpolarised geometry (1789 stacked pairs) at nside 256,
   against an independent float64 evaluation of the round trip
   (:func:`f64_roundtrip`) on the same card.
4. ``accuracy_f64``: the production fused path at nside 64 against f64
   truth from a CPU-only child process (the 1e-5 science contract).
5. ``pipeline``: the composite chain (sky -> SimulateSidereal -> gains ->
   Wishart noise -> m-modes -> dirty map) for 64 dishes at nside 64,
   driven by a :class:`~draco_tpu.core.pipeline.Manager` built from a
   dict, against the same chain without noise.
6. ``delay_gibbs``: the batched-Cholesky delay Gibbs chain at 128
   baselines x 1024 delays x 10 iterations, against the host sampler's
   statistics.

``--four-gpus`` runs phase 2's configuration with 8 frequencies
frequency-sharded over a 4-GPU mesh against the same frequencies on one
GPU, and phase 5 with ``mesh: {freq: -1}`` against the chain without a
mesh.

A failed phase raises, so the script exits non-zero and never prints the
last line.  The last line of a passing run is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Times printed
are smoke readings of single runs on the named card, not benchmark
numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))
# JAX's own compile events; counted to prove a steady window compiles
# nothing (a persistent-cache load counts too).
_COMPILE_EVENTS = (
    "/jax/core/compile/backend_compile_duration",
    "/jax/compilation_cache/cache_retrieval_time_sec",
)


class SmokeFailure(RuntimeError):
    """A phase's result missed its bound."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _relerr(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    _check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    _check(bool(np.isfinite(got).all()), "non-finite output")
    return float(np.abs(got - want).max() / np.abs(want).max())


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class _CompileCounter:
    """Counts JAX compile events while active (a context manager)."""

    def __init__(self):
        import jax.monitoring

        self.n = 0
        self._on = False
        jax.monitoring.register_event_duration_secs_listener(self._listen)

    def _listen(self, event, duration, **kwargs):
        if self._on and event in _COMPILE_EVENTS:
            self.n += 1

    def __enter__(self):
        self.n = 0
        self._on = True
        return self

    def __exit__(self, *exc):
        self._on = False


_COUNTER = None


def _steady(fn, nrun: int) -> dict:
    """Median of ``nrun`` calls of ``fn`` and the compiles among them."""
    global _COUNTER
    if _COUNTER is None:
        _COUNTER = _CompileCounter()
    times = []
    with _COUNTER as counter:
        for _ in range(nrun):
            t0 = time.perf_counter()
            fn().block_until_ready()
            times.append(time.perf_counter() - t0)
    return {"steady_median_s": float(np.median(times)),
            "steady_compiles": counter.n}


# -- telescopes --------------------------------------------------------------

F0_MHZ = 299.792458 / 0.6  # lambda ~ 0.6 m


def dish_array(nside: int, nfeed_side: int, nfreq: int = 1):
    """Jittered square dish array (the benchmark's headline geometry)."""
    from draco_tpu.telescope import UnpolarisedDishArray

    half_bw = 0.05 * F0_MHZ * max(nfreq - 1, 0) / max(nfreq, 1)
    return UnpolarisedDishArray(
        grid_ew=nfeed_side,
        grid_ns=nfeed_side,
        spacing_ew=7.0,
        spacing_ns=7.0,
        jitter=1.0,
        jitter_seed=1,
        latitude=45.0,
        dish_width=5.0,
        fwhm_factor=1.0,
        freq_lower=F0_MHZ - half_bw,
        freq_upper=F0_MHZ + half_bw,
        num_freq=nfreq,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )


def cylinder_array(nside: int, ncyl: int, nfeed: int):
    """Unpolarised cylinders (examples/chime_scale.yaml's instrument class)."""
    from draco_tpu.telescope import UnpolarisedCylinderTelescope

    return UnpolarisedCylinderTelescope(
        num_cylinders=ncyl,
        cylinder_width=20.0,
        cylinder_spacing=22.0,
        num_feeds=nfeed,
        feed_spacing=0.5,
        latitude=49.0,
        freq_lower=F0_MHZ,
        freq_upper=F0_MHZ,
        num_freq=1,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )


def _product_dir(tel, root: str) -> str:
    """A product directory holding only the telescope (what
    ``LoadBeamTransfer`` needs when the beam transfers stream)."""
    path = os.path.join(root, "bt")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "telescope.pkl"), "wb") as f:
        pickle.dump(tel, f)
    return path


def composed_roundtrip(bt, sky):
    """The plain reference: the round trip as separate streaming stages."""
    import jax.numpy as jnp

    from draco_tpu.ops import healpix, mmode, sht

    tel = bt.telescope
    alm = sht.sphtrans_sky(jnp.asarray(sky), lmax=tel.lmax)[..., : tel.mmax + 1]
    vis_m = bt.project_sky_to_telescope_streaming(alm)
    stream = mmode.mmodes_to_sidereal(vis_m, n=2 * tel.mmax + 1, oddra=True)
    vis2 = np.asarray(mmode.make_marray(stream, mmax=tel.mmax))
    a = bt.project_telescope_to_sky_dirty_streaming(
        vis2, np.ones_like(vis2.real)
    )
    return np.asarray(sht.sphtrans_inv_sky(a, healpix.nside_of(sky.shape[-1])))


def f64_roundtrip(bt, sky, chunk: int = 64):
    """Independent f64 reference of the (unit-weight) round trip.

    The mathematical spec evaluated directly in float64 on the current
    device: exact fringes ``exp(2 pi i b.n)`` times the telescope's own
    beam products, a complex128 SHT with a float64 Legendre tensor, the
    dense beam-transfer projection and its adjoint, accumulated over
    baseline chunks.  (The truth program of
    ``scripts/check_accuracy_production.py``, streamed so that it fits
    at nside 256.)  Unpolarised telescopes only.
    """
    import jax
    import jax.numpy as jnp

    from draco_tpu.ops import healpix, mmode, sht

    tel = bt.telescope
    _check(tel.num_pol_sky == 1, "f64 reference is unpolarised only")
    nside = bt.beam_nside
    omega = 4 * np.pi / healpix.npix_of(nside)
    u_idx, bprod = bt._beam_products(0)
    bprod = np.concatenate(  # an all-zero product for padded baselines
        [np.asarray(bprod)[:, 0], np.zeros((1, bprod.shape[-1]))]
    )
    nbase = len(u_idx)
    chunk = min(chunk, nbase)
    npad = -(-nbase // chunk) * chunk
    uidx = np.full(npad, len(bprod) - 1)
    uidx[:nbase] = u_idx
    bl = np.zeros((npad, 3))
    bl[:nbase] = tel.baseline_vectors_3d() / float(tel.wavelengths[0])
    vec = np.asarray(healpix.pix2vec(nside), np.float64)
    s = sht.get_sht(nside, tel.lmax, tel.mmax)

    with jax.enable_x64(True):
        lam = s.precompute_legendre(jnp.float64)
        alm = jax.jit(lambda x, lam: s._analysis_impl(x, lam=lam))(
            jnp.asarray(np.asarray(sky, np.float64)), lam
        )

        @jax.jit
        def adjoint_chunk(a, bl_c, uidx_c, bprod, vec, lam, alm):
            bmap = bprod[uidx_c] * jnp.exp(2j * np.pi * (bl_c @ vec.T))
            bp = jnp.conj(s._analysis_impl(jnp.conj(bmap), lam=lam)) / omega
            bm = jnp.conj(s._analysis_impl(bmap, lam=lam)) / omega
            vis = jnp.stack([jnp.einsum("blm,lm->mb", bp, alm),
                             jnp.einsum("blm,lm->mb", bm, alm)], 1)
            # the sidereal-stream round trip (identity but for m = 0)
            vis = mmode.make_marray(
                mmode.mmodes_to_sidereal(vis, n=2 * tel.mmax + 1,
                                         oddra=True),
                mmax=tel.mmax,
            )
            return (a + jnp.einsum("blm,mb->lm", jnp.conj(bp), vis[:, 0])
                    + jnp.einsum("blm,mb->lm", jnp.conj(bm), vis[:, 1]))

        a = jnp.zeros(alm.shape[-2:], jnp.complex128)
        consts = (jnp.asarray(bprod), jnp.asarray(vec), lam, alm)
        for b0 in range(0, npad, chunk):
            a = adjoint_chunk(a, jnp.asarray(bl[b0:b0 + chunk]),
                              jnp.asarray(uidx[b0:b0 + chunk]), *consts)
        return np.asarray(
            jax.jit(lambda a, lam: s._synthesis_impl(a, lam=lam))(a, lam)
        )


# -- phases ------------------------------------------------------------------


def phase_device() -> dict:
    """What the run is on; fails when ``nvidia-smi`` cannot read the card."""
    import jax
    import jaxlib

    from draco_tpu import enable_compile_cache

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = jax.devices()[0]
    return {
        "nvidia_smi": smi.splitlines(),
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": enable_compile_cache(),
        "yaml": importlib.util.find_spec("yaml") is not None,
        "h5py": importlib.util.find_spec("h5py") is not None,
    }


def phase_windowed(nside=256, nfeed_side=8, chunk=520, nrun=3,
                   tol=2e-5, composed_tol=1e-4) -> dict:
    """The SimulateAndMap task vs the f64 reference and the composed stages.

    The bound ``tol`` holds against :func:`f64_roundtrip`.  The composed
    streaming stages are f32 themselves and the less accurate of the
    two paths (~6e-6 from f64 truth at nside 64 where the fused program
    is ~4e-7), so they get a looser bound that still catches a wrong
    path.  The task runs through its own ``setup``/``process``: a
    product directory records no beam nside, and ``LoadBeamTransfer``
    would derive 2 * nside from lmax = 3 * nside - 1.
    """
    from draco_tpu.core import containers
    from draco_tpu.ops import healpix
    from draco_tpu.telescope import BeamTransfer
    from draco_tpu.telescope.roundtrip import (
        SimulateAndMap,
        fused_simulate_to_map,
    )

    tel = dish_array(nside, nfeed_side)
    bt = BeamTransfer(telescope=tel, nside=nside)
    _check(bt._beam_window() is not None, "dish beam did not window")
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal((1, 1, healpix.npix_of(nside))).astype(np.float32)
    sky_map = containers.Map(nside=nside, polarisation=False,
                             freq=tel.frequencies)
    sky_map.map[:] = sky
    sky = np.asarray(sky_map.map[:])  # what the task sees
    task = SimulateAndMap()
    task.read_config({"baseline_chunk": chunk})
    task.setup(bt)
    t0 = time.perf_counter()
    got = np.asarray(task.process(sky_map).map[:])
    out = {"npairs": len(tel.uniquepairs), "nside": nside,
           "first_call_s": time.perf_counter() - t0}
    out.update(_steady(lambda: fused_simulate_to_map(bt, sky, chunk=chunk),
                       nrun))
    _check(out["steady_compiles"] == 0,
           f"{out['steady_compiles']} compiles in the steady window")
    out["peak_bytes"] = _peak_bytes()
    t0 = time.perf_counter()
    want = f64_roundtrip(bt, sky[0, 0])
    out["reference_s"] = time.perf_counter() - t0
    out["relerr"] = _relerr(got[0, 0], want)
    out["bound"] = tol
    _check(out["relerr"] <= tol, f"relerr {out['relerr']:.3e} > {tol}")
    out["composed_relerr"] = _relerr(got, composed_roundtrip(bt, sky))
    out["composed_bound"] = composed_tol
    _check(out["composed_relerr"] <= composed_tol,
           f"vs composed stages {out['composed_relerr']:.3e} > {composed_tol}")
    return out


def phase_fullsphere(nside=256, ncyl=4, nfeed=256, chunk=256, nrun=3,
                     tol=3e-5) -> dict:
    """The full-sphere cylinder program vs the f64 reference.

    The composed streaming stages are no reference here: for cylinders
    they sit ~1e-4 from f64 truth already at nside 64, while the fused
    program sits ~1e-6 from it.
    """
    from draco_tpu.ops import healpix
    from draco_tpu.telescope import BeamTransfer
    from draco_tpu.telescope.roundtrip import fused_simulate_to_map

    tel = cylinder_array(nside, ncyl, nfeed)
    bt = BeamTransfer(telescope=tel, nside=nside)
    _check(bt._beam_window() is None, "cylinder beam unexpectedly windowed")
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal((1, 1, healpix.npix_of(nside))).astype(np.float32)
    t0 = time.perf_counter()
    got = fused_simulate_to_map(bt, sky, chunk=chunk)
    got.block_until_ready()
    out = {"npairs": len(tel.uniquepairs), "nside": nside,
           "first_call_s": time.perf_counter() - t0}
    out.update(_steady(lambda: fused_simulate_to_map(bt, sky, chunk=chunk),
                       nrun))
    _check(out["steady_compiles"] == 0,
           f"{out['steady_compiles']} compiles in the steady window")
    out["peak_bytes"] = _peak_bytes()
    t0 = time.perf_counter()
    want = f64_roundtrip(bt, sky[0, 0])
    out["reference_s"] = time.perf_counter() - t0
    out["relerr"] = _relerr(np.asarray(got)[0, 0], want)
    out["bound"] = tol
    _check(out["relerr"] <= tol, f"relerr {out['relerr']:.3e} > {tol}")
    return out


def phase_accuracy(nside=64, feeds=4, tol=1e-5) -> dict:
    """The production fused path against f64 truth (CPU-only child)."""
    sys.path.insert(0, os.path.join(_REPO, "scripts"))
    import check_accuracy_production as cap

    t0 = time.perf_counter()
    rel = cap.production_relerr(nside, feeds)
    _check(rel <= tol, f"relerr {rel:.3e} > {tol}")
    return {"nside": nside, "feeds": feeds * feeds, "relerr": rel,
            "bound": tol, "seconds": time.perf_counter() - t0,
            "peak_bytes": _peak_bytes()}


def pipeline_config(product_dir: str, nside: int, nfreq: int,
                    noise_seed: int | None, mesh: bool = False) -> dict:
    """The composite chain; ``noise_seed=None`` leaves out SampleNoise."""
    tasks = [
        {"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"],
         "params": {"product_directory": product_dir}},
        {"type": "draco_tpu.synthesis.skymodel.GenerateGaussianSky",
         "out": "imap",
         "params": {"model": "foreground", "nside": nside, "nfreq": nfreq,
                    "freq_start": 400.0, "freq_end": 500.0, "seed": 3}},
        {"type": "draco.synthesis.stream.SimulateSidereal", "requires": "btm",
         "in": "imap", "out": "sstream", "params": {"streaming": True}},
        {"type": "draco.synthesis.stream.ExpandProducts", "requires": "tel",
         "in": "sstream", "out": "sstream_full"},
        {"type": "draco.synthesis.noise.ReceiverTemperature",
         "in": "sstream_full", "out": "sstream_rt",
         "params": {"recv_temp": 50.0}},
        {"type": "draco.synthesis.gain.RandomSiderealGains",
         "requires": ["tel", "sstream_rt"], "out": "gain_fluc",
         "params": {"seed": 7, "start_time": "2015-10-05 12:15:00",
                    "end_time": "2015-10-06 12:15:00",
                    "sigma_amp": 0.001, "sigma_phase": 0.001}},
        {"type": "draco.analysis.calibration.ApplyGain",
         "in": ["sstream_rt", "gain_fluc"], "out": "sstream_gain",
         "params": {"inverse": False}},
    ]
    last = "sstream_gain"
    if noise_seed is not None:
        tasks.append(
            {"type": "draco.synthesis.noise.SampleNoise", "in": last,
             "out": "sstream_noise",
             "params": {"seed": noise_seed, "sample_frac": 1.0e-3,
                        "set_weights": False}})
        last = "sstream_noise"
    tasks += [
        {"type": "draco.analysis.transform.CollateProducts",
         "requires": "btm", "in": last, "out": "sstream_coll"},
        {"type": "draco.analysis.transform.MModeTransform", "requires": "tel",
         "in": "sstream_coll", "out": "mmodes"},
        {"type": "draco.analysis.mapmaker.DirtyMapMaker", "requires": "btm",
         "in": "mmodes", "out": "dmap",
         "params": {"nside": nside, "streaming": True}},
    ]
    pipe = {"tasks": tasks}
    if mesh:
        pipe["mesh"] = {"freq": -1}
    return {"pipeline": pipe}


def phase_pipeline(nside=64, nfeed_side=8, nfreq=4, mesh=False) -> dict:
    """The composite chain: with noise, with other noise, without noise.

    The noise level is the rms of the difference of two noise seeds over
    sqrt(2); the noisy map must sit that far from the noiseless one
    (between half and twice the level).
    """
    from draco_tpu.core.pipeline import Manager
    from draco_tpu.telescope import UnpolarisedDishArray

    tel = UnpolarisedDishArray(
        grid_ew=nfeed_side, grid_ns=nfeed_side, spacing_ew=7.0,
        spacing_ns=7.0, latitude=45.0, dish_width=5.0, freq_lower=400.0,
        freq_upper=500.0, num_freq=nfreq, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    maps = {}
    with tempfile.TemporaryDirectory() as tmp:
        pdir = _product_dir(tel, tmp)
        for name, seed in (("noisy", 8), ("noisy2", 9), ("clean", None)):
            products = Manager(pipeline_config(pdir, nside, nfreq, seed,
                                               mesh)).run()
            maps[name] = np.asarray(products["dmap"][0].map[:])
    for name, m in maps.items():
        _check(bool(np.isfinite(m).all()), f"{name} map not finite")
        _check(bool(np.abs(m).max() > 0), f"{name} map is zero")

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x))))

    noise = rms(maps["noisy"] - maps["noisy2"]) / np.sqrt(2.0)
    _check(noise > 0, "the two noise seeds gave the same map")
    ratio = rms(maps["noisy"] - maps["clean"]) / noise
    _check(0.5 <= ratio <= 2.0,
           f"noisy - clean is {ratio:.2f} x the noise level")
    return {"nfeed": nfeed_side**2, "nside": nside, "nfreq": nfreq,
            "noise_over_signal": noise / rms(maps["clean"]),
            "deviation_over_noise": ratio, "peak_bytes": _peak_bytes(),
            "maps": maps}


def phase_delay_gibbs(nbase=128, ndelay=1024, niter=10, nsamp=8,
                      nhost=2, noise=0.03) -> dict:
    """Batched device Gibbs chain vs the host sampler's statistics.

    The signal-to-noise is kept where the chain's f32 Cholesky is well
    posed: its condition grows like ``nfreq / noise**2``, and at
    ``noise=0.01`` with 513 channels the f32 factorisation breaks down
    on any backend (the CPU too).
    """
    from draco_tpu.ops import delay as dops

    nfreq = ndelay // 2 + 1
    rng = np.random.Generator(np.random.SFC64(3))
    # band-limited flat spectrum below |delay| < 0.25 (cycles per
    # channel) plus white noise
    delays = np.fft.fftfreq(nfreq)
    band = np.abs(delays) < 0.25
    amp = (rng.standard_normal((nbase, nsamp, nfreq))
           + 1j * rng.standard_normal((nbase, nsamp, nfreq))) * band
    data = np.fft.fft(amp, axis=-1) / np.sqrt(nfreq)
    data += noise * (rng.standard_normal(data.shape)
                     + 1j * rng.standard_normal(data.shape))
    Ni = np.full((nbase, nfreq), 1.0 / (2 * noise**2))
    S0 = np.ones((nbase, ndelay))

    t0 = time.perf_counter()
    dev = dops.delay_power_spectrum_gibbs_batched(data, ndelay, Ni, S0,
                                                  niter=niter)
    first = time.perf_counter() - t0
    _check(dev.shape == (niter, nbase, ndelay), f"shape {dev.shape}")
    _check(bool(np.isfinite(dev).all()), "non-finite Gibbs samples")
    spec = np.median(dev[niter // 2:], axis=0)  # [nbase, ndelay]
    tau = np.abs(np.fft.fftfreq(ndelay))
    inb, outb = tau < 0.2, tau > 0.3
    sep = np.median(spec[:, inb], axis=1) / np.median(spec[:, outb], axis=1)
    _check(bool((sep > 20).all()),
           f"in-band/out-of-band separation down to {sep.min():.1f}")
    ratios = []
    for b in range(nhost):
        draws, ok = dops.delay_power_spectrum_gibbs(
            data[b], ndelay, Ni[b], S0[b], niter=niter,
            rng=np.random.default_rng(b),
        )
        _check(ok, f"host sampler failed on baseline {b}")
        host = np.median(np.asarray(draws)[niter // 2:], axis=0)
        ratios.append(float(np.median(spec[b, inb]) / np.median(host[inb])))
    _check(all(0.5 < r < 2.0 for r in ratios),
           f"device/host in-band level ratios {ratios}")
    return {"nbase": nbase, "ndelay": ndelay, "niter": niter,
            "first_call_s": first, "min_separation": float(sep.min()),
            "device_over_host": ratios, "peak_bytes": _peak_bytes()}


def phase_four_gpus_windowed(nside=256, nfeed_side=8, nfreq=8, chunk=520,
                             ndev=4, tol=2e-5) -> dict:
    """8 frequencies freq-sharded over ``ndev`` devices vs one device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from draco_tpu.ops import healpix
    from draco_tpu.parallel import make_mesh2d, use_mesh
    from draco_tpu.telescope import BeamTransfer
    from draco_tpu.telescope.roundtrip import fused_roundtrip_fn

    tel = dish_array(nside, nfeed_side, nfreq)
    bt = BeamTransfer(telescope=tel, nside=nside)
    rng = np.random.Generator(np.random.SFC64(17))
    sky = rng.standard_normal(
        (nfreq, 1, healpix.npix_of(nside))).astype(np.float32)
    run1 = fused_roundtrip_fn(bt, chunk=chunk)
    sky1 = jax.device_put(sky, jax.devices()[0])
    ref = run1(sky1)
    ref.block_until_ready()
    one = _steady(lambda: run1(sky1), 3)
    mesh = make_mesh2d(shape=(ndev, 1), axis_names=("freq", "m"))
    with use_mesh(mesh):
        runs = fused_roundtrip_fn(bt, chunk=chunk)
        sky_sh = jax.device_put(sky, NamedSharding(mesh, P("freq", None, None)))
        got = runs(sky_sh)
        got.block_until_ready()
        sharded = _steady(lambda: runs(sky_sh), 3)
    _check(len(got.sharding.device_set) == ndev,
           f"output spans {len(got.sharding.device_set)} devices")
    rel = _relerr(got, ref)
    _check(rel <= tol, f"sharded vs one device relerr {rel:.3e} > {tol}")
    return {"nfreq": nfreq, "devices": ndev, "relerr": rel, "bound": tol,
            "one_device_median_s": one["steady_median_s"],
            "sharded_median_s": sharded["steady_median_s"],
            "steady_compiles": one["steady_compiles"]
            + sharded["steady_compiles"]}


def phase_four_gpus_pipeline(nside=64, nfeed_side=8, nfreq=4) -> dict:
    """The composite chain under ``mesh: {freq: -1}`` vs without a mesh."""
    plain = phase_pipeline(nside, nfeed_side, nfreq, mesh=False)
    meshed = phase_pipeline(nside, nfeed_side, nfreq, mesh=True)
    noise = np.sqrt(np.mean(np.square(
        plain["maps"]["noisy"] - plain["maps"]["noisy2"]))) / np.sqrt(2.0)
    ratio = float(np.sqrt(np.mean(np.square(
        meshed["maps"]["noisy"] - plain["maps"]["noisy"]))) / noise)
    clean = _relerr(meshed["maps"]["clean"], plain["maps"]["clean"])
    _check(ratio <= 2.0, f"meshed - plain is {ratio:.2f} x the noise level")
    _check(clean <= 1e-4, f"noiseless meshed vs plain relerr {clean:.3e}")
    return {"meshed_minus_plain_over_noise": ratio,
            "clean_relerr": clean,
            "meshed_deviation_over_noise": meshed["deviation_over_noise"]}


def _report(name: str, result: dict) -> None:
    shown = {k: v for k, v in result.items() if k != "maps"}
    print(f"phase {name}: ok {json.dumps(shown)}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-gpus", action="store_true",
        help="run only the sharded paths, on four GPUs of one host",
    )
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: no GPU; JAX found {len(devices)} "
            f"{devices[0].platform} device(s) ({devices[0].device_kind})",
            file=sys.stderr,
        )
        return 2
    need = 4 if args.four_gpus else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    dev = phase_device()
    for line in dev["nvidia_smi"]:
        print(line, flush=True)
    _report("device", dev)
    if args.four_gpus:
        _report("four_gpus_windowed", phase_four_gpus_windowed())
        _report("four_gpus_pipeline", phase_four_gpus_pipeline())
    else:
        _report("roundtrip_windowed", phase_windowed())
        _report("roundtrip_fullsphere", phase_fullsphere())
        _report("accuracy_f64", phase_accuracy())
        _report("pipeline", phase_pipeline())
        _report("delay_gibbs", phase_delay_gibbs())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
