"""Benchmark: simulate -> map round trip (nside=256, ~2k baselines).

The driver metric (BASELINE.json): round-trip wall-clock at nside=256 with
2k baselines, and m-modes/sec.  The workload is the full m-mode spine on a
64-feed non-redundant array (2080 unique pairs):

  sky map --SHT--> alm --beam projection--> V_m --iFFT--> sidereal stream
  --FFT--> m-modes --weighted adjoint--> dirty alm --inverse SHT--> map

Beam-transfer tensors at this scale (2 x 2080 x 768 x 768 complex64 ~ 20 GB)
are (re)generated on the fly per baseline chunk instead of held in device
memory — the same streaming structure that shards baselines across GPUs.
Generation is *included* in the timed region (the reference precomputes its
products on disk; including it here is conservative).

Prints the record as a JSON line after each stage: {"metric", "value",
"unit", "vs_baseline", "device", ...}.  vs_baseline = 60s (the
BASELINE.json north-star wall-clock) / our seconds.  It measures the GPU
and refuses any other device unless BENCH_PLATFORM=cpu asks for a CPU
rehearsal.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

T_PROC_START = time.time()
RECORD: dict = {
    "metric": "simulate_to_map_roundtrip_nside256_2080baselines",
    "value": None,
    "unit": "s",
    "vs_baseline": None,
}

# Total wall-clock budget from process start; extras past it are
# skipped (and listed under "skipped").  Override: BENCH_TOTAL_BUDGET_S.
TOTAL_BUDGET_S = float(os.environ.get("BENCH_TOTAL_BUDGET_S", 3300))


def _emit(stage: str) -> None:
    """Print the record so far as one JSON line."""
    RECORD["emitted_at_stage"] = stage
    RECORD["total_bench_s"] = round(time.time() - T_PROC_START, 1)
    print(json.dumps(RECORD), flush=True)


def _budget_left() -> float:
    return TOTAL_BUDGET_S - (time.time() - T_PROC_START)


NSIDE = int(os.environ.get("BENCH_NSIDE", 256))
NFEED_SIDE = int(os.environ.get("BENCH_NFEED_SIDE", 8))  # 64 feeds
# Baselines per streamed chunk in the fused round trip.  The jittered
# 64-feed array has 2017 unique pairs (autos collapse into one stack);
# 520 pads that to 4 x 520 with the largest per-chunk GEMMs that fit
# HBM alongside the windowed Legendre band.
CHUNK = int(os.environ.get("BENCH_CHUNK", 520))

# The 1e-5 map-accuracy target requires true f32 (HIGHEST) GEMMs; an
# unpinned f32 dot may run in TF32 on the GPU.
import jax.lax as _lax
# GEMM precision mode (BENCH_PREC): "highest" (default), "high", or
# "mixed" (ring-DFT GEMMs at HIGH, Legendre at HIGHEST).
_prec_name = os.environ.get("BENCH_PREC", "highest").lower()
if _prec_name == "mixed":
    os.environ.setdefault("DRACO_TPU_SHT_RING_PRECISION", "high")
    os.environ.setdefault("DRACO_TPU_SHT_LEGENDRE_PRECISION", "highest")
    PREC = _lax.Precision.HIGHEST
else:
    os.environ.setdefault("DRACO_TPU_SHT_PRECISION", _prec_name)
    PREC = {"high": _lax.Precision.HIGH, "highest": _lax.Precision.HIGHEST}[
        _prec_name
    ]
NRUN = int(os.environ.get("BENCH_NRUN", 2))

# Per-tag steady-state run times, kept so the emitted JSON can carry
# min/median/max spreads.
_RUN_TIMES: dict = {}


def _spread(tag):
    ts = _RUN_TIMES.get(tag)
    if not ts:
        return None
    return {
        "min": round(min(ts), 3),
        "median": round(float(np.median(ts)), 3),
        "max": round(max(ts), 3),
        "n": len(ts),
    }
# Baseline-data-parallel sharding over N devices (pod scaling): each
# baseline chunk's beam-transfer generation + projection shards over the
# mesh; the small [m, 2, nbl] visibility array stays replicated.
SHARD = int(os.environ.get("BENCH_SHARD", 0))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _configure_jax():
    """Import JAX on the GPU (or the CPU when BENCH_PLATFORM=cpu asks)."""
    import jax

    platform = os.environ.get("BENCH_PLATFORM")
    if platform:
        jax.config.update("jax_platforms", platform)
    found = jax.devices()[0].platform
    if found != "gpu" and platform != "cpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {found} "
            "(BENCH_PLATFORM=cpu runs a CPU rehearsal)"
        )

    from draco_tpu import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    RECORD["device"] = {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": jax.device_count(),
    }
    return jax


def _build_library_problem(nfreq: int, nfeed_side: int, autos: bool):
    """Benchmark telescope + beam transfer + sky through the library."""
    import jax.numpy as jnp  # noqa: F401

    from draco_tpu.ops import healpix
    from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray

    # centre the band on lambda ~ 0.6 m (the round-1 spine workload)
    f0 = 299.792458 / 0.6  # MHz
    half_bw = 0.05 * f0 * max(nfreq - 1, 0) / max(nfreq, 1)
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
        freq_lower=f0 - half_bw,
        freq_upper=f0 + half_bw,
        num_freq=nfreq,
        auto_correlations=autos,
        force_lmax=3 * NSIDE - 1,
        force_mmax=3 * NSIDE - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=NSIDE)
    rng = np.random.Generator(np.random.SFC64(1))
    sky = rng.standard_normal(
        (nfreq, 1, healpix.npix_of(NSIDE))
    ).astype(np.float32)
    return tel, bt, sky


def run_library(nfreq: int, nfeed_side: int, autos: bool, chunk: int,
                nrun: int, tag: str):
    """Time the library's fused simulate->map round trip.

    Returns (best wall seconds, warmup seconds, npairs).
    """
    import jax.numpy as jnp

    from draco_tpu.telescope.roundtrip import fused_roundtrip_fn

    breakdown: dict = {}
    t0 = time.time()
    tel, bt, sky = _build_library_problem(nfreq, nfeed_side, autos)
    npairs = len(tel.uniquepairs)
    log(f"[{tag}] nside={NSIDE} nfreq={nfreq} nfeed={nfeed_side ** 2} "
        f"npairs={npairs} chunk={chunk}")

    # Phase 1: constants build + host->device transfers.
    run = fused_roundtrip_fn(bt, chunk=chunk)
    sky_dev = jnp.asarray(sky)
    breakdown["constants_s"] = round(time.time() - t0, 1)

    def once():
        out = run(sky_dev)
        out.block_until_ready()
        return out

    # Phase 2: first dispatch (XLA compile or cache load + one run).
    t0 = time.time()
    out = once()
    warm = time.time() - t0
    breakdown["first_dispatch_s"] = round(warm, 1)
    warm += breakdown["constants_s"]
    log(f"[{tag}] warmup (incl. compile): {warm:.1f}s "
        f"(constants {breakdown['constants_s']}s, "
        f"first dispatch {breakdown['first_dispatch_s']}s)")

    times = []
    for i in range(nrun):
        t0 = time.time()
        out = once()
        times.append(time.time() - t0)
        log(f"[{tag}] run {i}: {times[-1]:.3f}s")

    if os.environ.get("BENCH_DUMP"):
        np.save(os.environ["BENCH_DUMP"], np.asarray(out))
    assert np.isfinite(np.asarray(out[:, :, :1024])).all()
    _RUN_TIMES[tag] = times
    return min(times), warm, npairs, breakdown


def run_cylinder(ncyl=None, nfeed=None, chunk=None, tag="cylinder", pol=False):
    """Full-sphere fused round trip on a cylinder (CHIME-class) telescope.

    ``pol=True`` selects the dual-pol instrument (X and Y feeds at every
    position, full T/Q/U/V sky): ``nfeed`` then counts per-polarisation
    feeds per cylinder, so 4 x 256 dual-pol is the BASELINE.json
    2048-feed scale-up geometry (7155 stacked products).
    """
    import jax.numpy as jnp

    from draco_tpu.ops import healpix
    from draco_tpu.telescope import (
        BeamTransfer,
        PolarisedCylinderTelescope,
        UnpolarisedCylinderTelescope,
    )
    from draco_tpu.telescope.roundtrip import fused_roundtrip_fn

    if ncyl is None:
        ncyl = int(os.environ.get("BENCH_CYL_N", 2))
    if nfeed is None:
        nfeed = int(os.environ.get("BENCH_CYL_FEEDS", 64))
    f0 = 299.792458 / 0.6
    cls = PolarisedCylinderTelescope if pol else UnpolarisedCylinderTelescope
    tel = cls(
        num_cylinders=ncyl,
        cylinder_width=20.0,
        cylinder_spacing=22.0,
        num_feeds=nfeed,
        feed_spacing=0.5,
        latitude=49.0,
        freq_lower=f0,
        freq_upper=f0,
        num_freq=1,
        auto_correlations=True,
        force_lmax=3 * NSIDE - 1,
        force_mmax=3 * NSIDE - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=NSIDE)
    npairs = len(tel.uniquepairs)
    if chunk is None:
        chunk = int(os.environ.get("BENCH_CYL_CHUNK", min(64, npairs)))
    log(f"[{tag}] nside={NSIDE} cylinders={ncyl}x{nfeed} "
        f"npairs={npairs} chunk={chunk} windowed={bt._beam_window() is not None}")

    rng = np.random.Generator(np.random.SFC64(1))
    sky = jnp.asarray(
        rng.standard_normal(
            (1, tel.num_pol_sky, healpix.npix_of(NSIDE))
        ).astype(np.float32)
    )
    run = fused_roundtrip_fn(bt, chunk=chunk)

    def once():
        out = run(sky)
        out.block_until_ready()
        return out

    t0 = time.time()
    out = once()
    warm = time.time() - t0
    log(f"[{tag}] warmup (incl. compile): {warm:.1f}s")
    times = []
    for i in range(max(2, NRUN - 1)):
        t0 = time.time()
        once()
        times.append(time.time() - t0)
        log(f"[{tag}] run {i}: {times[-1]:.3f}s")
    assert np.isfinite(np.asarray(out[:, :, :1024])).all()
    _RUN_TIMES[tag] = times
    return min(times), warm, npairs


def run_delay_gibbs():
    """Time the batched delay-PS Gibbs sampler at a production shape.

    128 baselines x 513 frequencies (N = 1024 delays), 10 Gibbs
    iterations: every baseline's chain advances in one scanned device
    program (batched Cholesky + GEMM draws).
    """
    import jax.numpy as jnp  # noqa: F401

    from draco_tpu.ops import delay as dops

    nbase = int(os.environ.get("BENCH_DELAY_NBASE", 128))
    ndelay = int(os.environ.get("BENCH_DELAY_N", 1024))
    niter = int(os.environ.get("BENCH_DELAY_NITER", 10))
    nsamp = 2
    nfreq = ndelay // 2 + 1

    rng = np.random.Generator(np.random.SFC64(3))
    data = (
        rng.standard_normal((nbase, nsamp, nfreq))
        + 1j * rng.standard_normal((nbase, nsamp, nfreq))
    ).astype(np.complex128)
    Ni = rng.uniform(0.5, 2.0, (nbase, nfreq))
    S0 = np.ones((nbase, ndelay))

    def once():
        return dops.delay_power_spectrum_gibbs_batched(
            data, ndelay, Ni, S0, niter=niter
        )

    t0 = time.time()
    out = once()
    warm = time.time() - t0
    log(f"[delay_gibbs] warmup (incl. compile): {warm:.1f}s")
    # min over >= 3 timed runs
    times = []
    for i in range(max(3, NRUN - 1)):
        t0 = time.time()
        out = once()
        times.append(time.time() - t0)
        log(f"[delay_gibbs] run {i}: {times[-1]:.3f}s")
    dt = min(times)
    assert np.isfinite(out).all()
    _RUN_TIMES["delay_gibbs"] = times
    return {
        "nbase": nbase,
        "ndelay": ndelay,
        "niter": niter,
        "seconds": round(dt, 3),
        "spread_s": _spread("delay_gibbs"),
        "warmup_s": round(warm, 1),
    }


def run_chime_composite():
    """The BASELINE scale-up COMPOSITE stages at 2048 feeds.

    Receiver temperature + GP gain fluctuations + ApplyGain +
    complex-Wishart SampleNoise on the FULL 2048-input correlation
    triangle (2,098,176 products), streamed through the HBM-budgeted
    Wishart chunk kernel (draco_tpu/synthesis/noise.py).  The full
    triangle at production RA resolution is ~26 TB — no machine
    materialises it (the reference's per-(freq, time) loop,
    /root/reference/draco/synthesis/noise.py:344-372, faces the same
    wall) — so the composite stages run on a time chunk and report the
    cost per (freq, time) sample; the simulate->map spine at this
    geometry is the separate cylinder_chime2048 extra, and the whole
    chain executes end-to-end at reduced scale in
    tests/test_endtoend.py::test_composite_pipeline_yaml.
    """
    from draco_tpu.analysis.calibration import ApplyGain
    from draco_tpu.core import containers
    from draco_tpu.synthesis import gain as gain_mod
    from draco_tpu.synthesis import noise as noise_mod

    nfeed = int(os.environ.get("BENCH_COMPOSITE_FEEDS", 2048))
    ntime = int(os.environ.get("BENCH_COMPOSITE_NTIME", 4))
    ts = containers.TimeStream(
        freq=np.array([800.0]), input=nfeed,
        time=1.4e9 + np.arange(ntime) * 10.0,
    )
    nprod = ts.vis.shape[1]
    rng = np.random.Generator(np.random.SFC64(7))
    # small random crosses + dominant autos -> safely positive definite
    vis = (
        0.1 * rng.standard_normal((1, nprod, ntime))
        + 0.1j * rng.standard_normal((1, nprod, ntime))
    ).astype(np.complex64)
    ts.vis[:] = vis
    ts.weight[:] = 1.0

    stages = {}
    t0 = time.time()
    rt = noise_mod.ReceiverTemperature()
    rt.read_config({"recv_temp": 50.0})
    ts = rt.process(ts)
    stages["recv_temp_s"] = round(time.time() - t0, 2)

    t0 = time.time()
    g = gain_mod.RandomGains()
    g.read_config({"seed": 5, "sigma_amp": 0.001, "sigma_phase": 0.001})
    gains = g.process(ts)
    ap = ApplyGain()
    ap.read_config({"inverse": False})
    ts = ap.process(ts, gains)
    stages["gains_s"] = round(time.time() - t0, 2)

    sn = noise_mod.SampleNoise()
    sn.read_config({"seed": 6, "sample_frac": 1.0})
    t0 = time.time()
    ts = sn.process(ts)
    warm = time.time() - t0
    t0 = time.time()
    ts = sn.process(ts)  # warm timing: kernel compiled, PD preserved
    stages["wishart_s"] = round(time.time() - t0, 2)
    stages["wishart_warmup_s"] = round(warm, 1)
    stages["wishart_per_sample_s"] = round(stages["wishart_s"] / ntime, 3)
    stages.update({"nfeed": nfeed, "nprod": int(nprod), "ntime": ntime})
    assert np.isfinite(np.asarray(ts.vis[:])).all()
    return stages


def run_chime_composite_stream():
    """Disk-backed per-time-window streaming composite at 2048 feeds.

    The production reduction pattern (reference file-at-a-time chains,
    /root/reference/doc/tutorial.rst:108-163): window files stream from
    disk through LoadFilesFromParams (prefetch thread overlapping the
    next HDF5 read with device compute) -> ReceiverTemperature ->
    stateful GP RandomGains (constrained across window boundaries) ->
    ApplyGain -> HBM-budgeted Wishart SampleNoise.  Reports the
    SUSTAINED s/sample over the window loop — the figure the round-4
    4-sample extrapolation could not provide — plus the I/O and
    first-window (compile) split.
    """
    import shutil
    import tempfile

    from draco_tpu.analysis.calibration import ApplyGain
    from draco_tpu.core import containers
    from draco_tpu.core import io as dio
    from draco_tpu.core.pipeline import PipelineStopIteration
    from draco_tpu.synthesis import gain as gain_mod
    from draco_tpu.synthesis import noise as noise_mod

    nfeed = int(os.environ.get("BENCH_COMPOSITE_FEEDS", 2048))
    nwin = int(os.environ.get("BENCH_STREAM_WINDOWS", 64))
    ntime = int(os.environ.get("BENCH_STREAM_NTIME", 1))
    # fit the window count to the remaining wall-clock budget (rough
    # per-window and fixed costs: file writes plus the first-window
    # compile); the sustained median is meaningful from ~16 windows up,
    # and a partial measurement beats a budget-killed one
    est_fixed_s = 420.0
    per_win_s = 12.0 if nfeed >= 1024 else 1.0
    affordable = int((_budget_left() - est_fixed_s) / per_win_s)
    if affordable < nwin:
        nwin = max(8, affordable)
        log(f"[composite_stream] budget-capped to {nwin} windows")
    tmpdir = tempfile.mkdtemp(prefix="draco_stream_")
    try:
        # -- write the window files (timed separately) ------------------
        rng = np.random.Generator(np.random.SFC64(7))
        nprod = nfeed * (nfeed + 1) // 2
        t_w0 = time.time()
        files = []
        for w in range(nwin):
            ts = containers.TimeStream(
                freq=np.array([800.0]), input=nfeed,
                time=1.4e9 + (w * ntime + np.arange(ntime)) * 10.0,
            )
            ts.vis[:] = (
                0.1 * rng.standard_normal((1, nprod, ntime))
                + 0.1j * rng.standard_normal((1, nprod, ntime))
            ).astype(np.complex64)
            ts.weight[:] = 1.0
            ts.attrs["integration_time"] = 10.0  # single-sample windows
            fname = os.path.join(tmpdir, f"win{w:03d}.h5")
            ts.save(fname)
            files.append(fname)
        write_s = time.time() - t_w0

        loader = dio.LoadFilesFromParams()
        loader.read_config(
            {"files": files, "distributed": False, "prefetch": True}
        )
        rt = noise_mod.ReceiverTemperature()
        rt.read_config({"recv_temp": 50.0})
        g = gain_mod.RandomGains()
        g.read_config({"seed": 5, "sigma_amp": 0.001, "sigma_phase": 0.001})
        ap = ApplyGain()
        ap.read_config({"inverse": False})
        sn = noise_mod.SampleNoise()
        sn.read_config({"seed": 6, "sample_frac": 1.0})

        win_times = []
        t_loop0 = time.time()
        while True:
            t0 = time.time()
            try:
                ts = loader.process()
            except PipelineStopIteration:
                break
            ts = rt.process(ts)
            gn = g.process(ts)
            ts = ap.process(ts, gn)
            ts = sn.process(ts)
            assert np.isfinite(np.asarray(ts.vis[:1, :64])).all()
            win_times.append(time.time() - t0)
            if len(win_times) % 16 == 0:
                log(f"[composite_stream] window {len(win_times)}/{nwin}: "
                    f"{win_times[-1]:.2f}s")
        loop_s = time.time() - t_loop0
        steady = win_times[1:] or win_times
        return {
            "nfeed": nfeed,
            "nprod": int(nprod),
            "windows": len(win_times),
            "ntime_per_window": ntime,
            "file_write_s": round(write_s, 1),
            "first_window_s": round(win_times[0], 2),
            "sustained_s_per_sample": round(
                float(np.median(steady)) / ntime, 3
            ),
            "window_spread_s": {
                "min": round(min(steady), 2),
                "median": round(float(np.median(steady)), 2),
                "max": round(max(steady), 2),
            },
            "loop_total_s": round(loop_s, 1),
        }
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _accuracy_canary(nside: int = 64, feeds: int = 4, tol: float = 1e-5):
    """Production fused path on this device vs f64 truth (CPU-only child)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "scripts"))
    import check_accuracy_production as cap

    rel = cap.production_relerr(nside, feeds)
    return {"nside": nside, "feeds": feeds * feeds, "rel_err": rel,
            "tol": tol, "ok": rel < tol}


def _cpu_script(script, args, timeout):
    """Run ``scripts/<script>`` in a CPU-only child; return its JSON line."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "scripts", script),
            *args,
        ],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        check=True,
    )
    for line in reversed(proc.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"{script} printed no JSON line")


def main():
    def _flag(name):
        return os.environ.get(name, "0") not in ("0", "")

    legacy = (
        _flag("BENCH_SHARD")
        or _flag("BENCH_NO_WINDOW")
        or _flag("BENCH_MIRROR")
        or _flag("BENCH_LEGACY")
    )
    if legacy:
        run_spine(emit_json=True)
        return

    _configure_jax()
    extras = RECORD
    extras["task_path"] = True

    # headline: the library fused round trip at the round-1 workload scale
    value, warm, npairs, hl_breakdown = run_library(
        nfreq=1,
        nfeed_side=NFEED_SIDE,
        autos=True,
        chunk=CHUNK,
        nrun=NRUN,
        tag="headline",
    )
    extras["value"] = round(value, 3)
    extras["vs_baseline"] = round(60.0 / value, 2)
    extras["warmup_s"] = round(warm, 1)
    extras.setdefault("warmup_breakdown", {}).update(hl_breakdown)
    extras["spread_s"] = _spread("headline")
    # the BASELINE.json companion metric: m-modes processed per second
    # ((mmax+1) x 2 signs x npairs per frequency per round trip)
    mmax_hl = 3 * NSIDE - 1
    extras["mmodes_per_sec"] = float(
        f"{(mmax_hl + 1) * 2 * npairs / value:.3g}"
    )
    _emit("headline")

    def within_budget(tag):
        if _budget_left() > 120.0:
            return True
        log(f"[{tag}] skipped: past the {TOTAL_BUDGET_S:.0f}s bench budget")
        extras.setdefault("skipped", []).append(tag)
        return False

    # accuracy canary: the production fused path on THIS device vs f64
    # truth at nside=64 (the truth leg is a CPU-only child process)
    if os.environ.get("BENCH_CANARY", "1") != "0" and within_budget(
        "accuracy_canary"
    ):
        extras["accuracy_canary"] = _accuracy_canary()
        _emit("accuracy_canary")

    # Engine-independent physics canary: the production-shape simulate
    # spine + m-mode packing vs scipy-harmonic pixel-sum truth at
    # nside=256, so a framework-wide algorithmic error cannot cancel.
    # It checks conventions, not the device, so it runs in a CPU-only
    # child beside this process's hold on the GPU.
    if os.environ.get("BENCH_PHYSICS", "1") != "0" and within_budget(
        "physics_canary"
    ):
        extras["physics_canary"] = _cpu_script(
            "check_physics.py", ["--json"], max(60.0, _budget_left() - 120)
        )
        _emit("physics_canary")

    if os.environ.get("BENCH_EXTRAS", "1") != "0" and within_budget("extras"):
        # multi-frequency scaling: the marginal per-frequency cost with
        # freq-batched GEMMs
        nfreq = int(os.environ.get("BENCH_NFREQ", 8))
        t_mf, warm_mf, _, _ = run_library(
            nfreq=nfreq,
            nfeed_side=NFEED_SIDE,
            autos=True,
            chunk=CHUNK,
            nrun=max(2, NRUN - 1),
            tag=f"multifreq{nfreq}",
        )
        extras["multi_freq"] = {
            "nfreq": nfreq,
            "seconds": round(t_mf, 3),
            "per_freq_s": round(t_mf / nfreq, 4),
            "spread_s": _spread(f"multifreq{nfreq}"),
        }

        # north-star feed count: 256 feeds, C(256,2) = 32640 cross pairs,
        # with 8 frequencies batched so the one-time fringe trig amortises
        big_side = int(os.environ.get("BENCH_BIG_SIDE", 16))
        big_chunk = int(os.environ.get("BENCH_BIG_CHUNK", 2040))
        big_nfreq = int(os.environ.get("BENCH_BIG_NFREQ", 8))
        t_big, warm_big, npairs_big, _ = run_library(
            nfreq=big_nfreq,
            nfeed_side=big_side,
            autos=False,
            chunk=big_chunk,
            nrun=max(2, NRUN - 1),
            tag=f"feeds{big_side ** 2}x{big_nfreq}f",
        )
        extras["feeds256"] = {
            "npairs": npairs_big,
            "nfreq": big_nfreq,
            "seconds": round(t_big, 3),
            "per_freq_s": round(t_big / big_nfreq, 4),
            "spread_s": _spread(f"feeds{big_side ** 2}x{big_nfreq}f"),
        }

        # freq-batch scaling curve: a second batch depth brackets the
        # per-frequency cost by data
        half_nfreq = max(2, big_nfreq // 2)
        t_half, _, _, _ = run_library(
            nfreq=half_nfreq,
            nfeed_side=big_side,
            autos=False,
            chunk=big_chunk,
            nrun=max(2, NRUN - 1),
            tag=f"feeds{big_side ** 2}x{half_nfreq}f",
        )
        extras["freq_scaling"] = {
            f"per_freq_s_nfreq{half_nfreq}": round(t_half / half_nfreq, 4),
            f"per_freq_s_nfreq{big_nfreq}": round(t_big / big_nfreq, 4),
            "batch_efficiency": round(
                (t_half / half_nfreq) / (t_big / big_nfreq), 3
            ),
        }
        _emit("extras_library")

    if os.environ.get("BENCH_AUDIT", "1") != "0" and within_budget(
        "freq_parallel_audit"
    ):
        # collective audit of the freq-sharded program, compiled for a
        # virtual CPU mesh in a CPU-only child
        extras["freq_parallel_audit"] = _cpu_script(
            "audit_freq_parallel.py", ["--json"], 600
        )
        _emit("freq_parallel_audit")

    if os.environ.get("BENCH_CYLINDER", "1") != "0" and within_budget(
        "cylinder"
    ):
        # CHIME-class instrument: full-sphere fused path (no beam window)
        t_cyl, warm_cyl, npairs_cyl = run_cylinder()
        extras["cylinder"] = {
            "npairs": npairs_cyl,
            "seconds": round(t_cyl, 3),
            "spread_s": _spread("cylinder"),
            "warmup_s": round(warm_cyl, 1),
        }
        _emit("cylinder")

    if os.environ.get("BENCH_CHIME", "1") != "0" and within_budget(
        "cylinder_chime"
    ):
        # the BASELINE.json CHIME-scale geometry: 4 cylinders x 256 feeds,
        # redundancy-stacked pairs, full-sphere path
        t_ch, warm_ch, npairs_ch = run_cylinder(
            ncyl=int(os.environ.get("BENCH_CHIME_CYL", 4)),
            nfeed=int(os.environ.get("BENCH_CHIME_FEEDS", 256)),
            chunk=int(os.environ.get("BENCH_CHIME_CHUNK", 256)),
            tag="cylinder_chime",
        )
        extras["cylinder_chime"] = {
            "npairs": npairs_ch,
            "seconds": round(t_ch, 3),
            "spread_s": _spread("cylinder_chime"),
            "warmup_s": round(warm_ch, 1),
        }
        _emit("cylinder_chime")

    if os.environ.get("BENCH_CHIME_POL", "1") != "0" and within_budget(
        "cylinder_chime2048"
    ):
        # the full BASELINE.json scale-up instrument: 4 cylinders x 256
        # DUAL-POL feeds = 2048 feeds, 7155 redundancy-stacked products,
        # full T/Q/U/V sky through the full-sphere path
        ncyl_p = int(os.environ.get("BENCH_CHIME_CYL", 4))
        nfeed_p = int(os.environ.get("BENCH_CHIME_FEEDS", 256))
        t_cp, warm_cp, npairs_cp = run_cylinder(
            ncyl=ncyl_p,
            nfeed=nfeed_p,
            chunk=int(os.environ.get("BENCH_CHIME_POL_CHUNK", 96)),
            tag="cylinder_chime2048",
            pol=True,
        )
        extras["cylinder_chime2048"] = {
            "nfeed": 2 * ncyl_p * nfeed_p,
            "npairs": npairs_cp,
            "npol_sky": 4,
            "seconds": round(t_cp, 3),
            "spread_s": _spread("cylinder_chime2048"),
            "warmup_s": round(warm_cp, 1),
        }
        _emit("cylinder_chime2048")

    if os.environ.get("BENCH_DELAY", "1") != "0" and within_budget(
        "delay_gibbs"
    ):
        # The reference's other headline estimator: the delay power
        # spectrum Gibbs sampler, batched over baselines on device
        # (reference delay.py:905-931 loops baselines on the host).
        extras["delay_gibbs"] = run_delay_gibbs()
        _emit("delay_gibbs")

    if os.environ.get("BENCH_CROSSCHECK"):
        spine = run_spine(emit_json=False)
        extras["spine_crosscheck_s"] = round(spine, 3)
        extras["library_vs_spine"] = round(value / spine, 3)

    if os.environ.get("BENCH_COMPOSITE", "1") != "0" and within_budget(
        "chime_composite2048"
    ):
        # the last BASELINE config: gain fluctuations + Wishart noise at
        # 2048 feeds (see run_chime_composite docstring)
        extras["chime_composite2048"] = run_chime_composite()
        _emit("chime_composite2048")

    if os.environ.get("BENCH_STREAM", "1") != "0" and within_budget(
        "chime_composite_stream"
    ):
        # the disk-backed sustained version of the composite: >= 64
        # windows streamed file-at-a-time with I/O prefetch
        extras["chime_composite_stream"] = run_chime_composite_stream()
        _emit("chime_composite_stream")

    _emit("final")


def run_spine(emit_json: bool = True):
    jax = _configure_jax()
    import jax.numpy as jnp

    from draco_tpu.ops import healpix, mmode, sht

    lmax = 3 * NSIDE - 1
    npix = healpix.npix_of(NSIDE)
    nfeed = NFEED_SIDE * NFEED_SIDE

    log(f"devices: {jax.devices()}")
    log(f"nside={NSIDE} lmax=mmax={lmax} nfeed={nfeed}")

    # Non-redundant 64-feed array: jittered grid -> all 2080 pairs unique.
    rng = np.random.Generator(np.random.SFC64(1))
    base = np.stack(
        np.meshgrid(
            np.arange(NFEED_SIDE) * 7.0, np.arange(NFEED_SIDE) * 7.0, indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 2)
    pos = base + rng.uniform(-1.0, 1.0, base.shape)
    ii, jj = np.triu_indices(nfeed, k=0)
    bl = pos[ii] - pos[jj]  # [npairs, 2]
    npairs = len(bl)
    log(f"npairs={npairs}")

    # Geometry on device
    lam = 0.6  # ~500 MHz
    colat = np.pi / 2 - np.radians(45.0)
    east = np.array([0.0, 1.0, 0.0])
    north = np.array([-np.cos(colat), 0.0, np.sin(colat)])
    zenith = np.array([np.sin(colat), 0.0, np.cos(colat)])
    bl3 = (bl[:, :1] * east[None] + bl[:, 1:] * north[None]) / lam  # wavelengths

    vec = healpix.pix2vec(NSIDE).astype(np.float32)  # [npix, 3]
    cos_sep = np.clip(vec @ zenith, -1.0, 1.0)
    sigma2 = (0.12 / 2.355) ** 2
    beam_pow = (
        np.exp(-(np.arccos(cos_sep) ** 2) / (2 * sigma2)) * (cos_sep > 0)
    ).astype(np.float32)  # A_i A_j for identical feeds

    s = sht.get_sht(NSIDE, lmax)
    omega = 4 * np.pi / npix

    vec_d = jnp.asarray(vec)
    beam_d = jnp.asarray(beam_pow * omega)
    bl3_d = jnp.asarray(bl3.astype(np.float32))

    nchunk = (npairs + CHUNK - 1) // CHUNK
    pad = nchunk * CHUNK - npairs
    bl3_pad = jnp.concatenate([bl3_d, jnp.zeros((pad, 3), jnp.float32)], axis=0)

    scale = 1.0 / omega

    if SHARD > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:SHARD]), ("b",))
        log(f"sharding baselines over {SHARD} devices")

        def shard_bl(x, spec):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(*spec))
            )

    else:

        def shard_bl(x, spec):
            return x

    # Beam-band windowed projection (default): the Gaussian beam kills all
    # but ~1% of the sphere, so the fringe x beam ring-DFT restricted to a
    # per-ring pixel window around the beam footprint is exact to the beam
    # truncation (~1e-9) and ~50x less work than full-sphere analysis.
    # With S = Lambda alm pre-contracted, the whole beam projection
    # collapses to four flat [chunk, Rb*W] x [Rb*W, M+1] GEMMs per chunk
    # against E.S phase tensors (a1 = Re[(Ec+iEs)S], a2 = Im[...]):
    #   F+.S        = (re a1 - im a2) + i (re a2 + im a1)
    #   conj(F-).S  = (re a1 + im a2) + i (re a2 - im a1)
    # Validated against the full-sphere spine: 2.9e-10 rel (f64), and
    # MORE accurate than the full path in f32 (8.8e-6 vs 1.5e-5 — fewer
    # rounding terms).  BENCH_NO_WINDOW=1 falls back to the full-sphere
    # paths below.
    WINDOWED = not os.environ.get("BENCH_NO_WINDOW")
    if WINDOWED:
        info = healpix.ring_info(NSIDE)
        TAU = 1e-9
        band, starts, wmax = [], [], 0
        for r in range(info.nring):
            o, n = int(info.offset[r]), int(info.nphi[r])
            bg = beam_pow[o : o + n]
            if bg.max() <= TAU:
                continue
            good = np.nonzero(bg > TAU)[0]
            if len(good) == n:
                p0, width = 0, n
            else:
                gaps = np.diff(np.concatenate([good, [good[0] + n]]))
                k = int(np.argmax(gaps))
                p0 = int(good[(k + 1) % len(good)])
                width = n - int(gaps.max()) + 1
            band.append(r)
            starts.append(p0)
            wmax = max(wmax, width)
        band = np.array(band)
        Rb = len(band)
        # Rings narrower than the common width W get their surplus slots
        # masked out of the beam weight (the % n index would otherwise
        # repeat pixels and double-count them); every window-pixel term
        # in both loop directions carries beamw exactly once, so zeroing
        # it there removes the duplicates entirely.
        W = wmax + 2

        widx = np.zeros((Rb, W), np.int64)
        phi_w = np.zeros((Rb, W))
        maskw = np.zeros((Rb, W), np.float32)
        for k, r in enumerate(band):
            o, n = int(info.offset[r]), int(info.nphi[r])
            p = (starts[k] + np.arange(W)) % n
            widx[k] = o + p
            phi_w[k] = info.phi0[r] + 2 * np.pi * p / n
            maskw[k, : min(W, n)] = 1.0
        vecw_d = jnp.asarray(vec[widx])                     # [Rb, W, 3]
        beamw_d = jnp.asarray(
            ((beam_pow * omega)[widx] * maskw).astype(np.float32)
        )
        m_arr = np.arange(lmax + 1)
        Ec_d = jnp.asarray(np.cos(phi_w[..., None] * m_arr).astype(np.float32))
        Es_d = jnp.asarray(np.sin(phi_w[..., None] * m_arr).astype(np.float32))
        band_d = jnp.asarray(band)

    # Mirror-paired trig (theta -> pi - theta) halves the transcendental
    # work but adds concats/permutes, so it is opt-in via BENCH_MIRROR.
    USE_MIRROR = bool(os.environ.get("BENCH_MIRROR")) and not WINDOWED
    if USE_MIRROR:
        # theta -> pi - theta mirror: mirrored pixels share (nx, ny) and
        # negate nz, so with A = 2 pi (bx nx + by ny) and B = 2 pi bz nz
        # (constant per ring) the south-half fringe is cos/sin(A ± B) from
        # the SAME A-trig — half the transcendental work.  Sections are
        # built in mirror-paired row order (the SHT's cap groups already
        # are; the belt is permuted via perm/inv below).
        info = healpix.ring_info(NSIDE)
        beam_o = (beam_pow * omega).astype(np.float32)
        b0 = s._belt_rings[0]
        nbelt = len(s._belt_rings)
        nphi_belt = s._belt_nphi
        belt_nh = (nbelt + 1) // 2  # north rows incl the equator
        perm = np.concatenate(
            [np.arange(belt_nh), (nbelt - 1) - np.arange(belt_nh - 1)]
        )
        inv = np.empty(nbelt, np.int64)
        inv[perm] = np.arange(nbelt)

        off_n = int(info.offset[b0])
        len_n = belt_nh * nphi_belt
        vecxy_belt = vec[off_n : off_n + len_n, :2]
        z_belt = np.cos(info.theta[b0 : b0 + belt_nh]).astype(np.float32)
        beam_belt_n = beam_o[off_n : off_n + len_n].reshape(
            belt_nh, nphi_belt
        )
        beam_belt_s = np.stack(
            [
                beam_o[
                    int(info.offset[b0 + nbelt - 1 - j]) : int(
                        info.offset[b0 + nbelt - 1 - j]
                    )
                    + nphi_belt
                ]
                for j in range(belt_nh - 1)
            ]
        )

        cap_geo = []
        ring_ids = np.asarray(s._cap_rings)
        for rows_arr, w in s._cap_wgroups:
            nh = len(rows_arr) // 2
            north_rows, south_rows = rows_arr[:nh], rows_arr[nh:]
            idx_n = s._cap_idx[north_rows][:, :w]
            idx_s = s._cap_idx[south_rows][:, :w]
            mask = s._cap_mask[north_rows][:, :w] > 0
            vecxy_g = np.where(mask[..., None], vec[idx_n][:, :, :2], 0.0)
            z_g = np.cos(info.theta[ring_ids[north_rows]]).astype(np.float32)
            beam_n = np.where(mask, beam_o[idx_n], 0.0).astype(np.float32)
            beam_s = np.where(mask, beam_o[idx_s], 0.0).astype(np.float32)
            cap_geo.append((nh, w, vecxy_g.reshape(-1, 2), z_g, beam_n, beam_s))

        sec_sizes = [len_n] + [nh * w for nh, w, *_ in cap_geo]
        vecxy_all = jnp.asarray(
            np.concatenate(
                [vecxy_belt.reshape(-1, 2)]
                + [g[2] for g in cap_geo]
            ).astype(np.float32)
        )
        z_belt_d = jnp.asarray(z_belt)
        bB_n = jnp.asarray(beam_belt_n.astype(np.float32))
        bB_s = jnp.asarray(beam_belt_s.astype(np.float32))
        cap_dev = [
            (nh, w, jnp.asarray(z), jnp.asarray(bn), jnp.asarray(bs))
            for nh, w, _, z, bn, bs in cap_geo
        ]

        def ring_sections(blc, plan):
            A = 2 * jnp.pi * jnp.matmul(
                blc[:, :2], vecxy_all.T, precision=PREC
            )  # [C, nh_pix_total]
            cA, sA = jnp.cos(A), jnp.sin(A)
            bz = blc[:, 2:3]

            def halves(cAs, sAs, z, bn, bs, south_rows=None):
                B = 2 * jnp.pi * bz * z[None, :]
                cB = jnp.cos(B)[..., None]
                sB = jnp.sin(B)[..., None]
                reN = bn * (cAs * cB - sAs * sB)
                imN = bn * (sAs * cB + cAs * sB)
                sl = slice(None, south_rows)
                reS = bs * (cAs[:, sl] * cB[:, sl] + sAs[:, sl] * sB[:, sl])
                imS = bs * (sAs[:, sl] * cB[:, sl] - cAs[:, sl] * sB[:, sl])
                re = jnp.concatenate([reN, reS], axis=-2)
                im = jnp.concatenate([imN, imS], axis=-2)
                return jnp.stack([re, im])  # [2, C, rows, w]

            o = 0
            cAb = cA[:, o : o + len_n].reshape(-1, belt_nh, nphi_belt)
            sAb = sA[:, o : o + len_n].reshape(-1, belt_nh, nphi_belt)
            o += len_n
            belt_blk = halves(
                cAb, sAb, z_belt_d, bB_n, bB_s, south_rows=belt_nh - 1
            )
            cap_blks = []
            for nh, w, z, bn, bs in cap_dev:
                size = nh * w
                cAg = cA[:, o : o + size].reshape(-1, nh, w)
                sAg = sA[:, o : o + size].reshape(-1, nh, w)
                o += size
                cap_blks.append(halves(cAg, sAg, z, bn, bs))
            return s._analysis_sections(
                belt_blk, cap_blks, True, jnp.complex64, raw_belt=True,
                plan=plan,
            )

        belt_perm = jnp.asarray(perm)
        belt_inv = jnp.asarray(inv)

    elif not os.environ.get("BENCH_NO_PADDED"):
        layout = s.padded_layout()
        lclip = np.clip(layout, 0, None)
        vecp_d = jnp.asarray(
            np.where(layout[:, None] >= 0, vec[lclip], 0.0).astype(np.float32)
        )
        beamp_d = jnp.asarray(
            np.where(layout >= 0, (beam_pow * omega)[lclip], 0.0).astype(
                np.float32
            )
        )

        def ring_sections(bl_chunk, plan):
            phase = 2 * jnp.pi * jnp.matmul(bl_chunk, vecp_d.T, precision=PREC)
            re = beamp_d[None, :] * jnp.cos(phase)
            im = beamp_d[None, :] * jnp.sin(phase)
            # raw belt: the phase-weight factor is folded into S (conj)
            # and the adjoint T instead — once, outside the loop.
            return s._ring_analysis_parts_padded(
                jnp.stack([re, im]), raw_belt=True, plan=plan
            )

    else:

        def ring_sections(bl_chunk, plan):
            """Per-section ring coefficients of the [Re, Im] fringe x beam
            pair.  Analysis is linear, so F(bmap) = F[0] + i F[1] and
            F(conj bmap) = F[0] - i F[1]; no Legendre contraction happens
            here at all — see round_trip for the factorised projection."""
            phase = 2 * jnp.pi * jnp.matmul(bl_chunk, vec_d.T, precision=PREC)
            re = beam_d[None, :] * jnp.cos(phase)
            im = beam_d[None, :] * jnp.sin(phase)
            return s._ring_analysis_parts(jnp.stack([re, im]), plan=plan)

    # The ENTIRE round trip is one compiled executable: the baseline-chunk
    # streaming loops become on-device fori_loops.
    # The Legendre tensor (a 768-step sequential recurrence) is computed
    # once and passed as an ARGUMENT (so it is neither recomputed per chunk
    # nor serialised into the HLO as a constant); every SHT inside the loop
    # is then a pure batched GEMM.
    @jax.jit
    def build_legendre():
        # Pre-split per-section tensors: the analysis then contracts each
        # ring section as its own GEMM and sums partial alm — no big
        # [.., R, M+1] concatenation, row reorder or weight multiply.
        # The ring plan keeps the DFT factors as arguments: XLA rebuilds
        # loop-invariant trig constants inside fori_loop bodies otherwise.
        lam_split = s.precompute_legendre_split(jnp.float32)
        plan_ = s.precompute_ring_plan()
        return lam_split, plan_

    if WINDOWED:
        # Map each band ring to its (section, column) in the split
        # Legendre dict, so the band tensor is a cheap gather of the
        # already-built split tensors.
        belt_r0 = s._belt_rings[0]
        belt_set = set(s._belt_rings)
        cap_pos = {}  # ring -> (group index, column)
        for g, (rows_arr, _w) in enumerate(s._cap_wgroups):
            for j, row in enumerate(rows_arr):
                cap_pos[s._cap_rings[row]] = (g, j)
        src = []  # per band ring: (section key, column)
        for r in band:
            if r in belt_set:
                src.append(("belt", r - belt_r0))
            else:
                src.append(cap_pos[int(r)])
        sec_cols = {}
        for k, (sec, col) in enumerate(src):
            sec_cols.setdefault(sec, []).append((col, k))

        @jax.jit
        def build_lam_band(lam):
            parts, pos = [], []
            for sec, entries in sec_cols.items():
                cols = jnp.asarray([c for c, _ in entries])
                tensor = lam["belt"] if sec == "belt" else lam["caps"][sec]
                parts.append(jnp.take(tensor, cols, axis=2))
                pos.extend(k for _, k in entries)
            cat = jnp.concatenate(parts, axis=2)
            inv = np.empty(len(pos), np.int64)
            inv[np.asarray(pos)] = np.arange(len(pos))
            return jnp.take(cat, jnp.asarray(inv), axis=2)

    # Windowed round trip: small GEMMs, so everything runs at HIGHEST.
    # The window tensors (Ec/Es/vec/beam, ~200 MB total at nside=256) are
    # ARGUMENTS, not closure captures: captured device arrays are baked
    # into the HLO as literals, which bloats compiles and cache entries.
    @jax.jit
    def round_trip_win(sky, lam, plan, lam_band, win):
        Ec_d, Es_d, vecw_d, beamw_d = win
        HP = _lax.Precision.HIGHEST
        alm = s._analysis_impl(sky, lam=lam, plan=plan)  # [L+1, M+1]

        Sr = jnp.einsum("lm,lmr->mr", alm.real, lam_band, precision=HP)
        Si = jnp.einsum("lm,lmr->mr", alm.imag, lam_band, precision=HP)
        # a1 + i a2 = (Ec + i Es) (Sr + i Si), flattened over (ring, pix)
        a1 = (Ec_d * Sr.T[:, None, :] - Es_d * Si.T[:, None, :]).reshape(
            Rb * W, lmax + 1
        )
        a2 = (Ec_d * Si.T[:, None, :] + Es_d * Sr.T[:, None, :]).reshape(
            Rb * W, lmax + 1
        )

        def fringe(blc):
            A = 2 * jnp.pi * jnp.einsum(
                "cx,rwx->crw", blc, vecw_d, precision=HP
            )
            re = (beamw_d[None] * jnp.cos(A)).reshape(CHUNK, Rb * W)
            im = (beamw_d[None] * jnp.sin(A)).reshape(CHUNK, Rb * W)
            return re, im

        def fwd_body(c, vis_acc):
            blc = jax.lax.dynamic_slice_in_dim(bl3_pad, c * CHUNK, CHUNK, 0)
            blc = shard_bl(blc, ("b", None))
            re, im = fringe(blc)
            G1 = jnp.matmul(re, a1, precision=HP)
            G2 = jnp.matmul(im, a2, precision=HP)
            G3 = jnp.matmul(re, a2, precision=HP)
            G4 = jnp.matmul(im, a1, precision=HP)
            vp = ((G1 - G2) + 1j * (G3 + G4)).T  # F+ . S     [M+1, C]
            vm = ((G1 + G2) + 1j * (G3 - G4)).T  # conj(F-).S
            chunk = jnp.stack([vp, vm], axis=1)
            return jax.lax.dynamic_update_slice_in_dim(
                vis_acc, chunk, c * CHUNK, axis=2
            )

        vis0 = jnp.zeros((lmax + 1, 2, nchunk * CHUNK), jnp.complex64)
        vis_m = jax.lax.fori_loop(0, nchunk, fwd_body, vis0)
        bmask = (jnp.arange(nchunk * CHUNK) < npairs).astype(jnp.float32)
        vis_m = vis_m * bmask[None, None, :]

        ntime = 2 * lmax + 1
        stream = mmode.mmodes_to_sidereal(vis_m, n=ntime, oddra=True)
        vis_m2 = mmode.make_marray(stream, mmax=lmax).astype(jnp.complex64)

        # adjoint: Y[rw, m] = sum_c re (v0+v1) + i im (v1-v0);
        # T[r, m] = sum_w (Ec - i Es) Y;  a_dirty = Lambda T
        def adj_body(c, Y):
            blc = jax.lax.dynamic_slice_in_dim(bl3_pad, c * CHUNK, CHUNK, 0)
            blc = shard_bl(blc, ("b", None))
            vc = jax.lax.dynamic_slice_in_dim(vis_m2, c * CHUNK, CHUNK, 2)
            vc = shard_bl(vc, (None, None, "b"))
            re, im = fringe(blc)
            vs = (vc[:, 0] + vc[:, 1]).T  # [C, M+1]
            vd = (vc[:, 1] - vc[:, 0]).T
            Yr = jnp.matmul(re.T, vs.real, precision=HP) - jnp.matmul(
                im.T, vd.imag, precision=HP
            )
            Yi = jnp.matmul(re.T, vs.imag, precision=HP) + jnp.matmul(
                im.T, vd.real, precision=HP
            )
            return Y + jax.lax.complex(Yr, Yi)

        Y0 = jnp.zeros((Rb * W, lmax + 1), jnp.complex64)
        Y = jax.lax.fori_loop(0, nchunk, adj_body, Y0).reshape(
            Rb, W, lmax + 1
        )
        Ew = jax.lax.complex(Ec_d, -Es_d)
        T = jnp.einsum("rwm,rwm->rm", Ew, Y, precision=HP)
        a_dirty = jax.lax.complex(
            jnp.einsum("lmr,rm->lm", lam_band, T.real, precision=HP),
            jnp.einsum("lmr,rm->lm", lam_band, T.imag, precision=HP),
        )
        return s._synthesis_impl(a_dirty, lam=lam, plan=plan)

    # Factorised projection: with B = sum_r conj(F) Lambda / omega, the
    # visibilities are vis[m,b] = sum_r conj(F)[b,r,m] S[m,r] / omega where
    # S[m,r] = sum_l Lambda[l,m,r] alm_sky[l,m] is contracted ONCE — the
    # per-chunk Legendre GEMM (the dominant loop cost) disappears.  Dually
    # the adjoint accumulates T[r,m] = sum_b F[b,r,m] v[m,b] per section
    # and applies Lambda once after the loop.
    @jax.jit
    def round_trip(sky, lam, plan):
        alm = s._analysis_impl(sky, lam=lam, plan=plan)  # [L+1, M+1]

        def sky_section(lam_s):
            r = jnp.einsum("lm,lmr->mr", alm.real, lam_s, precision=PREC)
            i = jnp.einsum("lm,lmr->mr", alm.imag, lam_s, precision=PREC)
            return jax.lax.complex(r, i)

        pw = s.belt_phase_weight(jnp.complex64)  # [nbelt, M+1]
        S_belt = sky_section(lam["belt"]) * jnp.conj(pw).T  # [M+1, nbelt]
        if USE_MIRROR:
            S_belt = S_belt[:, belt_perm]  # bench mirror row order
        S_secs = [S_belt] + [sky_section(c) for c in lam["caps"]]

        def fwd_body(c, vis_acc):
            blc = jax.lax.dynamic_slice_in_dim(bl3_pad, c * CHUNK, CHUNK, 0)
            blc = shard_bl(blc, ("b", None))
            F_belt, group_F = ring_sections(blc, plan)
            # vis from the raw [Re, Im] F-stack: with U = sum conj(F0) S,
            # V = sum conj(F1) S, vp = U + iV and vm = U - iV — no
            # materialised complex F(bmap)/F(conj bmap) copies.
            vp = jnp.zeros((lmax + 1, CHUNK), jnp.complex64)
            vm = jnp.zeros((lmax + 1, CHUNK), jnp.complex64)
            for F2, S in zip([F_belt, *group_F], S_secs):
                U = jnp.einsum(
                    "crm,mr->mc", jnp.conj(F2[0]), S, precision=PREC
                )
                V = jnp.einsum(
                    "crm,mr->mc", jnp.conj(F2[1]), S, precision=PREC
                )
                vp = vp + (U + 1j * V)
                vm = vm + (U - 1j * V)
            chunk = jnp.stack([vp, vm], axis=1) * scale  # [M+1, 2, C]
            return jax.lax.dynamic_update_slice_in_dim(
                vis_acc, chunk, c * CHUNK, axis=2
            )

        vis0 = jnp.zeros((lmax + 1, 2, nchunk * CHUNK), jnp.complex64)
        vis_m = jax.lax.fori_loop(0, nchunk, fwd_body, vis0)
        # zero the padded baselines
        bmask = (jnp.arange(nchunk * CHUNK) < npairs).astype(jnp.float32)
        vis_m = vis_m * bmask[None, None, :]

        # RA round trip (simulate -> sidereal -> m-modes)
        ntime = 2 * lmax + 1
        stream = mmode.mmodes_to_sidereal(vis_m, n=ntime, oddra=True)
        vis_m2 = mmode.make_marray(stream, mmax=lmax).astype(jnp.complex64)

        sec_shapes = [lam["belt"].shape[2]] + [
            c.shape[2] for c in lam["caps"]
        ]

        def adj_body(c, T_accs):
            blc = jax.lax.dynamic_slice_in_dim(bl3_pad, c * CHUNK, CHUNK, 0)
            blc = shard_bl(blc, ("b", None))
            vc = jax.lax.dynamic_slice_in_dim(vis_m2, c * CHUNK, CHUNK, 2)
            vc = shard_bl(vc, (None, None, "b"))
            F_belt, group_F = ring_sections(blc, plan)
            # T += (F0 - iF1) v0 + (F0 + iF1) v1 = F0 (v0+v1) + iF1 (v1-v0)
            v_sum = vc[:, 0] + vc[:, 1]
            v_dif = vc[:, 1] - vc[:, 0]
            out = []
            for F2, T in zip([F_belt, *group_F], T_accs):
                T = T + jnp.einsum("crm,mc->rm", F2[0], v_sum, precision=PREC)
                T = T + 1j * jnp.einsum(
                    "crm,mc->rm", F2[1], v_dif, precision=PREC
                )
                out.append(T)
            return out

        T0 = [jnp.zeros((r, lmax + 1), jnp.complex64) for r in sec_shapes]
        T_accs = jax.lax.fori_loop(0, nchunk, adj_body, T0)

        # restore the belt row order and phase-weight on the raw accumulator
        if USE_MIRROR:
            T_accs[0] = T_accs[0][belt_inv]
        T_accs[0] = T_accs[0] * pw
        a_dirty = jnp.zeros((lmax + 1, lmax + 1), jnp.complex64)
        for T, lam_s in zip(T_accs, [lam["belt"], *lam["caps"]]):
            a_dirty = a_dirty + jax.lax.complex(
                jnp.einsum("lmr,rm->lm", lam_s, T.real, precision=PREC),
                jnp.einsum("lmr,rm->lm", lam_s, T.imag, precision=PREC),
            )
        return s._synthesis_impl(a_dirty * scale, lam=lam, plan=plan)

    # Input sky
    sky = jnp.asarray(rng.standard_normal(npix).astype(np.float32))

    log("building Legendre tensor ...")
    t0 = time.time()
    lam, plan = build_legendre()
    jax.block_until_ready((lam, plan))
    lam_band = None
    if WINDOWED:
        lam_band = build_lam_band(lam)
        lam_band.block_until_ready()
    log(f"legendre (incl. compile): {time.time() - t0:.1f}s")

    if WINDOWED:
        def run_once():
            return round_trip_win(
                sky, lam, plan, lam_band, (Ec_d, Es_d, vecw_d, beamw_d)
            )
    else:
        def run_once():
            return round_trip(sky, lam, plan)

    log("compiling + warmup ...")
    t0 = time.time()
    out = run_once()
    out.block_until_ready()
    log(f"warmup (incl. compile): {time.time() - t0:.1f}s")

    times = []
    for i in range(NRUN):
        t0 = time.time()
        out = run_once()
        out.block_until_ready()
        times.append(time.time() - t0)
        log(f"run {i}: {times[-1]:.2f}s")

    if os.environ.get("BENCH_DUMP"):
        np.save(os.environ["BENCH_DUMP"], np.asarray(out))

    wall = min(times)
    n_mmodes = (lmax + 1) * 2 * npairs
    log(f"m-modes/sec: {n_mmodes / wall:.3g}")
    assert np.isfinite(np.asarray(out)).all()

    if emit_json:
        print(
            json.dumps(
                {
                    "metric": "simulate_to_map_roundtrip_nside256_2080baselines",
                    "value": round(wall, 3),
                    "unit": "s",
                    "vs_baseline": round(60.0 / wall, 2),
                }
            )
        )
    return wall


if __name__ == "__main__":
    main()
