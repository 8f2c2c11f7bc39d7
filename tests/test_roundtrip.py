"""Fused simulate->map round trip vs the composed streaming stages."""

import numpy as np
import pytest

import jax.numpy as jnp

from draco_tpu.core import containers
from draco_tpu.ops import healpix, mmode, sht
from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray
from draco_tpu.telescope.roundtrip import SimulateAndMap, fused_simulate_to_map


@pytest.fixture(scope="module")
def compact_setup():
    nside = 16
    tel = UnpolarisedDishArray(
        grid_ew=2,
        grid_ns=2,
        spacing_ew=4.0,
        spacing_ns=4.0,
        latitude=30.0,
        freq_lower=400.0,
        freq_upper=500.0,
        num_freq=2,
        dish_width=8.0,  # narrow beam -> windowed projection applies
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    if bt._beam_window() is None:
        pytest.skip("beam not compact enough for the windowed path")
    rng = np.random.Generator(np.random.SFC64(11))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(nside))).astype(
        np.float32
    )
    return tel, bt, sky


def _composed_roundtrip(bt, tel, sky):
    """The same spine as separate streaming dispatches."""
    from draco_tpu.ops.tools import as_device, device_to_numpy

    alm = sht.sphtrans_sky(jnp.asarray(sky), lmax=tel.lmax)[..., : tel.mmax + 1]
    vis_m = device_to_numpy(bt.project_sky_to_telescope_streaming(alm))
    ntime = 2 * tel.mmax + 1
    stream = mmode.mmodes_to_sidereal(as_device(vis_m), n=ntime, oddra=True)
    vis2 = device_to_numpy(mmode.make_marray(stream, mmax=tel.mmax))
    a = bt.project_telescope_to_sky_dirty_streaming(
        vis2, np.ones_like(vis2.real)
    )
    return np.asarray(sht.sphtrans_inv_sky(a, healpix.nside_of(sky.shape[-1])))


def test_fused_matches_composed_stages(compact_setup):
    tel, bt, sky = compact_setup
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_fused_chunk_invariance(compact_setup):
    tel, bt, sky = compact_setup
    a = np.asarray(fused_simulate_to_map(bt, sky, chunk=3))
    b = np.asarray(fused_simulate_to_map(bt, sky, chunk=10))
    assert np.allclose(a, b, atol=1e-5 * np.abs(a).max())


def test_fused_weighting(compact_setup):
    tel, bt, sky = compact_setup
    nbase = len(tel.uniquepairs)
    w = np.full((tel.mmax + 1, 2, tel.nfreq, nbase), 0.5, np.float32)
    half = np.asarray(fused_simulate_to_map(bt, sky, chunk=4, weight=w))
    unit = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    assert np.allclose(half, 0.5 * unit, atol=1e-6 * np.abs(unit).max())


def test_fused_structured_weighting(compact_setup):
    """Per-(m, msign, freq, baseline) weights match the composed chain.

    A uniform weight cannot catch msign swaps or m/baseline slicing
    misalignment in the fused single-pass weight application; random
    structured weights pin the exact layout.
    """
    tel, bt, sky = compact_setup
    nbase = len(tel.uniquepairs)
    rng = np.random.Generator(np.random.SFC64(23))
    w = rng.uniform(0.0, 2.0, (tel.mmax + 1, 2, tel.nfreq, nbase)).astype(
        np.float32
    )

    alm = sht.sphtrans_sky(jnp.asarray(sky), lmax=tel.lmax)[..., : tel.mmax + 1]
    vis_m = np.asarray(bt.project_sky_to_telescope_streaming(alm))
    a = bt.project_telescope_to_sky_dirty_streaming(vis_m, w)
    want = np.asarray(
        sht.sphtrans_inv_sky(a, healpix.nside_of(sky.shape[-1]))
    )

    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=4, weight=w))
    assert np.allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_mcut_truncation_is_exact(compact_setup, monkeypatch):
    """m-support GEMM truncation changes nothing beyond float noise.

    The compact fixture's short baselines have m-support far below mmax,
    so the sorted/grouped program genuinely truncates; the result must
    match the untruncated program at float-epsilon level (the dropped
    columns carry only Bessel-tail power).
    """
    import os

    tel, bt, sky = compact_setup

    bt.__dict__.pop("_fused_fns", None)
    monkeypatch.setitem(os.environ, "DRACO_TPU_MCUT_MARGIN", "-1")
    full = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))

    bt.__dict__.pop("_fused_fns", None)
    monkeypatch.setitem(os.environ, "DRACO_TPU_MCUT_MARGIN", "64")
    trunc = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))

    # default (env unset): margin derived from the measured beam
    # azimuthal band width — must also be float-exact
    monkeypatch.delitem(os.environ, "DRACO_TPU_MCUT_MARGIN", raising=False)
    auto = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    bt.__dict__.pop("_fused_fns", None)

    assert np.allclose(trunc, full, atol=2e-6 * np.abs(full).max())
    assert np.allclose(auto, full, atol=2e-6 * np.abs(full).max())


def test_fused_many_frequency_rotation_accuracy():
    """Phasor-rotation error stays in budget over an 8-frequency batch.

    On a uniform grid the fringe for frequency f is the base fringe
    rotated f times by the per-step phasor, so rounding accumulates
    linearly in nfreq; check the fused program still matches the
    composed streaming stages (which build each frequency's phase
    exactly) at the standard 2e-5 tolerance for the largest frequency
    batch the bench uses.
    """
    nside = 16
    tel = UnpolarisedDishArray(
        grid_ew=2,
        grid_ns=2,
        spacing_ew=4.0,
        spacing_ns=4.0,
        latitude=30.0,
        freq_lower=400.0,
        freq_upper=500.0,
        num_freq=8,
        dish_width=8.0,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    if bt._beam_window() is None:
        pytest.skip("beam not compact enough for the windowed path")
    rng = np.random.Generator(np.random.SFC64(29))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(nside))).astype(
        np.float32
    )
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    # per-frequency comparison so one bad rotation cannot hide in the norm
    for f in range(tel.nfreq):
        assert np.allclose(
            got[f], want[f], atol=2e-5 * np.abs(want[f]).max()
        ), f"frequency {f} out of tolerance"


def test_fused_nonuniform_freq_grid():
    """A non-uniform frequency grid takes the per-frequency phase path.

    The fringe builder normally exploits the arithmetic progression of
    phases on an evenly spaced grid (one complex rotation per extra
    frequency); irregular channel centres must fall back to explicit
    per-frequency phases and still match the composed streaming stages.
    """
    from draco_tpu.telescope.roundtrip import _baseline_prep

    class _IrregularDish(UnpolarisedDishArray):
        @property
        def frequencies(self):
            return np.array([400.0, 431.0, 487.0])

    nside = 16
    tel = _IrregularDish(
        grid_ew=2,
        grid_ns=2,
        spacing_ew=4.0,
        spacing_ns=4.0,
        latitude=30.0,
        freq_lower=400.0,
        freq_upper=487.0,
        num_freq=3,
        dish_width=8.0,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    nbase = len(tel.uniquepairs)
    *_, uniform = _baseline_prep(tel, tel.nfreq, nbase, chunk=4)
    assert uniform is False

    bt = BeamTransfer(telescope=tel, nside=nside)
    if bt._beam_window() is None:
        pytest.skip("beam not compact enough for the windowed path")
    rng = np.random.Generator(np.random.SFC64(23))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(nside))).astype(
        np.float32
    )
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    assert np.allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_simulate_and_map_task(compact_setup):
    tel, bt, sky = compact_setup
    m = containers.Map(
        nside=healpix.nside_of(sky.shape[-1]),
        polarisation=False,
        freq=tel.frequencies,
    )
    m.map[:] = sky

    task = SimulateAndMap()
    task.read_config({"baseline_chunk": 5})
    task.setup(bt)
    out = task.process(m)
    assert isinstance(out, containers.Map)
    want = np.asarray(fused_simulate_to_map(bt, sky, chunk=5))
    assert np.allclose(np.asarray(out.map[:]), want, atol=1e-6)


@pytest.fixture(scope="module")
def cylinder_setup():
    from draco_tpu.telescope import UnpolarisedCylinderTelescope

    nside = 16
    tel = UnpolarisedCylinderTelescope(
        num_cylinders=2,
        cylinder_width=10.0,
        cylinder_spacing=12.0,
        num_feeds=3,
        feed_spacing=2.0,
        latitude=45.0,
        freq_lower=400.0,
        freq_upper=500.0,
        num_freq=2,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    assert bt._beam_window() is None, "cylinder beam should not be windowable"
    rng = np.random.Generator(np.random.SFC64(21))
    sky = rng.standard_normal((tel.nfreq, 1, healpix.npix_of(nside))).astype(
        np.float32
    )
    return tel, bt, sky


def test_fused_fullsphere_matches_composed_stages(cylinder_setup):
    """Cylinder (non-windowable) telescopes run the full-sphere fused
    program; must equal the composed streaming stages."""
    tel, bt, sky = cylinder_setup
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=4))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=3e-5 * np.abs(want).max())


def test_fused_fullsphere_weighting(cylinder_setup):
    tel, bt, sky = cylinder_setup
    nbase = len(tel.uniquepairs)
    w = np.full((tel.mmax + 1, 2, tel.nfreq, nbase), 2.0, np.float32)
    twice = np.asarray(fused_simulate_to_map(bt, sky, chunk=5, weight=w))
    unit = np.asarray(fused_simulate_to_map(bt, sky, chunk=5))
    assert np.allclose(twice, 2.0 * unit, atol=1e-5 * np.abs(unit).max())


@pytest.fixture(scope="module")
def polarised_setup():
    from draco_tpu.core import config as cfg
    from draco_tpu.telescope import SimplePolarisedTelescope

    class PolDishes(SimplePolarisedTelescope):
        """Four dual-pol dishes on a line (X feeds then Y feeds)."""

        @property
        def feedpositions(self):
            xy = np.array([[0.0, 0.0], [5.0, 1.0], [1.0, 6.0], [6.0, 5.5]])
            return np.concatenate([xy, xy], axis=0)  # X block + Y block

        @property
        def beamclass(self):
            return np.array([0, 0, 0, 0, 1, 1, 1, 1])

    nside = 16
    tel = PolDishes(
        latitude=30.0,
        freq_lower=400.0,
        freq_upper=500.0,
        num_freq=2,
        dish_width=8.0,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    rng = np.random.Generator(np.random.SFC64(31))
    sky = rng.standard_normal((tel.nfreq, 4, healpix.npix_of(nside))).astype(
        np.float32
    )
    return tel, bt, sky


def test_fused_polarised_matches_composed_stages(polarised_setup):
    """npol=4 exercises the complex multi-beamclass gather path."""
    tel, bt, sky = polarised_setup
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=7))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=3e-5 * np.abs(want).max())


def test_fused_freq_sharded_mesh(compact_setup):
    """Frequencies are embarrassingly parallel: the fused program under a
    freq-sharded mesh (the pod layout the north-star projection assumes)
    must match the single-placement run."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from draco_tpu.parallel import make_mesh2d, use_mesh
    from draco_tpu.telescope.roundtrip import fused_roundtrip_fn

    tel, bt, _ = compact_setup
    nside = bt.beam_nside
    rng = np.random.Generator(np.random.SFC64(17))
    # 8 frequencies so the axis divides the mesh
    tel8 = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=4.0, spacing_ns=4.0,
        latitude=30.0, freq_lower=400.0, freq_upper=500.0, num_freq=8,
        dish_width=8.0, auto_correlations=True,
        force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
    )
    bt8 = BeamTransfer(telescope=tel8, nside=nside)
    sky = rng.standard_normal(
        (8, 1, healpix.npix_of(nside))
    ).astype(np.float32)

    ref = np.asarray(fused_roundtrip_fn(bt8, chunk=5)(jnp.asarray(sky)))

    mesh = make_mesh2d(shape=(8, 1), axis_names=("freq", "m"))
    with use_mesh(mesh):
        run = fused_roundtrip_fn(bt8, chunk=5)
        sky_sh = jax.device_put(
            jnp.asarray(sky), NamedSharding(mesh, P("freq", None, None))
        )
        got = np.asarray(run(sky_sh))

    assert np.allclose(ref, got, atol=1e-5 * np.abs(ref).max())


def test_fused_paths_support_x64(tmp_path):
    """Both fused programs must run under jax_enable_x64.

    The f64 placement is how truth maps for the accuracy policy are
    produced (scripts/check_accuracy_production.py); the accumulator dtypes
    must follow the input dtype rather than pin complex64 (a pinned
    accumulator raises a fori_loop carry-type mismatch under x64).
    Runs in a subprocess because x64 is a process-global switch.
    """
    import subprocess
    import sys
    import textwrap

    prog = textwrap.dedent(
        """
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import numpy as np
        import jax.numpy as jnp
        from draco_tpu.ops import healpix
        from draco_tpu.telescope import (
            BeamTransfer, UnpolarisedCylinderTelescope, UnpolarisedDishArray
        )
        from draco_tpu.telescope.roundtrip import fused_simulate_to_map

        nside = 8
        rng = np.random.Generator(np.random.SFC64(3))
        sky = rng.standard_normal((1, 1, healpix.npix_of(nside)))

        # full-sphere program (cylinder)
        tel = UnpolarisedCylinderTelescope(
            num_cylinders=2, cylinder_width=10.0, cylinder_spacing=12.0,
            num_feeds=2, feed_spacing=2.0, latitude=45.0,
            freq_lower=400.0, freq_upper=400.0, num_freq=1,
            auto_correlations=True,
            force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
        )
        bt = BeamTransfer(telescope=tel, nside=nside)
        out = np.asarray(fused_simulate_to_map(bt, jnp.asarray(sky), chunk=2))
        assert out.dtype == np.float64, out.dtype
        assert np.isfinite(out).all()

        # windowed program (compact dish beam)
        tel2 = UnpolarisedDishArray(
            grid_ew=2, grid_ns=1, spacing_ew=4.0, spacing_ns=4.0,
            latitude=30.0, freq_lower=400.0, freq_upper=400.0, num_freq=1,
            dish_width=8.0, auto_correlations=True,
            force_lmax=3 * nside - 1, force_mmax=3 * nside - 1,
        )
        bt2 = BeamTransfer(telescope=tel2, nside=nside)
        assert bt2._beam_window() is not None
        out2 = np.asarray(fused_simulate_to_map(bt2, jnp.asarray(sky), chunk=2))
        assert out2.dtype == np.float64, out2.dtype
        assert np.isfinite(out2).all()
        print("x64 ok")
        """
    )
    r = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "x64 ok" in r.stdout


def test_fused_polarised_cylinder_matches_composed_stages():
    """Dual-pol cylinders (the BASELINE scale-up instrument class) run the
    full-sphere fused path with a T/Q/U/V sky and must match the composed
    streaming stages — covers the polarised + full-sphere + redundancy-
    stacked combination the 2048-feed bench extra measures."""
    from draco_tpu.telescope import PolarisedCylinderTelescope

    nside = 16
    f0 = 299.792458 / 0.6
    tel = PolarisedCylinderTelescope(
        num_cylinders=2,
        cylinder_width=20.0,
        cylinder_spacing=22.0,
        num_feeds=3,
        feed_spacing=0.5,
        latitude=49.0,
        freq_lower=f0,
        freq_upper=f0,
        num_freq=1,
        auto_correlations=True,
        force_lmax=3 * nside - 1,
        force_mmax=3 * nside - 1,
    )
    bt = BeamTransfer(telescope=tel, nside=nside)
    assert tel.num_pol_sky == 4
    rng = np.random.Generator(np.random.SFC64(37))
    sky = rng.standard_normal((1, 4, healpix.npix_of(nside))).astype(
        np.float32
    )
    want = _composed_roundtrip(bt, tel, sky)
    got = np.asarray(fused_simulate_to_map(bt, sky, chunk=7))
    assert got.shape == want.shape
    assert np.allclose(got, want, atol=3e-5 * np.abs(want).max())


def test_freq_tiled_matches_full():
    """fused_simulate_to_map_tiled == the full-batch program.

    The HBM-bound tiling path (round 3): every tile shares one compiled
    program; per-tile constants (beam products, baseline phase
    coefficients) are rebuilt per frequency window.
    """
    import numpy as np

    from draco_tpu.ops import healpix
    from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray
    from draco_tpu.telescope.roundtrip import (
        fused_simulate_to_map,
        fused_simulate_to_map_tiled,
    )

    f0 = 299.792458 / 0.6
    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=7.0, spacing_ns=7.0,
        jitter=1.0, jitter_seed=1, latitude=45.0, dish_width=5.0,
        fwhm_factor=1.0, freq_lower=f0 * 0.95, freq_upper=f0 * 1.05,
        num_freq=4, auto_correlations=True, force_lmax=47, force_mmax=47,
    )
    bt = BeamTransfer(telescope=tel, nside=16)
    rng = np.random.default_rng(0)
    sky = rng.standard_normal((4, 1, healpix.npix_of(16))).astype(np.float32)

    full = np.asarray(fused_simulate_to_map(bt, sky, chunk=8))
    tiled = np.asarray(
        fused_simulate_to_map_tiled(bt, sky, freq_tile=2, chunk=8)
    )
    err = np.abs(tiled - full).max() / np.abs(full).max()
    assert err < 2e-5

    import pytest

    with pytest.raises(ValueError, match="does not divide"):
        fused_simulate_to_map_tiled(bt, sky, freq_tile=3, chunk=8)
