"""End-to-end simulate -> m-mode -> map tests (the SURVEY.md section 7 step-4 slice).

Runs the full spine: Map -> SimulateSidereal -> MModeTransform ->
mapmakers, both as direct task calls and through the YAML pipeline Manager,
and validates the numerical identities that hold exactly:

* MModeTransform(SimulateSidereal(map)) recovers the projected m-modes
  (RA round trip).
* With unit weights and noiseless data, the ML map re-projects to the
  original visibilities (B B^+ B a = B a).
* The pipeline-run products match the direct task-call products.
"""

import numpy as np
import pytest

import draco_tpu  # noqa: F401
from draco_tpu.analysis.mapmaker import (
    DirtyMapMaker,
    MaximumLikelihoodMapMaker,
    WienerMapMaker,
)
from draco_tpu.analysis.transform import MModeInverseTransform, MModeTransform
from draco_tpu.core import containers
from draco_tpu.ops.tools import device_to_numpy
from draco_tpu.ops import healpix, sht
from draco_tpu.synthesis.stream import ExpandProducts, SimulateSidereal
from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray


@pytest.fixture(scope="module")
def small_setup():
    tel = UnpolarisedDishArray(
        grid_ew=2,
        grid_ns=2,
        spacing_ew=5.0,
        spacing_ns=5.0,
        latitude=40.0,
        freq_lower=400.0,
        freq_upper=420.0,
        num_freq=2,
        dish_width=5.0,
        auto_correlations=True,
        force_lmax=23,
        force_mmax=23,
    )
    bt = BeamTransfer(telescope=tel).generate()

    # Band-limited random sky
    rng = np.random.Generator(np.random.SFC64(99))
    nside = bt.beam_nside
    lmax = tel.lmax
    alm = rng.standard_normal((lmax + 1, lmax + 1)) + 1j * rng.standard_normal(
        (lmax + 1, lmax + 1)
    )
    for ell in range(lmax + 1):
        alm[ell, ell + 1 :] = 0
    alm[:, 0] = alm[:, 0].real
    sky = np.asarray(sht.alm2map(alm, nside))

    m = containers.Map(
        nside=nside, polarisation=False, freq=tel.frequencies
    )
    m.map[:] = np.broadcast_to(sky, (tel.nfreq, 1, len(sky)))
    return tel, bt, m, alm


def _simulate(tel, bt, m):
    task = SimulateSidereal()
    task.read_config({})
    task.setup(bt)
    return task.process(m)


def test_simulate_sidereal(small_setup):
    tel, bt, m, alm = small_setup
    ss = _simulate(tel, bt, m)
    assert isinstance(ss, containers.SiderealStream)
    ntime = 2 * tel.mmax + 1
    assert ss.vis.shape == (tel.nfreq, tel.npairs, ntime)
    vis = np.asarray(ss.vis[:])
    assert np.isfinite(vis).all()
    assert np.abs(vis).max() > 0


def test_simulate_sidereal_fast_ra(small_setup):
    """Smooth-size RA padding changes the grid but not the m-mode content."""
    from draco_tpu.ops import mmode

    tel, bt, m, alm = small_setup
    task = SimulateSidereal()
    task.read_config({"fast_ra": True})
    task.setup(bt)
    ss = task.process(m)
    ntime = mmode.fast_fft_size(2 * tel.mmax + 1)
    assert ss.vis.shape == (tel.nfreq, tel.npairs, ntime)

    mt = MModeTransform()
    mt.read_config({})
    mt.setup(tel)
    ma = mt.process(ss)

    ss_ref = _simulate(tel, bt, m)
    mt2 = MModeTransform()
    mt2.read_config({})
    mt2.setup(tel)
    ma_ref = mt2.process(ss_ref)
    a, b = np.asarray(ma.vis[:]), np.asarray(ma_ref.vis[:])
    assert np.allclose(a, b, atol=2e-5 * np.abs(b).max())


def test_mmode_roundtrip_through_tasks(small_setup):
    """Forward m-mode transform of the simulated stream == direct projection."""
    tel, bt, m, alm = small_setup
    ss = _simulate(tel, bt, m)

    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)
    assert isinstance(ma, containers.MModes)
    assert ma.mmax == tel.mmax
    assert ma.oddra  # ntime = 2 mmax + 1 is odd

    # direct projection truth
    alm_in = device_to_numpy(sht.sphtrans_sky(np.asarray(m.map[:]), lmax=tel.lmax))
    alm_in = alm_in[..., : tel.mmax + 1]
    vis_m = device_to_numpy(bt.project_sky_to_telescope(alm_in))
    got = np.asarray(ma.vis[:])
    assert np.allclose(got, vis_m, atol=2e-5 * np.abs(vis_m).max())

    # inverse transform returns the sidereal stream
    mi = MModeInverseTransform()
    mi.read_config({})
    ss2 = mi.process(ma)
    assert np.allclose(
        np.asarray(ss2.vis[:]),
        np.asarray(ss.vis[:]),
        atol=2e-5 * np.abs(np.asarray(ss.vis[:])).max(),
    )


def test_ml_map_reprojects_to_data(small_setup):
    """B a_ML == v for noiseless unit-weight data (pseudo-inverse identity).

    The alm solved by the ML maker is projected straight back through the
    beam transfer (avoiding the lossy healpix quadrature round trip, which
    is tested separately in test_sht).
    """
    tel, bt, m, alm = small_setup
    ss = _simulate(tel, bt, m)
    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)

    mm = MaximumLikelihoodMapMaker()
    mm.read_config({"nside": bt.beam_nside, "rcond": 1e-6, "acond": 1e-9})
    mm.setup(bt)
    out_map = mm.process(ma)
    assert isinstance(out_map, containers.Map)

    # Run the solver internals to get the ML alm and reproject.
    import jax.numpy as jnp

    from draco_tpu.ops.tools import as_device

    mmax = tel.mmax
    vis = np.asarray(ma.vis[:]).reshape(mmax + 1, 2, tel.nfreq, tel.npairs)
    weight = np.asarray(ma.weight[:]).reshape(mmax + 1, 2, tel.nfreq, tel.npairs)
    a_ml = mm._solve_all_m(
        as_device(vis), jnp.asarray(weight), list(range(tel.nfreq)), mmax
    )
    v2 = device_to_numpy(bt.project_sky_to_telescope(a_ml))
    v1 = vis
    # complex64 SVD limits the identity to ~1e-3 relative
    assert np.allclose(v2, v1, atol=1e-3 * np.abs(v1).max())


def test_dirty_and_wiener_maps(small_setup):
    tel, bt, m, alm = small_setup
    ss = _simulate(tel, bt, m)
    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)

    for maker_cls, cfg in [
        (DirtyMapMaker, {}),
        (WienerMapMaker, {"prior_amp": 10.0}),
    ]:
        maker = maker_cls()
        maker.read_config({**cfg, "nside": bt.beam_nside})
        maker.setup(bt)
        out = maker.process(ma)
        arr = np.asarray(out.map[:])
        assert arr.shape == (tel.nfreq, 1, healpix.npix_of(bt.beam_nside))
        assert np.isfinite(arr).all()
        assert np.abs(arr).max() > 0


def test_expand_products(small_setup):
    tel, bt, m, alm = small_setup
    ss = _simulate(tel, bt, m)
    ep = ExpandProducts()
    ep.read_config({})
    ep.setup(tel)
    full = ep.process(ss)
    nprod = tel.nfeed * (tel.nfeed + 1) // 2
    assert full.vis.shape[1] == nprod
    # each product equals its unique-baseline source (conjugated as needed)
    vis_s = np.asarray(ss.vis[:])
    vis_f = np.asarray(full.vis[:])
    prod = full.index_map["prod"]
    for pi in range(nprod):
        a, b = int(prod[pi]["input_a"]), int(prod[pi]["input_b"])
        ui = tel.feedmap[a, b]
        expect = vis_s[:, ui]
        if tel.feedconj[a, b]:
            expect = expect.conj()
        assert np.allclose(vis_f[:, pi], expect, atol=1e-6)


def test_composite_pipeline_yaml(small_setup, tmp_path):
    """The CHIME-scale COMPOSITE chain at reduced scale: sim + gain
    fluctuations + Wishart noise through the m-mode spine, as one YAML
    pipeline (the BASELINE.json scale-up config; reference
    test/pipe_config.yaml:29-83 chain, sidereal-native)."""
    tel, bt, m, alm = small_setup
    bt_dir = str(tmp_path / "bt")
    bt.save(bt_dir)
    map_file = str(tmp_path / "sky.h5")
    m.attrs["tag"] = "sky"
    m.save(map_file)

    # Direct noiseless chain (sim -> expand -> recv_temp -> m-modes ->
    # map) for the comparison target and the receiver temperature: the
    # autos must dominate the sky cross terms for the Wishart
    # expectation matrix to be positive definite (the reference chain
    # likewise puts ReceiverTemperature before SampleNoise,
    # reference test/pipe_config.yaml:55).
    ss = _simulate(tel, bt, m)
    ep = ExpandProducts()
    ep.read_config({})
    ep.setup(tel)
    ss_full = ep.process(ss)
    recv_temp = 10.0 * float(np.abs(np.asarray(ss_full.vis[:])).max())

    cfg = f"""
pipeline:
  tasks:
    - type: draco.core.io.LoadBeamTransfer
      out: [tel, btm]
      params:
        product_directory: "{bt_dir}"
    - type: draco.core.io.LoadMaps
      out: imap
      params:
        maps:
          files: ["{map_file}"]
          tag: testmap
    - type: draco.synthesis.stream.SimulateSidereal
      requires: btm
      in: imap
      out: sstream
    - type: draco.synthesis.stream.ExpandProducts
      requires: tel
      in: sstream
      out: sstream_full
    - type: draco.synthesis.noise.ReceiverTemperature
      in: sstream_full
      out: sstream_rt
      params:
        recv_temp: {recv_temp}
    - type: draco.synthesis.gain.RandomSiderealGains
      requires: [tel, sstream_rt]
      out: gain_fluc
      params:
        seed: 7
        start_time: 2015-10-05 12:15:00
        end_time: 2015-10-06 12:15:00
        sigma_amp: 0.001
        sigma_phase: 0.001
    - type: draco.analysis.calibration.ApplyGain
      in: [sstream_rt, gain_fluc]
      out: sstream_gain
      params:
        inverse: false
    - type: draco.synthesis.noise.SampleNoise
      in: sstream_gain
      out: sstream_noise
      params:
        seed: 8
        sample_frac: 1.0e-6
        # keep unit weights: the dirty map scales with the absolute
        # weight normalisation, so radiometer weights here would defeat
        # the noiseless-map comparison below (weight setting itself is
        # unit-tested in test_synthesis.py)
        set_weights: false
    - type: draco.analysis.transform.CollateProducts
      requires: btm
      in: sstream_noise
      out: sstream_coll
    - type: draco.analysis.transform.MModeTransform
      requires: tel
      in: sstream_coll
      out: mmodes
    - type: draco.analysis.mapmaker.DirtyMapMaker
      requires: btm
      in: mmodes
      out: dmap
      params:
        nside: {bt.beam_nside}
"""
    from draco_tpu.core.pipeline import Manager

    products = Manager.from_yaml_str(cfg).run()
    assert len(products["dmap"]) == 1

    # Noiseless target: the same chain without gains/noise.
    from draco_tpu.synthesis.noise import ReceiverTemperature

    rt = ReceiverTemperature()
    rt.read_config({"recv_temp": recv_temp})
    ss_rt = rt.process(ss_full)
    from draco_tpu.analysis.transform import CollateProducts

    cp = CollateProducts()
    cp.read_config({})
    cp.setup(bt)
    ss_rt = cp.process(ss_rt)
    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    dm = DirtyMapMaker()
    dm.read_config({"nside": bt.beam_nside})
    dm.setup(bt)
    clean = np.asarray(dm.process(mt.process(ss_rt)).map[:])
    noisy = np.asarray(products["dmap"][0].map[:])
    assert np.isfinite(noisy).all()
    # sample_frac=1e-6 -> nsamp ~ 2e4 -> per-element Wishart scatter
    # well under a percent of the recv_temp-scale autos; the 0.1% gain
    # wander is smaller still.
    scale = np.abs(clean).max()
    assert np.abs(noisy - clean).max() < 0.2 * scale
    assert not np.allclose(noisy, clean, atol=1e-9 * scale)  # noise injected


def test_full_pipeline_yaml(small_setup, tmp_path):
    """The whole slice through the YAML pipeline Manager."""
    tel, bt, m, alm = small_setup
    bt_dir = str(tmp_path / "bt")
    bt.save(bt_dir)
    map_file = str(tmp_path / "sky.h5")
    m.attrs["tag"] = "sky"
    m.save(map_file)

    cfg = f"""
pipeline:
  tasks:
    - type: draco.core.io.LoadBeamTransfer
      out: [tel, btm]
      params:
        product_directory: "{bt_dir}"
    - type: draco.core.io.LoadMaps
      out: imap
      params:
        maps:
          files: ["{map_file}"]
          tag: testmap
    - type: draco.synthesis.stream.SimulateSidereal
      requires: btm
      in: imap
      out: sstream
    - type: draco.analysis.transform.MModeTransform
      in: sstream
      out: mmodes
    - type: draco.analysis.mapmaker.DirtyMapMaker
      requires: btm
      in: mmodes
      out: dmap
      params:
        nside: {bt.beam_nside}
        save: true
        output_name: "{tmp_path}/dirty_{{tag}}.h5"
"""
    from draco_tpu.core.pipeline import Manager

    products = Manager.from_yaml_str(cfg).run()
    assert len(products["dmap"]) == 1

    # Direct-call comparison
    ss = _simulate(tel, bt, m)
    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)
    dm = DirtyMapMaker()
    dm.read_config({"nside": bt.beam_nside})
    dm.setup(bt)
    direct = np.asarray(dm.process(ma).map[:])
    piped = np.asarray(products["dmap"][0].map[:])
    assert np.allclose(piped, direct, atol=1e-5 * max(np.abs(direct).max(), 1))

    # Saved output exists and has provenance
    loaded = containers.ContainerBase.from_file(
        str(tmp_path / "dirty_testmap.h5")
    )
    assert "config" in loaded.history


def test_make_time_stream_interpolates(small_setup):
    """MakeTimeStream Lanczos-samples a sidereal stream at target times.

    A single smooth RA mode must reproduce its analytic value at the
    interpolated times (reference stream.py:249-343), and weights must
    stay positive through the inverse-variance combination.
    """
    from draco_tpu.synthesis.stream import MakeTimeStream

    tel, bt, m, alm = small_setup
    nra = 64
    ss = containers.SiderealStream(
        freq=tel.frequencies, input=tel.nfeed, ra=nra
    )
    ra = np.asarray(ss.ra[:], dtype=np.float64)
    sig = np.exp(2j * np.pi * ra / 360.0).astype(np.complex64)
    ss.vis[:] = sig[None, None, :]
    ss.weight[:] = 2.0
    ss.attrs["lsd"] = 1234

    times = tel.lsd_to_unix(1234 + np.linspace(0.1, 0.9, 11))
    ts = containers.TimeStream(axes_from=ss, time=times)

    task = MakeTimeStream()
    task.read_config({"lanczos_width": 5})
    task.setup(tel)
    out = task.process(ss, ts)

    tra = np.asarray(tel.unix_to_lsa(times))
    expect = np.exp(2j * np.pi * tra / 360.0)
    got = np.asarray(out.vis[:])
    assert got.shape == (tel.nfreq, ss.vis.shape[1], len(times))
    np.testing.assert_allclose(got[0, 0], expect, rtol=0, atol=5e-3)
    assert np.all(np.asarray(out.weight[:]) > 0)
