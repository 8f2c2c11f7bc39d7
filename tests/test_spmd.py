"""SPMD consistency: sharded pipeline stages equal the unsharded results.

The reference distributes containers over freq/m ranks with MPI; the
equivalents here are NamedSharding placements on a mesh.  These tests run
the m-mode spine with freq- and m-sharded arrays on the 8-virtual-device
CPU mesh and require bit-level agreement with the single-placement run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from draco_tpu.core import containers
from draco_tpu.ops import sht
from draco_tpu.synthesis.stream import SimulateSidereal
from draco_tpu.telescope import BeamTransfer, UnpolarisedDishArray


@pytest.fixture(scope="module")
def setup():
    tel = UnpolarisedDishArray(
        grid_ew=2, grid_ns=2, spacing_ew=5.0, spacing_ns=5.0, latitude=40.0,
        freq_lower=400.0, freq_upper=440.0, num_freq=8,  # divisible by 8
        dish_width=5.0, auto_correlations=True, force_lmax=23, force_mmax=23,
    )
    bt = BeamTransfer(telescope=tel).generate()

    rng = np.random.Generator(np.random.SFC64(3))
    nside = bt.beam_nside
    m = containers.Map(nside=nside, polarisation=False, freq=tel.frequencies)
    m.map[:] = rng.standard_normal(m.map.shape).astype(np.float64)
    return tel, bt, m


def test_freq_sharded_sht_matches(setup, mesh8):
    """SHT of freq-sharded maps == unsharded SHT."""
    tel, bt, m = setup
    s = sht.get_sht(bt.beam_nside, tel.lmax, tel.mmax)

    maps = jnp.asarray(np.asarray(m.map[:])[:, 0, :].astype(np.float32))

    a_ref = np.asarray(s._analysis_j(maps))

    sharded = jax.device_put(maps, NamedSharding(mesh8, P("shard", None)))
    a_shard = np.asarray(s._analysis_j(sharded))

    assert np.allclose(a_ref, a_shard, atol=1e-6)


def test_m_sharded_projection_matches(setup, mesh8):
    """Beam-transfer projection with m-sharded operators == unsharded."""
    tel, bt, m = setup
    s = sht.get_sht(bt.beam_nside, tel.lmax, tel.mmax)

    maps = jnp.asarray(np.asarray(m.map[:])[:, 0, :].astype(np.float32))
    alm = s._analysis_j(maps)[:, None]  # [freq, pol, L+1, M+1]

    ref = np.asarray(bt.project_sky_to_telescope(alm))

    # Shard the beam tensors and the alm over m (the reference's
    # m-distributed solve layout) and repeat
    bp_s = jax.device_put(bt._bp, NamedSharding(mesh8, P(None, None, None, None, "shard")))
    alm_s = jax.device_put(alm, NamedSharding(mesh8, P(None, None, None, "shard")))

    bt2 = BeamTransfer(telescope=tel)
    bt2._bp = bp_s
    bt2._bm = jax.device_put(
        bt._bm, NamedSharding(mesh8, P(None, None, None, None, "shard"))
    )
    out = np.asarray(bt2.project_sky_to_telescope(alm_s))

    assert np.allclose(ref, out, atol=1e-6)


def test_simulate_with_sharded_containers(setup, mesh8):
    """SimulateSidereal after container redistribute == default placement."""
    tel, bt, m = setup

    sim = SimulateSidereal()
    sim.read_config({})
    sim.setup(bt)
    ss_ref = sim.process(m)

    m2 = m.copy()
    m2.redistribute("freq")
    sim2 = SimulateSidereal()
    sim2.read_config({})
    sim2.setup(bt)
    ss_shard = sim2.process(m2)

    assert np.allclose(
        np.asarray(ss_ref.vis[:]), np.asarray(ss_shard.vis[:]), atol=1e-5
    )


def test_bench_baseline_sharding_matches(tmp_path):
    """bench.py's baseline-data-parallel path equals the unsharded run.

    Runs the full chunked round trip twice at toy scale on the 8-virtual-
    device CPU mesh (BENCH_SHARD=8) and single placement, comparing maps.
    """
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for shard in (0, 8):
        dump = tmp_path / f"map_{shard}.npy"
        env = dict(
            os.environ,
            XLA_FLAGS="--xla_force_host_platform_device_count=8",
            BENCH_PLATFORM="cpu",
            BENCH_NSIDE="16",
            BENCH_NFEED_SIDE="2",
            BENCH_CHUNK="8",
            # both runs take the legacy spine (explicitly: BENCH_SHARD=0
            # alone selects the library fused path)
            BENCH_LEGACY="1",
            BENCH_SHARD=str(shard),
            BENCH_NRUN="1",
            BENCH_DUMP=str(dump),
        )
        subprocess.run(
            [sys.executable, os.path.join(repo, "bench.py")],
            check=True,
            env=env,
            cwd=repo,
            capture_output=True,
        )
        outs[shard] = np.load(dump)

    assert np.allclose(outs[0], outs[8], atol=1e-6)


def _run_sim_to_map(bt, m, nside):
    """SimulateSidereal -> MModeTransform -> DirtyMapMaker, task path."""
    from draco_tpu.analysis.mapmaker import DirtyMapMaker
    from draco_tpu.analysis.transform import MModeTransform

    sim = SimulateSidereal()
    sim.read_config({})
    sim.setup(bt)
    ss = sim.process(m)

    mt = MModeTransform()
    mt.read_config({})
    mt.setup()
    ma = mt.process(ss)

    mm = DirtyMapMaker()
    mm.read_config({"nside": nside})
    mm.setup(bt)
    return mm.process(ma)


def test_task_path_on_2d_freq_m_mesh(setup):
    """The full task spine on a (2, 4) (freq x m) named mesh.

    The library-level 2-D production layout of SURVEY.md section 2.5:
    containers redistributed under a named mesh shard freq and m axes
    simultaneously; results must match the unsharded run.
    """
    from draco_tpu.parallel import make_mesh2d, use_mesh

    tel, bt, m = setup
    nside = bt.beam_nside

    out_ref = _run_sim_to_map(bt, m, nside)

    mesh = make_mesh2d(shape=(2, 4), axis_names=("freq", "m"))
    with use_mesh(mesh):
        m2 = m.copy()
        m2.redistribute("freq")
        out_sh = _run_sim_to_map(bt, m2, nside)

    a = np.asarray(out_ref.map[:])
    b = np.asarray(out_sh.map[:])
    assert np.allclose(a, b, atol=1e-5 * max(np.abs(a).max(), 1e-30))


def test_named_mesh_container_placement(setup):
    """Under a (freq, m) mesh both named axes of MModes vis are split."""
    from jax.sharding import PartitionSpec as P

    from draco_tpu.core.containers import MModes
    from draco_tpu.parallel import make_mesh2d, use_mesh

    tel, bt, m = setup
    mesh = make_mesh2d(shape=(2, 4), axis_names=("freq", "m"))
    with use_mesh(mesh):
        ma = MModes(
            mmax=31, freq=np.linspace(400.0, 440.0, 8), stack=4, input=4
        )
        ma.vis[:] = np.zeros(ma.vis.shape, dtype=ma.vis.dtype)
        ma.redistribute("m")
        vis = ma.vis.data
        spec = vis.sharding.spec
        # vis axes are [m, msign, freq, stack]
        assert spec[0] == "m"
        assert spec[2] == "freq"


def test_hybrid_mesh_layout():
    """make_hybrid_mesh: DCN factor outermost, ICI blocks contiguous.

    Multi-slice scale-out layout (SURVEY.md section 7 step 6): the freq
    axis spans slices over DCN while m stays inside each slice's ICI.
    On the virtual platform each (dcn position)'s ICI block must be a
    contiguous device range, the stand-in for "one slice".
    """
    from draco_tpu.parallel import make_hybrid_mesh

    mesh = make_hybrid_mesh(
        ici_shape=(1, 4), dcn_shape=(2, 1), axis_names=("freq", "m")
    )
    assert mesh.shape == {"freq": 2, "m": 4}
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    # each freq row (one "slice") holds a contiguous ICI device block
    for row in ids:
        assert list(row) == list(range(row[0], row[0] + 4))
    # DCN-outermost: rows come from disjoint consecutive blocks
    assert ids[1, 0] == ids[0, -1] + 1

    with pytest.raises(ValueError):
        make_hybrid_mesh(ici_shape=(2,), dcn_shape=(2, 1))
    with pytest.raises(ValueError):
        make_hybrid_mesh(ici_shape=(2, 2), dcn_shape=(4, 1))


class _FakeSliceDevice:
    """A real CPU device masquerading as a member of a multi-host slice.

    Forwards every attribute to the wrapped device but reports a
    configurable ``slice_index`` — enough for
    ``mesh_utils.create_hybrid_device_mesh`` to treat the virtual CPU
    devices as a genuine multi-slice topology.
    """

    def __init__(self, dev, slice_index):
        object.__setattr__(self, "_dev", dev)
        object.__setattr__(self, "_slice_index", slice_index)

    def __getattr__(self, name):
        if name == "slice_index":
            return self._slice_index
        return getattr(self._dev, name)

    def __repr__(self):
        return f"FakeSlice(id={self._dev.id}, slice={self._slice_index})"


def test_hybrid_mesh_real_multislice_branch():
    """The REAL multi-slice branch of make_hybrid_mesh
    (``create_hybrid_device_mesh``, parallel/mesh.py) with faked
    slice_index devices: the DCN axis must span slices (each freq row =
    one slice), and the unwrapped grid must form an executable Mesh.
    """
    import jax

    from draco_tpu.parallel import make_hybrid_mesh

    devs = jax.devices()[:8]
    # two fake slices of four devices each
    fakes = [_FakeSliceDevice(d, i // 4) for i, d in enumerate(devs)]

    mesh = make_hybrid_mesh(
        ici_shape=(1, 4), dcn_shape=(2, 1), axis_names=("freq", "m"),
        devices=fakes,
    )
    assert mesh.shape == {"freq": 2, "m": 4}
    slices = np.vectorize(lambda d: d.slice_index)(mesh.devices)
    # DCN-outermost: each freq row lives entirely inside one slice
    assert (slices[0] == 0).all()
    assert (slices[1] == 1).all()

    # The same grid with the wrappers removed is a REAL executable mesh:
    # run a psum over it to prove the layout is more than cosmetic.
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    real_grid = np.vectorize(lambda f: f._dev)(mesh.devices)
    real_mesh = Mesh(real_grid, ("freq", "m"))
    x = jnp.arange(16.0).reshape(2, 8)
    xs = jax.device_put(x, NamedSharding(real_mesh, P("freq", "m")))
    total = jax.jit(
        lambda a: jnp.sum(a), out_shardings=NamedSharding(real_mesh, P())
    )(xs)
    assert float(np.asarray(total)) == float(x.sum())


def test_task_path_on_hybrid_mesh(setup):
    """The task spine on a hybrid (2 slices x 4-device ICI) mesh equals
    the unsharded run — the same invariant as the flat 2-D mesh test,
    exercised through the multi-slice device layout."""
    from draco_tpu.parallel import make_hybrid_mesh, use_mesh

    tel, bt, m = setup
    nside = bt.beam_nside

    out_ref = _run_sim_to_map(bt, m, nside)

    mesh = make_hybrid_mesh(
        ici_shape=(1, 4), dcn_shape=(2, 1), axis_names=("freq", "m")
    )
    with use_mesh(mesh):
        m2 = m.copy()
        m2.redistribute("freq")
        out_sh = _run_sim_to_map(bt, m2, nside)

    a = np.asarray(out_ref.map[:])
    b = np.asarray(out_sh.map[:])
    assert np.allclose(a, b, atol=1e-5 * max(np.abs(a).max(), 1e-30))
