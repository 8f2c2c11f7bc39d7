"""Pipeline manager tests.

Modelled on the reference's pipeline test (reference
test/test_write_metadata.py): YAML-driven runs, requires/in/out wiring,
PipelineStopIteration, process_finish, config provenance in saved output.
"""

import numpy as np

import draco_tpu  # noqa: F401
from draco_tpu.core import config, containers
from draco_tpu.core.pipeline import Manager
from draco_tpu.core.task import (
    ContainerTask,
    PipelineStopIteration,
    RandomTask,
    group_tasks,
)


class EmitNumbers(ContainerTask):
    """Source task emitting a few small containers."""

    n_emit = config.Property(proptype=int, default=3)

    def process(self):
        if self._count >= self.n_emit:
            raise PipelineStopIteration()
        c = containers.FrequencyStack(freq=np.array([400.0, 500.0]))
        c.stack[:] = float(self._count)
        c.attrs["tag"] = f"item{self._count}"
        return c


class AddOffset(ContainerTask):
    offset = config.Property(proptype=float, default=0.0)

    def setup(self, base):
        self.base = np.asarray(base.stack[:]).copy()

    def process(self, item):
        out = item.copy()
        out.stack[:] = np.asarray(item.stack[:]) + self.offset + self.base
        return out


class Accumulate(ContainerTask):
    def __init__(self):
        super().__init__()
        self.total = 0.0
        self.count = 0

    def process(self, item):
        self.total += float(np.asarray(item.stack[:])[0])
        self.count += 1

    def process_finish(self):
        c = containers.FrequencyStack(freq=np.array([400.0, 500.0]))
        c.stack[:] = self.total
        c.attrs["tag"] = "sum"
        return c


def test_pipeline_run_wiring():
    cfg = """
pipeline:
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 4
    - type: tests.test_pipeline.EmitNumbers
      out: base
      params:
        n_emit: 1
    - type: tests.test_pipeline.AddOffset
      requires: base
      in: nums
      out: shifted
      params:
        offset: 10.0
    - type: tests.test_pipeline.Accumulate
      in: shifted
      out: total
"""
    products = Manager.from_yaml_str(cfg).run()
    assert len(products["nums"]) == 4
    assert len(products["shifted"]) == 4
    # base emits value 0; shifted values are 10,11,12,13 -> total 46
    total = products["total"][0]
    assert float(np.asarray(total.stack[:])[0]) == 46.0


def test_pipeline_save_and_history(tmp_path):
    cfg = f"""
pipeline:
  save_versions:
    - numpy
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 1
        save: true
        output_name: "{tmp_path}/out_{{tag}}.h5"
"""
    Manager.from_yaml_str(cfg).run()
    loaded = containers.ContainerBase.from_file(str(tmp_path / "out_item0.h5"))
    # Config and versions are persisted in history
    # (reference test_write_metadata.py:30-34)
    assert "EmitNumbers" in loaded.history["config"]
    assert "numpy" in loaded.history["versions"]


def test_lint_catches_bad_labels_and_params():
    cfg = """
pipeline:
  tasks:
    - type: tests.test_pipeline.AddOffset
      in: missing_label
      params:
        bogus_param: 1
"""
    problems = Manager.from_yaml_str(cfg).lint()
    assert any("missing_label" in p for p in problems)
    assert any("bogus_param" in p for p in problems)


def test_draco_path_translation():
    from draco_tpu.core.pipeline import _resolve_task_class

    cls = _resolve_task_class("draco.core.io.LoadMaps")
    assert cls.__name__ == "LoadMaps"


class _Doubler(ContainerTask):
    def process(self, item):
        out = item.copy()
        out.stack[:] = 2 * np.asarray(item.stack[:])
        return out


class _AddOne(ContainerTask):
    def process(self, item):
        out = item.copy()
        out.stack[:] = np.asarray(item.stack[:]) + 1
        return out


def test_group_tasks_chains_process():
    Chained = group_tasks(_Doubler, _AddOne)
    t = Chained()
    t.read_config({})
    c = containers.FrequencyStack(freq=np.array([400.0]))
    c.stack[:] = 3.0
    out = t.process(c)
    assert float(np.asarray(out.stack[:])[0]) == 7.0


class _RandomUser(RandomTask, ContainerTask):
    pass


def test_random_task_reproducible():
    t1 = _RandomUser()
    t1.read_config({"seed": 42})
    t2 = _RandomUser()
    t2.read_config({"seed": 42})
    a = t1.rng.standard_normal(5)
    b = t2.rng.standard_normal(5)
    assert np.allclose(a, b)
    k1, k2 = t1.next_key(), t1.next_key()
    import jax

    assert not np.array_equal(
        jax.random.key_data(k1), jax.random.key_data(k2)
    )


def test_example_configs_lint():
    """The shipped example configs pass the pipeline linter."""
    import os

    from draco_tpu.core.pipeline import Manager

    here = os.path.join(os.path.dirname(__file__), "..", "examples")
    for name in ("simulate.yaml", "analyze.yaml"):
        mgr = Manager.from_yaml_file(os.path.join(here, name))
        problems = mgr.lint()
        assert not problems, problems


def test_cluster_stanza_jobscript_and_lint():
    """The reference YAML's cluster: block (examples/test.yaml:2-7 in
    the reference) maps onto a SLURM pod-launch script via
    ``draco-tpu queue``; lint validates its keys."""
    from draco_tpu.core.pipeline import Manager

    cfg = """
cluster:
  nodes: 4
  ppn: 8
  time: 120
  directory: /tmp/out
  venv: /opt/venv
pipeline:
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
"""
    mgr = Manager.from_yaml_str(cfg)
    assert mgr.lint() == []
    script = mgr.jobscript("config.yaml")
    assert "#SBATCH --nodes=4" in script
    assert "#SBATCH --time=2:00:00" in script
    assert "DRACO_TPU_PROCESS_ID=$SLURM_PROCID" in script
    assert "DRACO_TPU_NUM_PROCESSES" in script
    assert "source /opt/venv/bin/activate" in script

    bad = Manager.from_yaml_str(cfg.replace("nodes: 4", "nodes: -1"))
    assert any("cluster.nodes" in p for p in bad.lint())
    unk = Manager.from_yaml_str(cfg.replace("ppn: 8", "walrus: 8"))
    assert any("unknown key" in p for p in unk.lint())


def test_unproduced_in_label_fails_fast():
    """A typo'd 'in' label must raise, not silently retire the consumer."""
    import pytest

    from draco_tpu.core.pipeline import PipelineRuntimeError

    cfg = """
pipeline:
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 2
    - type: tests.test_pipeline.Accumulate
      in: nmus
      out: total
"""
    with pytest.raises(PipelineRuntimeError, match="nmus"):
        Manager.from_yaml_str(cfg).run()


def test_retain_products_final():
    """retain_products: final keeps only unconsumed labels in memory."""
    cfg = """
pipeline:
  retain_products: final
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 3
    - type: tests.test_pipeline.Accumulate
      in: nums
      out: total
"""
    products = Manager.from_yaml_str(cfg).run()
    assert "nums" not in products  # consumed intermediate: released
    assert len(products["total"]) == 1


def test_manager_rejects_non_mapping_config():
    import pytest

    from draco_tpu.core import config as config_mod

    with pytest.raises(config_mod.ConfigError, match="mapping"):
        Manager(None)


def test_logging_accepts_int_levels():
    Manager.from_yaml_str(
        """
pipeline:
  logging:
    root: 20
    draco_tpu: 10
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
"""
    )


def test_checkpoint_restart_from_saved_products(tmp_path):
    """The reference restart model: a later pipeline resumes from the
    HDF5 products a previous run saved (reference doc/tutorial.rst
    restart recipe; tasklib.io.LoadFilesFromParams as used in the
    reference examples/test.yaml:9-12).  The two-stage run must equal
    one uninterrupted pipeline."""
    # Stage 1: emit + offset, saving every routed product
    stage1 = f"""
pipeline:
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 3
        save: true
        output_name: "{tmp_path}/ckpt_{{tag}}.h5"
"""
    Manager.from_yaml_str(stage1).run()
    saved = sorted(tmp_path.glob("ckpt_*.h5"))
    assert len(saved) == 3

    # Stage 2: a NEW pipeline (fresh process state) reloads the saved
    # products and continues with downstream work
    stage2 = f"""
pipeline:
  tasks:
    - type: draco_tpu.core.io.LoadFilesFromParams
      out: nums
      params:
        files: "{tmp_path}/ckpt_*.h5"
    - type: tests.test_pipeline.Accumulate
      in: nums
      out: total
"""
    mgr = Manager.from_yaml_str(stage2)
    mgr.run()
    total = mgr.products["total"][-1]
    # 0 + 1 + 2 emitted values
    assert float(np.asarray(total.stack[:])[0]) == 3.0

    # The uninterrupted single pipeline gives the same answer
    direct = f"""
pipeline:
  tasks:
    - type: tests.test_pipeline.EmitNumbers
      out: nums
      params:
        n_emit: 3
    - type: tests.test_pipeline.Accumulate
      in: nums
      out: total
"""
    mgr2 = Manager.from_yaml_str(direct)
    mgr2.run()
    want = mgr2.products["total"][-1]
    assert float(np.asarray(want.stack[:])[0]) == float(
        np.asarray(total.stack[:])[0]
    )


class RecordMesh(ContainerTask):
    """Test task that reports the mesh active during its process call.

    The mesh layout is routed out through the product's attrs (a class
    attribute would not survive pytest/importlib loading the test module
    under two different module objects).
    """

    def process(self):
        if self._count > 0:
            raise PipelineStopIteration()
        from draco_tpu.parallel import get_mesh

        mesh = get_mesh()
        c = containers.FrequencyStack(freq=np.array([400.0]))
        c.stack[:] = 0.0
        c.attrs["tag"] = "mesh"
        c.attrs["mesh"] = (
            "none"
            if mesh is None
            else repr(dict(zip(mesh.axis_names, mesh.devices.shape)))
        )
        return c


def test_yaml_mesh_config_installs_mesh():
    """`pipeline.mesh` builds and installs the device mesh for the run
    (the YAML route to the production freq x m layout; the equivalence
    of the sharded spine itself is tests/test_spmd.py)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip(
            "fixed mesh axis sizes need >=2 devices"
        )
    from draco_tpu.parallel import get_mesh

    cfg = """
pipeline:
  mesh:
    axes:
      freq: 2
      m: -1
  tasks:
    - type: tests.test_pipeline.RecordMesh
      out: nothing
"""
    def seen(mgr):
        return mgr.products["nothing"][-1].attrs["mesh"]

    mgr = Manager.from_yaml_str(cfg)
    mgr.run()
    assert seen(mgr) == repr({"freq": 2, "m": 4})
    # the mesh is scoped to the run
    assert get_mesh() is None

    # shorthand (mapping IS the axes, no `axes:` key)
    mgr = Manager.from_yaml_str(
        """
pipeline:
  mesh: {shard: 8}
  tasks:
    - type: tests.test_pipeline.RecordMesh
      out: nothing
"""
    )
    mgr.run()
    assert seen(mgr) == repr({"shard": 8})

    # hybrid dcn factors (multi-slice layout)
    mgr = Manager.from_yaml_str(
        """
pipeline:
  mesh:
    axes: {freq: 4, m: 2}
    dcn: {freq: 2}
  tasks:
    - type: tests.test_pipeline.RecordMesh
      out: nothing
"""
    )
    mgr.run()
    assert seen(mgr) == repr({"freq": 4, "m": 2})


def test_yaml_mesh_config_validation():
    import pytest

    from draco_tpu.core.config import ConfigError

    def mgr(mesh_yaml):
        return Manager.from_yaml_str(
            f"""
pipeline:
  mesh:
{mesh_yaml}
  tasks:
    - type: tests.test_pipeline.RecordMesh
      out: nothing
"""
        )

    with pytest.raises(ConfigError):
        mgr("    axes: {freq: 0}")
    with pytest.raises(ConfigError):
        mgr("    axes: {freq: -1, m: -1}")
    with pytest.raises(ConfigError):
        mgr("    axes: {freq: 4}\n    dcn: {m: 2}")
    with pytest.raises(ConfigError):
        mgr("    axes: {freq: 4}\n    dcn: {freq: 3}")
    # sizes that don't cover the 8 virtual devices fail at run()
    with pytest.raises(ConfigError):
        mgr("    axes: {freq: 3, m: 2}").run()
