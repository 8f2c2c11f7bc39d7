"""YAML-driven pipeline manager.

Native replacement for ``caput.pipeline.Manager`` (reference usage:
``caput-pipeline run config.yaml``, reference doc/tutorial.rst:166-168 and
test/test_write_metadata.py:27-28).  The YAML schema is preserved:

.. code-block:: yaml

    pipeline:
      tasks:
        - type: draco_tpu.synthesis.stream.SimulateSidereal
          requires: beamtransfer
          out: sstream
          params: {...}
        - type: draco_tpu.analysis.transform.MModeTransform
          in: sstream
          out: mmodes

``requires`` wires one-shot setup inputs, ``in``/``out`` wire per-cycle
dataflow by label, ``params`` bind onto the task's config Properties
(reference doc/tutorial.rst:108-145).  Scheduling is the same round-robin
task cycling with :class:`PipelineStopIteration` retiring tasks.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
from collections import deque
from typing import Any

from . import config as config_mod
from ..parallel import mesh as pmesh
from .containers import ContainerBase
from .task import (
    ContainerTask,
    MPILoggedTask,
    PipelineRuntimeError,
    PipelineStopIteration,
)

logger = logging.getLogger(__name__)


def _as_list(val) -> list:
    if val is None:
        return []
    if isinstance(val, (list, tuple)):
        return list(val)
    return [val]


def _resolve_task_class(path: str):
    """Import a task class from its dotted path.

    Also translates reference-style ``draco.*`` paths onto ``draco_tpu.*``
    so existing configs run unmodified.
    """
    candidates = [path]
    if path.startswith("draco."):
        candidates.append("draco_tpu." + path[len("draco.") :])
    err = None
    for cand in candidates:
        mod_name, _, cls_name = cand.rpartition(".")
        try:
            mod = importlib.import_module(mod_name)
            return getattr(mod, cls_name)
        except (ImportError, AttributeError, ValueError) as e:
            # ValueError: a bare class name with no module part makes
            # import_module('') blow up — diagnose it like any bad path
            err = e
    raise PipelineRuntimeError(f"Cannot import task {path!r}: {err}")


class _TaskRunner:
    """Book-keeping wrapper around one task instance in the pipeline."""

    def __init__(self, spec: dict, index: int, compare_keys: bool = False):
        self.spec = spec
        self.index = index
        self.type_path = spec["type"]
        self.cls = _resolve_task_class(self.type_path)
        self.requires = _as_list(spec.get("requires"))
        self.in_labels = _as_list(spec.get("in"))
        self.out_labels = _as_list(spec.get("out"))
        self.params = spec.get("params") or {}

        self.task = self.cls()
        self.task.read_config(self.params, compare_keys=compare_keys)

        self.queues: list[deque] = [deque() for _ in self.in_labels]
        self.requires_values: list[Any] = [None] * len(self.requires)
        self.requires_filled: list[bool] = [False] * len(self.requires)
        self.setup_done = False
        self.done = False
        self.finished = False
        # Per-task observability: cumulative wall-clock and call counts
        # (the profiling hook SURVEY.md section 5 calls for)
        self.wall_time = 0.0
        self.n_calls = 0

    @property
    def name(self) -> str:
        return f"{self.type_path}[{self.index}]"

    def ready_for_setup(self) -> bool:
        return not self.setup_done and all(self.requires_filled)

    def can_process(self) -> bool:
        return self.setup_done and all(len(q) > 0 for q in self.queues)

    def is_source(self) -> bool:
        return len(self.in_labels) == 0


def _assert_finite_product(task_name: str, label: str, obj) -> None:
    """Raise PipelineRuntimeError if a routed product carries NaN/Inf."""
    import numpy as np

    def check(path, arr):
        a = np.asarray(arr)
        if a.dtype.kind in "fc" and not np.isfinite(a).all():
            bad = int((~np.isfinite(a)).sum())
            raise PipelineRuntimeError(
                f"{task_name} -> '{label}'{path}: {bad} non-finite values"
            )

    if hasattr(obj, "datasets"):
        from ..ops import tools as _t

        for name, ds in obj.datasets.items():
            check(f"/{name}", _t.device_to_numpy(ds[:]))
    elif hasattr(obj, "shape"):
        from ..ops import tools as _t

        check("", _t.device_to_numpy(obj))


class Manager(config_mod.Reader):
    """Round-robin task scheduler driven by a YAML config."""

    def __init__(self, config_dict: dict, config_yaml: str | None = None):
        if not isinstance(config_dict, dict):
            raise config_mod.ConfigError(
                "Pipeline config must be a mapping "
                f"(got {type(config_dict).__name__}: empty file?)"
            )
        self.config_dict = config_dict
        # provenance text written with products; a dict-built config is
        # recorded as JSON, which YAML parsers read unchanged
        self.config_yaml = (
            config_yaml
            if config_yaml is not None
            else json.dumps(config_dict, indent=2, default=str)
        )
        pipeline_cfg = config_dict.get("pipeline")
        if pipeline_cfg is None:
            raise config_mod.ConfigError("Config has no 'pipeline' section")
        task_specs = pipeline_cfg.get("tasks")
        if not task_specs:
            raise config_mod.ConfigError("Pipeline has no tasks")
        self.task_specs = task_specs
        # `cluster:` — the reference YAML's batch-queue block (caput's
        # job-script generation; reference examples/test.yaml:2-7).
        # Semantics here: `python -m draco_tpu queue config.yaml` turns
        # it into a SLURM script that launches ONE process per host
        # (ranks come from the launcher env, GPUs from the local
        # backend); a plain `run` ignores it.  See docs/migration.md.
        self.cluster = config_dict.get("cluster") or {}
        self.versions = self._collect_versions(
            pipeline_cfg.get("save_versions", [])
        )
        self._configure_logging(pipeline_cfg.get("logging"))
        self.products: dict[str, list] = {}
        # Observability knobs: `timing: true` logs a per-task wall-clock
        # summary after the run; `profile: <dir>` wraps the run in a JAX
        # profiler trace written to that directory (view with
        # tensorboard/xprof)
        self.timing = bool(pipeline_cfg.get("timing", False))
        self.profile_dir = pipeline_cfg.get("profile")
        # `validate_finite: true` checks every routed container/array
        # product for NaN/Inf after the producing task and fails fast
        # naming the task and dataset — numerical failure detection for
        # long production chains (a poisoned weight propagates silently
        # otherwise).
        self.validate_finite = bool(pipeline_cfg.get("validate_finite", False))
        # `retain_products`: what run() keeps (and returns) in memory.
        # "all" (default) retains every routed product — handy for tests
        # and notebooks; "final" only labels no task consumes; "none"
        # nothing (long production chains write with `save:` and must
        # not pin every intermediate container for the whole run).
        self.retain_products = str(
            pipeline_cfg.get("retain_products", "all")
        )
        if self.retain_products not in ("all", "final", "none"):
            raise config_mod.ConfigError(
                "pipeline.retain_products must be one of "
                f"'all'/'final'/'none', got {self.retain_products!r}"
            )
        # `mesh:` installs a device mesh for the whole run, so the
        # production (freq x m) layout — the reference's two MPI
        # distributions bridged by parallel transposes (reference
        # draco/synthesis/stream.py:96,119) — is selected from YAML:
        #
        #   pipeline:
        #     mesh:
        #       axes: {freq: 2, m: -1}   # -1 fills remaining devices
        #       dcn: {freq: 2}           # optional between-host factor
        #
        # Shorthand `mesh: {freq: 2, m: 4}` (no `axes` key) also works.
        self.mesh_cfg = self._parse_mesh_cfg(pipeline_cfg.get("mesh"))
        # `distribute: true` moves every routed container onto the
        # installed mesh (named-axis sharding) as it is produced, so a
        # YAML pipeline runs its containers as GLOBAL jax.Arrays — on a
        # multi-process mesh each process then holds only its shard of
        # every distributed axis (the reference's per-rank MPIArray
        # slabs, reference caput.mpiarray usage in
        # draco/synthesis/stream.py:91-140).  Defaults to on when a
        # mesh is configured.
        self.distribute_products = bool(
            pipeline_cfg.get("distribute", self.mesh_cfg is not None)
        )
        self.task_timing: dict[str, dict] = {}

    @staticmethod
    def _parse_mesh_cfg(cfg):
        """Validate `pipeline.mesh` and return (axes, dcn) or None.

        Static validation only (no jax import) so lint works on hosts
        without the target device count.
        """
        if cfg is None:
            return None
        if not isinstance(cfg, dict) or not cfg:
            raise config_mod.ConfigError(
                "pipeline.mesh must be a non-empty mapping of axis "
                f"name to size, got {cfg!r}"
            )
        axes = cfg.get("axes", None)
        dcn = cfg.get("dcn", None) if axes is not None else None
        if axes is None:
            axes = cfg  # shorthand: the mapping IS the axes
        if not isinstance(axes, dict) or not axes:
            raise config_mod.ConfigError(
                "pipeline.mesh.axes must be a non-empty mapping, "
                f"got {axes!r}"
            )
        for name, size in axes.items():
            if not isinstance(name, str) or not isinstance(size, int):
                raise config_mod.ConfigError(
                    "pipeline.mesh axes must map axis names to integer "
                    f"sizes, got {name!r}: {size!r}"
                )
            if size != -1 and size < 1:
                raise config_mod.ConfigError(
                    f"pipeline.mesh axis {name!r} size must be a "
                    f"positive integer or -1 (fill), got {size}"
                )
        n_fill = sum(1 for s in axes.values() if s == -1)
        if n_fill > 1:
            raise config_mod.ConfigError(
                "pipeline.mesh allows at most one -1 (fill) axis size"
            )
        if dcn is not None:
            if not isinstance(dcn, dict):
                raise config_mod.ConfigError(
                    "pipeline.mesh.dcn must be a mapping of axis name "
                    f"to between-host factor, got {dcn!r}"
                )
            for name, fac in dcn.items():
                if name not in axes:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh.dcn names unknown axis {name!r}"
                    )
                if not isinstance(fac, int) or fac < 1:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh.dcn factor for {name!r} must be "
                        f"a positive integer, got {fac!r}"
                    )
                if axes[name] != -1 and axes[name] % fac != 0:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh.dcn factor {fac} does not divide "
                        f"axis {name!r} size {axes[name]}"
                    )
        return (dict(axes), dict(dcn) if dcn else None)

    def _build_mesh(self):
        """Construct the configured Mesh against the live device set."""
        if self.mesh_cfg is None:
            return None
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from ..parallel import make_hybrid_mesh

        axes, dcn = self.mesh_cfg
        ndev = len(jax.devices())
        sizes = dict(axes)
        fixed = 1
        for s in sizes.values():
            if s != -1:
                fixed *= s
        for name, s in sizes.items():
            if s == -1:
                if ndev % fixed != 0:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh: fixed axis sizes {fixed} do not "
                        f"divide the {ndev} available devices"
                    )
                sizes[name] = ndev // fixed
        total = 1
        for s in sizes.values():
            total *= s
        if total != ndev:
            raise config_mod.ConfigError(
                f"pipeline.mesh covers {total} devices but "
                f"{ndev} are available"
            )
        names = tuple(sizes.keys())
        if dcn:
            for name, fac in dcn.items():
                if sizes[name] % fac != 0:
                    raise config_mod.ConfigError(
                        f"pipeline.mesh.dcn factor {fac} does not divide "
                        f"the resolved size {sizes[name]} of axis {name!r}"
                    )
            dcn_shape = tuple(dcn.get(n, 1) for n in names)
            ici_shape = tuple(
                sizes[n] // dcn.get(n, 1) for n in names
            )
            return make_hybrid_mesh(ici_shape, dcn_shape, names)
        grid = np.asarray(jax.devices()).reshape(tuple(sizes.values()))
        return Mesh(grid, names)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_yaml_str(cls, yaml_str: str) -> "Manager":
        import yaml

        return cls(yaml.safe_load(yaml_str), config_yaml=yaml_str)

    @classmethod
    def from_yaml_file(cls, path: str) -> "Manager":
        import yaml

        with open(path) as f:
            text = f.read()
        return cls(yaml.safe_load(text), config_yaml=text)

    # -- helpers ---------------------------------------------------------------
    @staticmethod
    def _collect_versions(modules) -> dict[str, str]:
        versions = {}
        for mod_name in _as_list(modules):
            try:
                mod = importlib.import_module(mod_name)
                versions[mod_name] = getattr(mod, "__version__", "unknown")
            except ImportError:
                versions[mod_name] = "unavailable"
        return versions

    @staticmethod
    def _configure_logging(log_cfg):
        if log_cfg is None:
            return
        if isinstance(log_cfg, str):
            log_cfg = {"root": log_cfg}
        def as_level(v):
            # logging accepts ints (yaml: 20) and names (yaml: info)
            return v if isinstance(v, int) else str(v).upper()

        root = log_cfg.get("root")
        if root is not None:
            logging.basicConfig(level=as_level(root))
        for name, level in log_cfg.items():
            if name != "root":
                logging.getLogger(name).setLevel(as_level(level))

    # -- validation ------------------------------------------------------------
    def lint(self) -> list[str]:
        """Statically validate the pipeline config; returns problem list.

        The equivalent of ``caput-pipeline lint`` (reference CI,
        .github/workflows/main.yaml:90-92).
        """
        problems = []
        produced = set()
        for i, spec in enumerate(self.task_specs):
            if "type" not in spec:
                problems.append(f"task #{i} has no 'type'")
                continue
            try:
                runner = _TaskRunner(spec, i, compare_keys=True)
            except (PipelineRuntimeError, config_mod.ConfigError) as e:
                problems.append(str(e))
                continue
            produced.update(runner.out_labels)
        for i, spec in enumerate(self.task_specs):
            for label in _as_list(spec.get("requires")) + _as_list(spec.get("in")):
                if label not in produced:
                    problems.append(
                        f"task #{i} consumes label {label!r} which no task produces"
                    )
        problems.extend(self._lint_cluster())
        return problems

    _CLUSTER_KEYS = {
        "nodes", "ppn", "time", "directory", "venv", "name", "queue",
        "account", "queue_sys", "pernode", "ompnum", "mem",
    }

    def _lint_cluster(self) -> list[str]:
        """Validate the ``cluster:`` stanza (batch-queue job descriptor)."""
        problems = []
        if not isinstance(self.cluster, dict):
            return [f"cluster: must be a mapping, got {self.cluster!r}"]
        for key in self.cluster:
            if key not in self._CLUSTER_KEYS:
                problems.append(f"cluster: unknown key {key!r}")
        for key in ("nodes", "ppn", "pernode", "ompnum"):
            v = self.cluster.get(key)
            if v is not None and (not isinstance(v, int) or v < 1):
                problems.append(
                    f"cluster.{key} must be a positive integer, got {v!r}"
                )
        t = self.cluster.get("time")
        if t is not None and not isinstance(t, (int, float)) and not (
            isinstance(t, str) and t.replace(":", "").isdigit()
        ):
            problems.append(
                f"cluster.time must be minutes or HH:MM:SS, got {t!r}"
            )
        return problems

    def jobscript(self, config_path: str) -> str:
        """Render the ``cluster:`` stanza as a SLURM pod-launch script.

        The JAX mapping of caput's batch-queue generation: one
        process per host (``nodes``), ranks wired through the
        ``DRACO_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}`` launcher
        contract (see :mod:`draco_tpu.parallel.multihost`).  ``ppn`` is
        accepted for config compatibility but does not multiply
        processes — each host process drives ALL its local GPUs,
        so the reference's ranks-per-node knob has no analogue.
        """
        import shlex

        c = self.cluster
        nodes = int(c.get("nodes", 1))
        t = c.get("time", 60)
        if isinstance(t, (int, float)):  # caput: minutes
            walltime = f"{int(t) // 60:d}:{int(t) % 60:02d}:00"
        else:
            walltime = str(t)
        name = c.get("name", "draco-tpu")
        workdir = c.get("directory")
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={name}",
            f"#SBATCH --nodes={nodes}",
            "#SBATCH --ntasks-per-node=1",
            f"#SBATCH --time={walltime}",
        ]
        if c.get("queue"):
            lines.append(f"#SBATCH --partition={c['queue']}")
        if c.get("account"):
            lines.append(f"#SBATCH --account={c['account']}")
        if c.get("mem"):
            lines.append(f"#SBATCH --mem={c['mem']}")
        if workdir:
            lines.append(f"#SBATCH --chdir={shlex.quote(str(workdir))}")
        lines += [
            "",
            "# one process per host; GPUs come from the local backend",
        ]
        if c.get("venv"):
            lines.append(f"source {shlex.quote(str(c['venv']))}/bin/activate")
        cfg = shlex.quote(os.path.abspath(config_path))
        lines += [
            'head=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)',
            'export DRACO_TPU_COORDINATOR="$head:8476"',
            'export DRACO_TPU_NUM_PROCESSES="$SLURM_NTASKS"',
            "srun --export=ALL bash -c "
            f"'DRACO_TPU_PROCESS_ID=$SLURM_PROCID "
            f"python -m draco_tpu run {cfg}'",
            "",
        ]
        return "\n".join(lines)

    # -- execution ---------------------------------------------------------------
    def run(self) -> dict[str, list]:
        """Execute the pipeline; returns the products routed by label.

        With ``pipeline.profile: <dir>`` the run is wrapped in a JAX
        profiler trace; with ``pipeline.timing: true`` a per-task
        wall-clock summary is logged and stored in ``self.task_timing``.
        """
        import contextlib

        with contextlib.ExitStack() as stack:
            mesh = self._build_mesh()
            if mesh is not None:
                from ..parallel import use_mesh

                logger.info(
                    "pipeline mesh: %s",
                    dict(zip(mesh.axis_names, mesh.devices.shape)),
                )
                stack.enter_context(use_mesh(mesh))
            if self.profile_dir:
                import jax

                stack.enter_context(jax.profiler.trace(str(self.profile_dir)))
            return self._run()

    def _run(self) -> dict[str, list]:
        import time as _time

        # compare_keys: a typo'd param silently falling back to the
        # class default would produce scientifically wrong output, so
        # run() validates keys exactly like `lint` does
        runners = [
            _TaskRunner(spec, i, compare_keys=True)
            for i, spec in enumerate(self.task_specs)
        ]

        def timed(runner, fn, *args):
            t0 = _time.perf_counter()
            try:
                return fn(*args)
            finally:
                runner.wall_time += _time.perf_counter() - t0
                runner.n_calls += 1

        # index consumers by label
        consumers_req: dict[str, list[tuple[_TaskRunner, int]]] = {}
        consumers_in: dict[str, list[tuple[_TaskRunner, int]]] = {}
        for r in runners:
            for j, label in enumerate(r.requires):
                consumers_req.setdefault(label, []).append((r, j))
            for j, label in enumerate(r.in_labels):
                consumers_in.setdefault(label, []).append((r, j))
            if isinstance(r.task, (ContainerTask, MPILoggedTask)):
                r.task._manager = self

        producers: dict[str, list[_TaskRunner]] = {}
        for r in runners:
            for label in r.out_labels:
                producers.setdefault(label, []).append(r)

        # A consumed label with zero producers would otherwise retire its
        # consumer on the first round with zero items — a silent
        # wrong-result run (typo'd labels are the classic cause).
        for r in runners:
            missing = [
                lab
                for lab in (*r.requires, *r.in_labels)
                if lab not in producers
            ]
            if missing:
                raise PipelineRuntimeError(
                    f"{r.name}: consumes labels {missing} that no task "
                    "produces (check the 'out' lists)"
                )

        consumed_labels = set(consumers_req) | set(consumers_in)

        def route(runner: _TaskRunner, output):
            if output is None:
                return
            outs = (
                output
                if isinstance(output, tuple) and len(runner.out_labels) > 1
                else (output,)
            )
            # Extra outputs beyond the labelled ones are dropped (the
            # LoadBeamTransfer convention: setup returns (tel, bt, feeds)
            # against `out: [tel, bt]`).
            if len(runner.out_labels) > 0 and len(outs) > len(runner.out_labels):
                outs = outs[: len(runner.out_labels)]
            if len(runner.out_labels) not in (0, len(outs)):
                raise PipelineRuntimeError(
                    f"{runner.name} produced {len(outs)} outputs for "
                    f"{len(runner.out_labels)} labels"
                )
            for label, out in zip(runner.out_labels, outs):
                if (
                    self.distribute_products
                    and pmesh.get_mesh() is not None
                    and isinstance(out, ContainerBase)
                ):
                    # products become global jax.Arrays sharded over the
                    # installed mesh (multi-process: each process holds
                    # its shard)
                    out.to_device()
                if self.validate_finite:
                    _assert_finite_product(runner.name, label, out)
                if self.retain_products == "all" or (
                    self.retain_products == "final"
                    and label not in consumed_labels
                ):
                    self.products.setdefault(label, []).append(out)
                for cons, j in consumers_req.get(label, []):
                    if not cons.requires_filled[j]:
                        cons.requires_values[j] = out
                        cons.requires_filled[j] = True
                for cons, j in consumers_in.get(label, []):
                    cons.queues[j].append(out)

        def upstream_done(runner: _TaskRunner) -> bool:
            for label in runner.in_labels:
                for p in producers.get(label, []):
                    if not p.finished:
                        return False
            return True

        def retire(runner: _TaskRunner):
            if runner.finished:
                return
            leftover = sum(len(q) for q in runner.queues)
            if leftover:
                logger.warning(
                    "%s retiring with %d unconsumed queued input item(s): "
                    "its in-label producers emitted unequal item counts",
                    runner.name,
                    leftover,
                )
            runner.done = True
            try:
                out = timed(runner, runner.task.finish)
                route(runner, out)
            finally:
                runner.finished = True

        # Main round-robin loop
        while not all(r.finished for r in runners):
            progress = False
            for r in runners:
                if r.finished:
                    continue
                # Setup when requires are satisfied.  A non-None setup
                # return is routed to the out labels (the LoadBeamTransfer
                # convention: `out: [tel, bt]` wired from setup,
                # reference test/pipe_config.yaml:16-19).
                if r.ready_for_setup():
                    setup_ret = timed(r, r.task.setup, *r.requires_values)
                    r.setup_done = True
                    if setup_ret is not None:
                        route(r, setup_ret)
                    progress = True
                if not r.setup_done:
                    # Sources with unmet requires wait; but if their
                    # producers are all finished and still unfilled -> error
                    unmet = [
                        lab
                        for j, lab in enumerate(r.requires)
                        if not r.requires_filled[j]
                    ]
                    if unmet and all(
                        p.finished
                        for lab in unmet
                        for p in producers.get(lab, [])
                    ):
                        raise PipelineRuntimeError(
                            f"{r.name}: requires {unmet} never produced"
                        )
                    continue
                # Process
                if r.is_source():
                    try:
                        out = timed(r, r.task.next)
                        route(r, out)
                        progress = True
                    except PipelineStopIteration:
                        retire(r)
                        progress = True
                else:
                    while r.can_process():
                        items = [q.popleft() for q in r.queues]
                        try:
                            out = timed(r, r.task.next, *items)
                            route(r, out)
                            progress = True
                        except PipelineStopIteration:
                            retire(r)
                            progress = True
                            break
                    if (
                        not r.finished
                        and upstream_done(r)
                        and not r.can_process()
                    ):
                        retire(r)
                        progress = True
            if not progress:
                stuck = [r.name for r in runners if not r.finished]
                raise PipelineRuntimeError(
                    f"Pipeline deadlocked; unfinished tasks: {stuck}"
                )

        self.task_timing = {
            r.name: {"wall": r.wall_time, "calls": r.n_calls} for r in runners
        }
        if self.timing:
            total = sum(r.wall_time for r in runners) or 1.0
            logger.info("Per-task wall-clock summary:")
            for r in sorted(runners, key=lambda x: -x.wall_time):
                logger.info(
                    f"  {r.name:<60s} {r.wall_time:9.3f}s "
                    f"({100 * r.wall_time / total:5.1f}%) in {r.n_calls} calls"
                )
        return self.products


def run(config_path: str) -> dict[str, list]:
    """Run a pipeline YAML file (CLI entry: ``draco-tpu run``)."""
    return Manager.from_yaml_file(config_path).run()


def lint(config_path: str) -> list[str]:
    """Lint a pipeline YAML file (CLI entry: ``draco-tpu lint``)."""
    return Manager.from_yaml_file(config_path).lint()


def main(argv=None):
    """Command line interface.

    ``draco-tpu {run,lint} config.yaml`` mirrors the reference's
    ``caput-pipeline`` console script; ``draco-tpu makeproducts`` and
    ``draco-tpu makesky`` re-provide the ``drift-makeproducts`` /
    ``cora-makesky`` product-generation entry points the tutorial drives
    (reference doc/tutorial.rst:78-119).
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="draco-tpu",
        description="Run/lint a draco-tpu pipeline; generate telescope "
        "products or input sky maps",
    )
    parser.add_argument(
        "--platform",
        default=None,
        help="force a JAX platform (cpu/gpu), e.g. for host-only product "
        "generation",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p_run = sub.add_parser("run", help="run a pipeline config")
    p_run.add_argument("configfile")
    p_lint = sub.add_parser("lint", help="validate a pipeline config")
    p_lint.add_argument("configfile", nargs="+")

    p_queue = sub.add_parser(
        "queue",
        help="render the config's cluster: stanza as a SLURM pod-launch "
        "script (caput's batch-queue job generation equivalent)",
    )
    p_queue.add_argument("configfile")
    p_queue.add_argument(
        "--output", default=None,
        help="write the job script here (default: stdout)",
    )

    p_verify = sub.add_parser(
        "verify",
        help="run a pipeline repeatedly and check every product is "
        "reproducible (determinism check)",
    )
    p_verify.add_argument("configfile")
    p_verify.add_argument("--runs", type=int, default=2)
    p_verify.add_argument(
        "--rtol",
        type=float,
        default=0.0,
        help="0 demands bitwise identity; small values tolerate "
        "reduction-order drift",
    )

    p_prod = sub.add_parser(
        "makeproducts",
        help="generate beam-transfer/KL/PS products from a product config "
        "(drift-makeproducts equivalent)",
    )
    p_prod.add_argument("configfile", help="product config YAML or directory")
    p_prod.add_argument("--regen", action="store_true", help="force regeneration")
    p_prod.add_argument(
        "--output", default=None, help="directory to save products into"
    )

    p_sky = sub.add_parser(
        "makesky",
        help="generate a Gaussian sky map HDF5 (cora-makesky equivalent)",
    )
    p_sky.add_argument(
        "model",
        choices=[
            "synchrotron", "pointsource", "freefree", "galacticfreefree",
            "foreground", "21cm",
        ],
    )
    p_sky.add_argument("output", help="output HDF5 map file")
    p_sky.add_argument("--nside", type=int, default=64)
    p_sky.add_argument("--freq-start", type=float, default=400.0)
    p_sky.add_argument("--freq-end", type=float, default=500.0)
    p_sky.add_argument("--nfreq", type=int, default=32)
    p_sky.add_argument("--seed", type=int, default=0)
    p_sky.add_argument("--pol", action="store_true", help="full-Stokes maps")
    p_sky.add_argument("--lmax", type=int, default=None)

    args = parser.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    if args.command in ("run", "verify", "makeproducts", "makesky"):
        # Persistent XLA compilation cache: the big fused programs cost
        # minutes to compile, and a production pipeline recompiles
        # nothing on its second launch.
        from .. import enable_compile_cache

        enable_compile_cache()

    if args.command == "run":
        # Multi-process launches configure DRACO_TPU_COORDINATOR /
        # _NUM_PROCESSES / _PROCESS_ID (the MPI-launcher-rank analogue);
        # single-process runs are untouched.
        from ..parallel import multihost

        multihost.initialize()
        run(args.configfile)
        return 0
    if args.command == "queue":
        man = Manager.from_yaml_file(args.configfile)
        problems = man._lint_cluster()
        for p in problems:
            print(f"LINT: {p}")
        if problems:
            return 1
        script = man.jobscript(args.configfile)
        if args.output:
            with open(args.output, "w") as f:
                f.write(script)
            os.chmod(args.output, 0o755)
            print(f"job script written to {args.output}")
        else:
            print(script, end="")
        return 0
    if args.command == "verify":
        from ..parallel.validate import DeterminismError, check_pipeline_determinism

        with open(args.configfile) as f:
            cfg_text = f.read()
        try:
            summary = check_pipeline_determinism(
                cfg_text, runs=args.runs, rtol=args.rtol
            )
        except DeterminismError as e:
            print(f"VERIFY FAILED: {e}")
            return 1
        print(
            f"verify ok: {summary['products']} product labels, "
            f"{summary['arrays']} arrays reproducible over {args.runs} runs"
        )
        return 0
    if args.command == "makeproducts":
        from ..telescope.manager import ProductManager

        man = ProductManager.from_config(args.configfile)
        man.generate(regen=args.regen)
        out_dir = args.output or man.directory
        if out_dir:
            man.save(out_dir)
            print(f"products written to {out_dir}")
        return 0
    if args.command == "makesky":
        from ..synthesis.skymodel import make_sky

        m = make_sky(
            model=args.model,
            nside=args.nside,
            nfreq=args.nfreq,
            freq_start=args.freq_start,
            freq_end=args.freq_end,
            seed=args.seed,
            pol=args.pol,
            lmax=args.lmax,
        )
        m.save(args.output)
        print(f"{args.model} map written to {args.output}")
        return 0
    problems = []
    for f in args.configfile:
        problems.extend(lint(f))
    for p in problems:
        print(f"LINT: {p}")
    return 1 if problems else 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
