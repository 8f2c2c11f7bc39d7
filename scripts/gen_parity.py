"""Regenerate PARITY.md: reference-symbol → draco_tpu-location census.

Scans every public class/function in the reference ``draco`` package
(/root/reference) and records which draco_tpu module re-provides it.
Run from the repo root: ``python scripts/gen_parity.py``.
"""

from __future__ import annotations

import ast
import os

REF = "/root/reference/draco"

HEADER = """# PARITY — reference symbol map

Auto-generated census (scripts/gen_parity.py): every public class and
function of the reference's `draco` package, and the `draco_tpu` module that
re-provides it.  Containers are spec-generated in
`draco_tpu/core/containers_spec.py`; reference modules whose numerics moved
to the ops layer map to `draco_tpu/ops/<name>.py`.

Beyond this table, draco_tpu natively absorbs the external packages the
reference depends on (see README):

- **caput** (runtime): `core/{pipeline,task,config,containers,io}.py` —
  Manager/CLI, task bases + RandomTask/group_tasks, Property config,
  distributed containers + HDF5, mpiarray semantics via `parallel/mesh.py`.
- **driftscan** (products): `telescope/{core,beamtransfer,kltransform,
  psestimation,manager}.py` + the `makeproducts` CLI.
- **cora** (sky): `ops/sht.py` (sphtrans_sky/inv), `ops/healpix.py`,
  `ops/cosmology.py`, `synthesis/skymodel.py` + the `makesky` CLI.
- **Cython `_fast_tools`** (native kernels): `ops/{banded,tools,
  interferometry,wavelet}.py`, `native/` (C/OpenMP).

| Reference symbol | draco_tpu location |
|---|---|"""


def classes_and_funcs(path):
    try:
        tree = ast.parse(open(path).read())
    except Exception:
        return set(), set()
    cls = {n.name for n in tree.body if isinstance(n, ast.ClassDef)}
    fns = {
        n.name
        for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and not n.name.startswith("_")
    }
    return cls, fns


def main():
    out = [HEADER]
    n_missing = 0
    for sub in ("core", "util", "analysis", "synthesis"):
        for f in sorted(os.listdir(os.path.join(REF, sub))):
            if not f.endswith(".py") or f == "__init__.py":
                continue
            rc, rf = classes_and_funcs(os.path.join(REF, sub, f))
            candidates = [
                f"draco_tpu/{sub}/{f}",
                f"draco_tpu/ops/{f}",
                "draco_tpu/core/containers_spec.py",
                "draco_tpu/core/containers.py",
            ]
            for sym in sorted(rc) + sorted(rf):
                loc = ""
                for cand in candidates:
                    if not os.path.exists(cand):
                        continue
                    c2, f2 = classes_and_funcs(cand)
                    if sym in c2 | f2:
                        loc = cand
                        break
                if not loc:
                    n_missing += 1
                mark = loc if loc else "**MISSING**"
                out.append(f"| `draco/{sub}/{f}` `{sym}` | `{mark}` |")
    with open("PARITY.md", "w") as fh:
        fh.write("\n".join(out) + "\n")
    print(f"PARITY.md written; {n_missing} missing symbols")
    return 1 if n_missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
