"""What the package needs from its environment.

Each case runs in a fresh interpreter: the compile-cache setting and the
import machinery are process-global.
"""

import json
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env_overrides):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_overrides)
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


_CACHE_PROBE = """
    import json
    import jax
    import draco_tpu
    before = jax.config.jax_compilation_cache_dir
    used = draco_tpu.enable_compile_cache()
    print(json.dumps([before, used, jax.config.jax_compilation_cache_dir]))
"""


def test_compile_cache_defaults_to_checkout():
    before, used, after = json.loads(_run(_CACHE_PROBE))
    assert before is None
    assert used == after == os.path.join(REPO, ".jax_cache")


def test_compile_cache_respects_environment(tmp_path):
    path = str(tmp_path / "cache")
    before, used, after = json.loads(
        _run(_CACHE_PROBE, JAX_COMPILATION_CACHE_DIR=path)
    )
    # JAX reads the variable itself; the helper sets no other directory
    assert before == used == after == path


def test_roundtrip_and_dict_manager_without_yaml_or_h5py(tmp_path):
    """The fused path and a dict-built pipeline need neither PyYAML nor
    h5py (both may be missing where the GPU runs)."""
    out = _run(
        f"""
        import sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("yaml", "h5py"):
                    raise ImportError(f"{{name}} is blocked")

        sys.meta_path.insert(0, _Block())
        import pickle
        import numpy as np
        import draco_tpu.telescope.roundtrip  # noqa: F401
        from draco_tpu.core.pipeline import Manager
        from draco_tpu.telescope import UnpolarisedDishArray

        tel = UnpolarisedDishArray(
            grid_ew=2, grid_ns=2, spacing_ew=6.0, spacing_ns=6.0,
            latitude=45.0, dish_width=5.0, freq_lower=400.0,
            freq_upper=410.0, num_freq=1, auto_correlations=True,
            force_lmax=11, force_mmax=11,
        )
        with open({str(tmp_path / "telescope.pkl")!r}, "wb") as f:
            pickle.dump(tel, f)
        cfg = {{"pipeline": {{"tasks": [
            {{"type": "draco.core.io.LoadBeamTransfer", "out": ["tel", "btm"],
             "params": {{"product_directory": {str(tmp_path)!r}}}}},
            {{"type": "draco_tpu.synthesis.skymodel.GenerateGaussianSky",
             "out": "imap",
             "params": {{"nside": 4, "nfreq": 1, "freq_start": 400.0,
                        "freq_end": 410.0, "seed": 1}}}},
            {{"type": "draco.synthesis.stream.SimulateSidereal",
             "requires": "btm", "in": "imap", "out": "ss",
             "params": {{"streaming": True}}}},
        ]}}}}
        products = Manager(cfg).run()
        vis = np.asarray(products["ss"][0].vis[:])
        assert np.isfinite(vis).all() and np.abs(vis).max() > 0
        assert "yaml" not in sys.modules and "h5py" not in sys.modules
        print("ok")
        """
    )
    assert out == "ok"
