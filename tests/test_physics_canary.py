"""The engine-independent physics canary at CI scale.

Runs ``scripts/check_physics.py`` (scipy-harmonic truth, direct f64
pixel sums, analytic sky rotation — no framework SHT in the truth leg)
at nside=16 in a subprocess.  The production-shape (nside=256) run is
the bench's ``physics_canary`` field; this guards the same conventions
(rotation direction, +-m packing, normalisation) on every test run.
"""

import json
import os
import subprocess
import sys


def test_physics_canary_small():
    script = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts",
        "check_physics.py",
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, script, "--nside", "16", "--json"],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    payload = None
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            payload = json.loads(line)
    assert payload is not None, r.stdout[-2000:]
    assert payload["ok"], payload
    # the flip check must genuinely separate the conventions
    assert payload["flip_separation"] > 0.05
