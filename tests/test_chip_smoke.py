"""chip_smoke.py: its phases at tiny sizes, and its refusal without a GPU.

The full-size run needs an NVIDIA GPU (``python chip_smoke.py``); here
each phase function runs on the CPU at a few-pixel scale and must pass
its own comparison.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert "no GPU" in r.stderr and "cpu" in r.stderr
    assert '"ok": true' not in r.stdout


def test_phase_windowed_tiny():
    out = chip_smoke.phase_windowed(nside=16, nfeed_side=2, chunk=4, nrun=2)
    assert out["relerr"] <= out["bound"]
    assert out["steady_compiles"] == 0


def test_phase_fullsphere_tiny():
    out = chip_smoke.phase_fullsphere(nside=16, ncyl=2, nfeed=3, chunk=4,
                                      nrun=2)
    assert out["relerr"] <= out["bound"]
    assert out["steady_compiles"] == 0


def test_phase_pipeline_tiny():
    out = chip_smoke.phase_pipeline(nside=16, nfeed_side=2, nfreq=2)
    assert 0.5 <= out["deviation_over_noise"] <= 2.0
    assert 0 < out["noise_over_signal"] < 1


@pytest.mark.gpu
def test_phases_on_gpu():
    """The same tiny phases compiled for the GPU."""
    for result in (
        chip_smoke.phase_windowed(nside=16, nfeed_side=2, chunk=4, nrun=2),
        chip_smoke.phase_fullsphere(nside=16, ncyl=2, nfeed=3, chunk=4,
                                    nrun=2),
    ):
        assert result["relerr"] <= result["bound"]
        assert result["peak_bytes"] > 0


def test_phase_delay_gibbs_tiny():
    out = chip_smoke.phase_delay_gibbs(nbase=4, ndelay=64, niter=10,
                                       nhost=2)
    assert out["min_separation"] > 20
    assert all(0.5 < r < 2.0 for r in out["device_over_host"])
