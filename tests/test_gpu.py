"""Tests that need an NVIDIA card (marker `gpu`).  They skip where
`nvidia-smi` finds none; run them on a GPU machine with

    python -m pytest tests/test_gpu.py -m gpu

The test process itself stays on the CPU (tests/conftest.py), so the
child process below is the only one that opens the card."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gpu_env():
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("no nvidia-smi: no NVIDIA card here")
    if r.returncode != 0 or "GPU " not in r.stdout:
        pytest.skip("nvidia-smi finds no NVIDIA card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    r = subprocess.run([sys.executable, "chip_smoke.py", "--seed", "0"],
                       env=gpu_env, cwd=REPO, capture_output=True,
                       text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
