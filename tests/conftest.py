"""Shared test helpers.

Device-count hygiene (DESIGN.md §7): this process sees the default single
CPU device.  Tests that need a multi-device mesh or float64 offload jobs run
in subprocesses via :func:`run_subprocess` with their own XLA_FLAGS — the
dry-run's 512-device flag is never set here.
"""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_subprocess(code: str, devices: int = 8, x64: bool = True,
                   timeout: int = 600) -> str:
    """Run python code in a child with its own device count; returns stdout."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if x64:
        env["JAX_ENABLE_X64"] = "true"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        capture_output=True, text=True, env=env, timeout=timeout,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode}):\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
        )
    return proc.stdout


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def subproc():
    return run_subprocess
