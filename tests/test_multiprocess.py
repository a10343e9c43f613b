"""Real multi-process jax.distributed validation.

scripts/multiproc_check.py launches 2 coordinator-connected CPU processes
(2 virtual devices each), builds the ('dcn','data','model') multislice mesh
across them, runs DP train steps, and compares params leaf-for-leaf against a
single-process run of the same topology. This test runs it end-to-end.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from silent_speech.parallel.multihost import make_multislice_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_dp_matches_single_process(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "multiproc_check.py"),
         "--tmpdir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    )
    assert "MULTIPROC OK" in proc.stdout


def test_multislice_mesh_rejects_non_divisible_dcn(cpu_mesh_devices):
    with pytest.raises(ValueError, match="does not divide"):
        make_multislice_mesh(dcn_axis=3, devices=cpu_mesh_devices)
    with pytest.raises(ValueError, match="not divisible by model"):
        make_multislice_mesh(dcn_axis=2, model=3, devices=cpu_mesh_devices)
    # valid config still builds
    m = make_multislice_mesh(dcn_axis=2, model=2, devices=cpu_mesh_devices)
    assert dict(zip(m.axis_names, m.devices.shape)) == {
        "dcn": 2, "data": 2, "model": 2,
    }


def test_multislice_mesh_single_process_degrades():
    """With one process the dcn axis is 1 and the layout matches make_mesh."""
    import jax

    devs = jax.devices("cpu")[:8]
    m = make_multislice_mesh(devices=devs)  # inferred dcn = process_count = 1
    assert m.devices.shape == (1, 8, 1)
    assert np.all(m.devices.reshape(-1) == np.asarray(devs))
