"""Multi-host / multi-slice initialization.

One host's devices form the ('data', 'model') mesh over NVLink; spanning
hosts adds a 'dcn' axis (the data-center network) on the same Mesh
abstraction (SURVEY.md section 2.4 rebuild contract). This wrapper
is a thin, testable layer over jax.distributed — on a single process it is a
no-op so every pipeline runs unchanged.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process; returns True
    when distributed mode is active. Arguments default from the standard
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_multislice_mesh(
    *,
    dcn_axis: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """('dcn', 'data', 'model') mesh: the leading axis spans slices/hosts
    (gradient sync over the data-center network), the inner axes stay within
    a host. With one host the dcn axis has size 1 and the mesh degrades to
    the single-host layout.

    A dcn_axis (explicit or inferred from ``jax.process_count()``) that does
    not divide the device count is a misconfigured fleet — raise rather than
    silently collapsing to a single slice."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if dcn_axis is None:
        dcn_axis = getattr(jax, "process_count", lambda: 1)()
    if dcn_axis < 1 or n % dcn_axis != 0:
        raise ValueError(
            f"dcn_axis={dcn_axis} does not divide {n} devices — "
            f"misconfigured fleet (process_count vs device count)"
        )
    per_slice = n // dcn_axis
    if per_slice % model != 0:
        raise ValueError(
            f"{per_slice} per-slice devices not divisible by model={model}"
        )
    arr = np.asarray(devices).reshape(dcn_axis, per_slice // model, model)
    return Mesh(arr, axis_names=("dcn", "data", "model"))
