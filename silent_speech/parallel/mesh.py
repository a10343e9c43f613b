"""Device mesh construction and sharding rules.

The reference is single-process CPU-only (SURVEY.md section 2.4) — this
subsystem is the rebuild contract: a ('data', 'model') mesh over the
devices (a plain reshape: the GPUs of one host reach each other all to all
over NVLink, so the mesh follows the algorithm alone), batch
sharded on 'data' (DP), with optional tensor-parallel sharding of the GRU
hidden axis and head projections on 'model' for scaled workloads. All
collectives are emitted by GSPMD from the sharding annotations — no manual
transport layer. Multi-host/DCN extends the same mesh via
``jax.distributed.initialize`` without code changes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    devices: Optional[Sequence] = None,
    *,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """Build a ('data', 'model') mesh. With defaults, all available devices go
    to the data axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(
                f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def _default_device_is_cpu() -> bool:
    """True when computation is effectively pinned to the CPU backend —
    either CPU is the default backend, or jax.default_device is set to a CPU
    device (the virtual-mesh emulation workflow)."""
    d = jax.config.jax_default_device
    if d is None:
        return jax.default_backend() == "cpu"
    platform = getattr(d, "platform", d)  # Device object or platform string
    return str(platform).lower().startswith("cpu")


def mesh_from_shape(shape: dict) -> Mesh:
    """Build a ('data','model') mesh from a CLI-style shape dict
    ({'data': 4, 'model': 2}; 'data' omitted = all remaining devices).

    The mesh is built over the default backend's devices. When that backend
    has fewer devices than the shape needs, the virtual CPU host devices are
    used ONLY if computation already runs on the CPU (the
    XLA_FLAGS=--xla_force_host_platform_device_count emulation workflow);
    otherwise this is a loud error — silently mixing a CPU mesh into a
    GPU-default process would move every array across backends."""
    unknown = set(shape) - {"data", "model"}
    if unknown:
        raise ValueError(
            f"unknown mesh axis {sorted(unknown)} in mesh_shape={shape} "
            "(allowed: data, model)"
        )
    model_axis = int(shape.get("model", 1))
    data_axis = shape.get("data")
    if data_axis is not None:
        data_axis = int(data_axis)
    need = (data_axis or 1) * model_axis
    devices = jax.devices()
    if len(devices) < need:
        cpus = jax.devices("cpu")
        if _default_device_is_cpu() and len(cpus) >= need:
            devices = cpus
        else:
            raise ValueError(
                f"mesh_shape={shape} needs {need} devices but the "
                f"{devices[0].platform} backend has {len(devices)}. To "
                "emulate a larger mesh on CPU, run with JAX_PLATFORMS=cpu "
                f"XLA_FLAGS=--xla_force_host_platform_device_count={need}"
            )
    if data_axis is not None and len(devices) > need:
        # fully-explicit shape on a LARGER backend (e.g. mesh_shape=data:4 on
        # the 8-virtual-CPU emulation): use the first `need` devices rather
        # than tripping make_mesh's exact-count check
        devices = list(devices)[:need]
    return make_mesh(devices, data=data_axis, model=model_axis)


def batch_spec(mesh: Optional[Mesh] = None) -> P:
    """Batch arrays shard their leading axis over every non-'model' mesh axis
    — P('data') on a ('data','model') mesh, P(('dcn','data')) on a multislice
    ('dcn','data','model') mesh (DP gradient sync spans every host)."""
    if mesh is None:
        return P("data")
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return P(axes)


def put_global(x, mesh: Mesh, spec: P):
    """Place a host array onto the (possibly multi-process) mesh.

    Single-process: plain device_put. Multi-process: every process passes the
    same full global array; make_array_from_process_local_data slices out the
    locally-addressable shards (global_shape == local shape contract)."""
    sh = NamedSharding(mesh, spec)
    if getattr(jax, "process_count", lambda: 1)() == 1:
        return jax.device_put(x, sh)
    x = np.asarray(x)
    return jax.make_array_from_process_local_data(sh, x, x.shape)


def replicated() -> P:
    return P()


def replicated_specs(params) -> dict:
    """Fully-replicated PartitionSpec pytree for any param layout — the
    right call for serving sweeps at the reference's model scale (params fit
    every device; only batches shard)."""
    return jax.tree.map(lambda _: P(), params)


def _gru_dir_tp_spec() -> dict:
    """Tensor-parallel GRU direction: gate projections column-sharded on
    'model'. GSPMD inserts the all-gather of the recurrent state that the
    dense hidden-to-hidden mixing requires."""
    return {
        "wi": P(None, "model"),
        "wh": P(None, "model"),
        "bi": P("model"),
        "bh": P("model"),
    }


def _gru_dir_rep_spec() -> dict:
    return {"wi": P(), "wh": P(), "bi": P(), "bh": P()}


def bigru_param_specs(params: dict, *, tensor_parallel: bool = False) -> dict:
    """PartitionSpec pytree matching models/bigru.py param layout.

    ``tensor_parallel=False``: fully replicated (the right call at the
    reference's 1.19M-param scale — DP only).
    ``tensor_parallel=True``: GRU gate projections and head fc1/fc2 sharded
    on 'model' (the scaled-workload hook, SURVEY.md section 2.4).
    """
    gdir = _gru_dir_tp_spec() if tensor_parallel else _gru_dir_rep_spec()
    spec = {
        "gru": [
            {k: dict(gdir) for k in layer} for layer in params["gru"]
        ],
        "pool": {"score": {"w": P(), "b": P()}},
        "head": {
            "ln": {"scale": P(), "bias": P()},
            "fc1": {"w": P(None, "model") if tensor_parallel else P(),
                    "b": P("model") if tensor_parallel else P()},
            "fc2": {"w": P("model", None) if tensor_parallel else P(),
                    "b": P()},
        },
    }
    if "roi_cnn" in params:
        spec["roi_cnn"] = {
            "conv0": {"w": P(), "b": P()},
            "conv1": {"w": P(), "b": P()},
            "conv2": {"w": P(), "b": P()},
            "fc": {"w": P(None, "model") if tensor_parallel else P(),
                   "b": P("model") if tensor_parallel else P()},
        }
    return spec


def shard_params(params: dict, mesh: Mesh, specs: dict) -> dict:
    """Place a param pytree onto the mesh according to its spec pytree
    (multi-process safe: every process holds identical host params)."""
    return jax.tree.map(
        lambda p, s: put_global(p, mesh, s),
        params,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )
