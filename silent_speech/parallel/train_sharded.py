"""Sharded training step — DP/TP over a ('data', 'model') mesh.

The single-device jitted step (train/step.py) generalizes by annotation only:
batch arrays shard on 'data', params follow bigru_param_specs, and GSPMD
emits the gradient psum over 'data' (and the TP collectives over 'model')
over the device interconnect (NVLink on a multi-GPU host). This is BASELINE
config #5 (data-parallel training across devices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.augment import augment_batch
from ..models import bigru as model
from ..train.step import StepConfig, _make_loss_fn
from .mesh import batch_spec, bigru_param_specs, put_global, shard_params


def make_sharded_train_step(
    scfg: StepConfig,
    optimizer,
    mesh: Mesh,
    params: dict,
    *,
    tensor_parallel: bool = False,
):
    """Returns (sharded_params, opt_state, step_fn).

    step_fn(params, opt_state, rng, X, lengths, roi, y) -> (params, opt_state,
    metrics); batch leading axis must divide the 'data' axis size.
    """
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32
    pspecs = bigru_param_specs(params, tensor_parallel=tensor_parallel)
    # host-copy before placement: device_put can ALIAS a caller's on-device
    # buffers (same device + layout), and the donated step below would then
    # delete the caller's params out from under them on the first call
    params = jax.tree.map(np.asarray, params)
    params = shard_params(params, mesh, pspecs)
    opt_state = optimizer.init(params)

    bspec = batch_spec(mesh)  # spans 'dcn' too on a multislice mesh
    batch_sh = NamedSharding(mesh, bspec)

    # the single-device loss (train/step._make_loss_fn) so every StepConfig
    # knob (label smoothing, dtype, remat, ...) carries to the sharded path
    loss_fn = _make_loss_fn(scfg, dtype)

    # donate params+opt_state like the single-device steps (train/step.py):
    # without it every update keeps the OLD copies alive alongside the new
    # ones — ~2x params+Adam peak device memory at exactly the scaled workloads this
    # subsystem exists for. The loop reassigns both on every call.
    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, rng, X, lengths, roi, y):
        X = jax.lax.with_sharding_constraint(X, batch_sh)
        rng, aug_rng, drop_rng = jax.random.split(rng, 3)
        if scfg.augment is not None:
            X, lengths = augment_batch(aug_rng, X, lengths, scfg.augment)
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, X, lengths, roi, y, drop_rng
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "acc": acc}

    def run(params, opt_state, rng, X, lengths, roi, y):
        X = put_global(X, mesh, bspec)
        lengths = put_global(lengths, mesh, bspec)
        roi = None if roi is None else put_global(roi, mesh, bspec)
        y = put_global(y, mesh, bspec)
        rng = put_global(rng, mesh, P())
        return step(params, opt_state, rng, X, lengths, roi, y)

    return params, opt_state, run


def make_sharded_infer_fn(
    scfg_model: model.BiGRUConfig,
    mesh: Mesh,
    *,
    compute_dtype=jnp.float32,
    matmul_precision=None,
):
    """Data-parallel batched live-forward for serving sweeps — the full
    serving-knob surface of infer.Predictor (Predictor.shard wires this in
    behind ``eval-dataset mesh_shape=``)."""
    bspec = batch_spec(mesh)
    batch_sh = NamedSharding(mesh, bspec)

    @jax.jit
    def fwd(params, X, lengths, roi):
        X = jax.lax.with_sharding_constraint(X, batch_sh)
        return model.live_forward(
            params, scfg_model, X, lengths, roi, compute_dtype=compute_dtype,
            matmul_precision=matmul_precision,
        )

    def run(params, X, lengths, roi):
        X = put_global(X, mesh, bspec)
        lengths = put_global(lengths, mesh, bspec)
        roi = None if roi is None else put_global(roi, mesh, bspec)
        return fwd(params, X, lengths, roi)

    return run
