"""Jitted train/eval steps for the official classifier.

The whole reference inner loop (train_model_official.py:426-443: forward,
CE+label-smoothing, backward, global-norm clip, Adam step) is one XLA program
per batch. Batches arrive as *indices* into the device-resident dataset, so
the gather + augmentation + forward + backward + update all fuse on device
with no host transfer.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import optax

from ..data.augment import AugmentConfig, augment_batch
from ..models import bigru as model


def smoothed_cross_entropy(logits, y, num_classes: int, smoothing: float):
    """CE with label smoothing, matching nn.CrossEntropyLoss(label_smoothing=e)."""
    onehot = jax.nn.one_hot(y, num_classes, dtype=logits.dtype)
    target = onehot * (1.0 - smoothing) + smoothing / num_classes
    return jnp.mean(optax.softmax_cross_entropy(logits, target))


def make_optimizer(lr: float, grad_clip_norm: float = 1.0):
    """Adam + global-norm clipping (train_model_official.py:403,438)."""
    return optax.chain(
        optax.clip_by_global_norm(grad_clip_norm),
        optax.adam(lr),
    )


@dataclasses.dataclass(frozen=True)
class StepConfig:
    model: model.BiGRUConfig
    label_smoothing: float = 0.05
    augment: Optional[AugmentConfig] = None
    compute_dtype: str = "float32"
    # recompute ROI-CNN activations in the backward (identical grads, less
    # activation memory traffic)
    roi_remat: bool = False


def _make_loss_fn(scfg: StepConfig, dtype):
    def loss_fn(params, X, lengths, roi, y, rng):
        logits = model.train_forward(
            params, scfg.model, X, lengths, roi, train=True, rng=rng,
            compute_dtype=dtype, roi_remat=scfg.roi_remat,
        )
        loss = smoothed_cross_entropy(
            logits, y, scfg.model.num_classes, scfg.label_smoothing
        )
        acc = jnp.mean((jnp.argmax(logits, -1) == y).astype(jnp.float32))
        return loss, acc

    return loss_fn


def make_train_step(scfg: StepConfig, optimizer):
    """Returns jitted step(params, opt_state, rng, data_arrays, idx) — the
    device-resident-dataset path: the batch gather happens on device inside the
    program."""
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32
    loss_fn = _make_loss_fn(scfg, dtype)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, rng, X_all, len_all, roi_all, y_all, idx):
        X = jnp.take(X_all, idx, axis=0)
        lengths = jnp.take(len_all, idx, axis=0)
        roi = None if roi_all is None else jnp.take(roi_all, idx, axis=0)
        y = jnp.take(y_all, idx, axis=0)
        rng, aug_rng, drop_rng = jax.random.split(rng, 3)
        if scfg.augment is not None:
            X, lengths = augment_batch(aug_rng, X, lengths, scfg.augment)
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, X, lengths, roi, y, drop_rng
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, rng, {"loss": loss, "acc": acc}

    return step


def make_multi_train_step(scfg: StepConfig, optimizer):
    """Returns jitted multi(params, opt_state, rng, data_arrays, idx_mat) —
    ``idx_mat`` is (S, B) batch indices and the program runs S full train
    steps as one ``lax.scan`` dispatch, returning stacked (S,) metrics.

    The scan body is make_train_step's body verbatim (same rng split
    sequence, same gather/augment/update), so S scanned steps follow the
    SAME training trajectory as S sequential dispatches with the same
    starting rng — pinned by tests/test_train.py. The point is dispatch
    amortization: the per-step loop pays a host round trip per step to
    fetch metrics (float(m['loss'])), which dominates wall time at the
    reference protocol's B=16 where the step itself is a few ms. One
    dispatch per epoch makes the host cost O(1); the compiled program is the step body compiled
    once (scan), so compile time does not scale with S.
    """
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32
    loss_fn = _make_loss_fn(scfg, dtype)

    @partial(jax.jit, donate_argnums=(0, 1))
    def multi(params, opt_state, rng, X_all, len_all, roi_all, y_all,
              idx_mat):
        def body(carry, idx):
            params, opt_state, rng = carry
            X = jnp.take(X_all, idx, axis=0)
            lengths = jnp.take(len_all, idx, axis=0)
            roi = None if roi_all is None else jnp.take(roi_all, idx, axis=0)
            y = jnp.take(y_all, idx, axis=0)
            rng, aug_rng, drop_rng = jax.random.split(rng, 3)
            if scfg.augment is not None:
                X, lengths = augment_batch(aug_rng, X, lengths, scfg.augment)
            (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, X, lengths, roi, y, drop_rng
            )
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state, rng), {"loss": loss, "acc": acc}

        (params, opt_state, rng), ms = jax.lax.scan(
            body, (params, opt_state, rng), idx_mat)
        return params, opt_state, rng, ms

    return multi


def make_batch_train_step(scfg: StepConfig, optimizer):
    """Returns jitted step(params, opt_state, rng, X, lengths, roi, y) on
    pre-gathered batches — the host-resident-dataset path (only the batch
    crosses PCIe per step)."""
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32
    loss_fn = _make_loss_fn(scfg, dtype)

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, rng, X, lengths, roi, y):
        rng, aug_rng, drop_rng = jax.random.split(rng, 3)
        if scfg.augment is not None:
            X, lengths = augment_batch(aug_rng, X, lengths, scfg.augment)
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, X, lengths, roi, y, drop_rng
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, rng, {"loss": loss, "acc": acc}

    return step


def make_eval_step(scfg: StepConfig):
    """Jitted eval step: loss/acc/predictions on the training-path forward in
    eval mode (the reference validates with model.eval() but keeps the
    standardized ROI path, train_model_official.py:449-475)."""
    dtype = jnp.bfloat16 if scfg.compute_dtype == "bfloat16" else jnp.float32

    @jax.jit
    def step(params, X, lengths, roi, y):
        logits = model.train_forward(
            params, scfg.model, X, lengths, roi, train=False,
            compute_dtype=dtype,
        )
        loss = smoothed_cross_entropy(
            logits, y, scfg.model.num_classes, scfg.label_smoothing
        )
        pred = jnp.argmax(logits, -1)
        acc = jnp.mean((pred == y).astype(jnp.float32))
        return {"loss": loss, "acc": acc, "pred": pred}

    return step
