"""The official training pipeline, end to end.

Reproduces train_model_official.py main() (:315-508) — corpus preflight, modal
dim filter, stratified split, weighted sampling, Adam + CE(ls=0.05) +
grad-clip, per-epoch validation with top-confusion reporting, best-val
checkpointing, patience early stop — with an accelerator execution model: the
dataset lives in device memory, every train step is one jitted XLA program, and the
console lines keep the reference's format (they are the de-facto UX contract).
"""

from __future__ import annotations

import dataclasses
import time
import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import TrainConfig
from ..data import (
    OFFICIAL_AUGMENT,
    build_device_dataset,
    build_label_maps,
    epoch_batches,
    filter_modal_dim,
    inverse_frequency_weights,
    scan_corpus,
    split_by_label,
    top_confusions,
    warn_mixed_idx_signatures,
)
from ..models import bigru as model
from .checkpoint import load_checkpoint, reference_meta, save_checkpoint
from .metrics import MetricsLogger, profiler_trace
from .step import StepConfig, make_eval_step, make_optimizer, make_train_step


def train(
    cfg: TrainConfig,
    verbose: bool = True,
    resume_from: str | None = None,
    metrics_path: str | None = None,
    profile_dir: str | None = None,
) -> dict:
    """Run the full official training pipeline; returns a result dict with
    best_acc, params, meta, and history.

    Beyond the reference protocol: ``resume_from`` restores params +
    optimizer state + epoch counter from a checkpoint saved with
    ``save_opt_state`` (the reference can only cold-start,
    SURVEY.md section 5); ``metrics_path`` streams JSONL metrics;
    ``profile_dir`` captures a jax.profiler trace of the first epoch."""
    if cfg.steps_per_dispatch < 0:
        raise ValueError(
            f"steps_per_dispatch must be >= 0 (0 = whole epoch per "
            f"dispatch), got {cfg.steps_per_dispatch}"
        )
    if (cfg.steps_per_dispatch not in (0, 1)
            and (cfg.mesh_shape or cfg.host_data)):
        # 0 is the default and silently degrades to per-step on these
        # paths; an explicit K>=2 deserves a loud signal
        if verbose:
            print(f"steps_per_dispatch={cfg.steps_per_dispatch} ignored: "
                  "the multi-step scan needs the unsharded device-resident "
                  "dataset (mesh_shape/host_data set) — running per-step")
    index = scan_corpus(cfg.clip_dir, verbose=verbose)
    index, x_dim = filter_modal_dim(index, verbose=verbose)
    warn_mixed_idx_signatures(index, verbose=verbose)

    label_to_id, id_to_label = build_label_maps(index.labels)
    num_classes = len(label_to_id)
    if verbose:
        print("Classes:", sorted(label_to_id))

    train_files, val_files = split_by_label(
        index.files, index.labels, cfg.val_frac, seed=cfg.seed, verbose=verbose
    )
    if verbose:
        print("Train clips:", len(train_files), "Val clips:", len(val_files))

    use_roi = cfg.use_roi_if_present and index.n_roi > 0
    if verbose:
        print("Using ROI in training." if use_roi else "Training WITHOUT ROI.")

    file_label = dict(zip(index.files, index.labels))  # scanned once already
    train_ds = build_device_dataset(
        train_files, label_to_id, cfg.max_t, use_roi, x_dim,
        roi_hw=(cfg.roi_h, cfg.roi_w), device=not cfg.host_data,
        labels=[file_label[f] for f in train_files],
    )
    val_ds = build_device_dataset(
        val_files, label_to_id, cfg.max_t, use_roi, x_dim,
        roi_hw=(cfg.roi_h, cfg.roi_w), device=not cfg.host_data,
        labels=[file_label[f] for f in val_files],
    )
    weights = inverse_frequency_weights(train_ds.labels)

    mcfg = model.BiGRUConfig(
        x_dim=x_dim,
        num_classes=num_classes,
        use_roi=use_roi,
        roi_emb=cfg.roi_emb,
        hidden=cfg.hidden,
        gru_layers=cfg.gru_layers,
        gru_dropout=cfg.gru_dropout,
        head_dropout=cfg.head_dropout,
        roi_h=cfg.roi_h,
        roi_w=cfg.roi_w,
    )
    scfg = StepConfig(
        model=mcfg,
        label_smoothing=cfg.label_smoothing,
        # augmentation driven by the config fields (defaults = the official
        # recipe, train_model_official.py:41-43,144-152)
        augment=dataclasses.replace(
            OFFICIAL_AUGMENT,
            noise_prob=cfg.noise_prob,
            noise_std=cfg.noise_std,
            drop_prob=cfg.drop_frames_prob,
            drop_max=cfg.drop_frames_max,
        ),
        compute_dtype=cfg.compute_dtype,
        roi_remat=cfg.roi_remat,
    )

    key = jax.random.PRNGKey(cfg.seed)
    key, init_key = jax.random.split(key)
    params = model.init_params(init_key, mcfg)
    optimizer = make_optimizer(cfg.lr, cfg.grad_clip_norm)
    opt_state = optimizer.init(params)

    start_epoch = 1
    resumed_opt_leaves = None
    if resume_from is not None:
        r_params, r_meta, r_opt_leaves = load_checkpoint(resume_from)
        params = jax.tree.map(jnp.asarray, r_params)
        if r_opt_leaves is not None:
            resumed_opt_leaves = [jnp.asarray(a) for a in r_opt_leaves]
            opt_state = jax.tree.unflatten(
                jax.tree.structure(opt_state), resumed_opt_leaves
            )
        start_epoch = int(r_meta.get("epoch", 0)) + 1
        # restore the best-so-far bar + patience counter — without these the
        # first post-resume epoch would overwrite the best checkpoint even
        # when its val accuracy is WORSE (best_acc restarting at 0.0)
        resumed_best_acc = float(r_meta.get("best_val_acc", 0.0))
        resumed_bad = int(r_meta.get("bad_epochs", 0))
        if verbose:
            print(f"Resumed from {resume_from} at epoch {start_epoch} "
                  f"(best val acc so far {resumed_best_acc:.3f})")

    mesh = None
    multi_step = None  # set on the device-dataset path when steps_per_dispatch != 1
    if cfg.mesh_shape:
        from ..parallel import make_sharded_train_step
        from ..parallel.mesh import mesh_from_shape

        mesh = mesh_from_shape(cfg.mesh_shape)
        params, opt_state, sharded_step = make_sharded_train_step(
            scfg, optimizer, mesh, params,
            tensor_parallel=(int(cfg.mesh_shape.get("model", 1)) > 1),
        )
        if resumed_opt_leaves is not None:
            # re-apply the resumed optimizer state over the sharded structure
            opt_state = jax.tree.unflatten(
                jax.tree.structure(opt_state), resumed_opt_leaves
            )
        if verbose:
            print("Sharded training on mesh",
                  dict(zip(mesh.axis_names, mesh.devices.shape)))

        def train_step(params, opt_state, rng, X_all, len_all, roi_all,
                       y_all, idx):
            if isinstance(X_all, np.ndarray):
                # host-resident corpus: numpy-gather so only the batch ships
                i = np.asarray(idx)
                Xb, Lb, yb = X_all[i], len_all[i], y_all[i]
                Rb = None if roi_all is None else roi_all[i]
            else:
                Xb = jnp.take(X_all, idx, axis=0)
                Lb = jnp.take(len_all, idx, axis=0)
                Rb = None if roi_all is None else jnp.take(roi_all, idx, axis=0)
                yb = jnp.take(y_all, idx, axis=0)
            rng, sub = jax.random.split(rng)
            params, opt_state, m = sharded_step(
                params, opt_state, sub, Xb, Lb, Rb, yb)
            return params, opt_state, rng, m
    elif cfg.host_data:
        from .step import make_batch_train_step

        batch_step = make_batch_train_step(scfg, optimizer)

        def train_step(params, opt_state, rng, X_all, len_all, roi_all,
                       y_all, idx):
            # host-resident corpus: numpy-gather the batch, ship only it
            i = np.asarray(idx)
            return batch_step(
                params, opt_state, rng,
                jnp.asarray(X_all[i]), jnp.asarray(len_all[i]),
                None if roi_all is None else jnp.asarray(roi_all[i]),
                jnp.asarray(y_all[i]),
            )
    elif cfg.steps_per_dispatch != 1:
        from .step import make_multi_train_step

        multi_step = make_multi_train_step(scfg, optimizer)
    else:
        train_step = make_train_step(scfg, optimizer)
    eval_step = make_eval_step(scfg)

    sampler_rng = np.random.default_rng(cfg.seed)
    meta = reference_meta(
        x_dim=x_dim, max_t=cfg.max_t, use_roi=use_roi,
        roi_w=cfg.roi_w, roi_h=cfg.roi_h,
        labels=sorted(label_to_id), label_to_id=label_to_id,
        id_to_label=id_to_label, seed=cfg.seed, gru_layers=cfg.gru_layers,
    )

    best_acc = resumed_best_acc if resume_from is not None else 0.0
    bad = resumed_bad if resume_from is not None else 0
    # host copy: the jitted step donates the live params buffers, so an alias
    # would dangle if no epoch ever improves val accuracy
    best_params = jax.tree.map(np.asarray, params)
    history = []
    step_rng = key
    mlog = MetricsLogger(metrics_path)

    for ep in range(start_epoch, cfg.epochs + 1):
        t0 = time.perf_counter()
        prof_ctx = profiler_trace(profile_dir if ep == start_epoch else None)
        prof_ctx.__enter__()
        tr_loss = tr_acc = tr_n = 0.0
        try:
            if multi_step is not None:
                # scan K train steps per dispatch (K=0 -> the whole epoch):
                # every training batch is exactly batch_size (pad=True), so
                # the epoch's indices stack to (S, B) and metrics come back
                # as (S,) arrays — one host sync per chunk instead of per
                # step. Same trajectory as the per-step path (same rng
                # sequence; tests/test_train.py pins it).
                batches = list(epoch_batches(
                    train_ds.n, cfg.batch_size, sampler_rng, weights=weights
                ))
                k = (len(batches) if cfg.steps_per_dispatch == 0
                     else cfg.steps_per_dispatch)
                for s in range(0, len(batches), k):
                    idx_mat = jnp.asarray(np.stack(batches[s:s + k]))
                    params, opt_state, step_rng, ms = multi_step(
                        params, opt_state, step_rng,
                        train_ds.X, train_ds.lengths, train_ds.roi,
                        train_ds.y, idx_mat,
                    )
                    n_s = idx_mat.shape[0] * cfg.batch_size
                    tr_loss += float(jnp.sum(ms["loss"])) * cfg.batch_size
                    tr_acc += float(jnp.sum(ms["acc"])) * cfg.batch_size
                    tr_n += n_s
            else:
                for idx in epoch_batches(
                    train_ds.n, cfg.batch_size, sampler_rng, weights=weights
                ):
                    params, opt_state, step_rng, m = train_step(
                        params, opt_state, step_rng,
                        train_ds.X, train_ds.lengths, train_ds.roi,
                        train_ds.y, jnp.asarray(idx),
                    )
                    b = len(idx)
                    tr_loss += float(m["loss"]) * b
                    tr_acc += float(m["acc"]) * b
                    tr_n += b
        finally:
            # a mid-epoch failure must still stop the profiler trace, or a
            # retry in the same process dies with 'profiler already started'
            prof_ctx.__exit__(None, None, None)
        tr_loss /= max(1.0, tr_n)
        tr_acc /= max(1.0, tr_n)

        va_loss = va_acc = va_n = 0.0
        y_true_all, y_pred_all = [], []
        for idx in epoch_batches(
            val_ds.n, cfg.batch_size, sampler_rng, shuffle=False, pad=False
        ):
            Xb, Lb, Rb, yb = val_ds.gather(jnp.asarray(idx))
            m = eval_step(params, Xb, Lb, Rb, yb)
            b = len(idx)
            va_loss += float(m["loss"]) * b
            va_acc += float(m["acc"]) * b
            va_n += b
            y_true_all.extend(np.asarray(yb).tolist())
            y_pred_all.extend(np.asarray(m["pred"]).tolist())
        va_loss /= max(1.0, va_n)
        va_acc /= max(1.0, va_n)

        confs = top_confusions(y_true_all, y_pred_all, id_to_label, k=6)
        conf_str = (" | top confusions: " + ", ".join(confs)) if confs else ""
        dt = time.perf_counter() - t0
        if verbose:
            print(
                f"ep {ep:02d} | train loss {tr_loss:.4f} acc {tr_acc:.3f} | "
                f"val loss {va_loss:.4f} acc {va_acc:.3f}{conf_str} [{dt:.1f}s]"
            )
        history.append(
            dict(epoch=ep, train_loss=tr_loss, train_acc=tr_acc,
                 val_loss=va_loss, val_acc=va_acc, seconds=dt)
        )
        mlog.log(step=ep, train_loss=tr_loss, train_acc=tr_acc,
                 val_loss=va_loss, val_acc=va_acc, epoch_seconds=dt)

        if va_acc > best_acc:
            best_acc = va_acc
            bad = 0
            best_params = jax.tree.map(lambda a: np.asarray(a), params)
            save_checkpoint(
                cfg.out_path, best_params,
                dict(meta, epoch=ep, best_val_acc=best_acc, bad_epochs=bad),
                opt_state_arrays=[np.asarray(a) for a in jax.tree.leaves(opt_state)],
                format=cfg.checkpoint_format,
                async_save=cfg.async_checkpoint,
            )
            if verbose:
                print(f"  saved {cfg.out_path} (best val acc {best_acc:.3f})")
        else:
            bad += 1
            if bad >= cfg.patience:
                if verbose:
                    print(f"Early stopping. Best val acc: {best_acc:.3f}")
                break

    mlog.close()
    if cfg.async_checkpoint:
        from .checkpoint import wait_for_async_saves

        wait_for_async_saves()
    if verbose:
        print("Done. Best val acc:", best_acc)
    return dict(
        best_acc=best_acc, params=best_params, meta=meta, history=history,
        model_config=mcfg,
    )
