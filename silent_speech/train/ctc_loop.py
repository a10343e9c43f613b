"""CTC training pipeline — the open-vocabulary path.

Reproduces inactive/train_model.py main() (:192-272): per-label split, silence
trimming, Adam on CTC loss, per-epoch dictionary-scored validation accuracy,
best-val checkpointing with the CTC metadata extras (vocab, blank_id,
label_to_text, uniq_labels). Validation scores every dictionary word for
every clip in one vmapped lattice sweep instead of the reference's O(words)
Python loop per clip.
"""

from __future__ import annotations

import time
from collections import defaultdict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import CTCTrainConfig
from ..data.corpus import scan_corpus
from ..core.schema import load_clip
from ..infer.ctc_decode import Dictionary, trim_silence
from ..models import ctc_model
from ..ops.ctc import ctc_loss, ctc_word_logprobs_batch, length_prior_penalty
from .checkpoint import save_checkpoint
from .step import make_optimizer
import optax
import random


def _load_ctc_arrays(files, label_to_text, cfg: CTCTrainConfig):
    """Load + trim + pad clips into stacked arrays for CTC training."""
    Xs, Rs, Ls, texts = [], [], [], []
    for f in files:
        c = load_clip(f).aligned()
        if c.roi is None:
            raise ValueError(f"CTC training requires ROI in every clip: {f}")
        X, R = trim_silence(
            c.X, c.roi, open_idx=cfg.trim_open_idx,
            thresh=cfg.trim_thresh, pad=cfg.trim_pad,
        )
        T = min(len(X), cfg.max_t)
        Xp = np.zeros((cfg.max_t, X.shape[1]), np.float32)
        Xp[:T] = X[:T]
        # keep the frames uint8: the forward normalizes (/255) on-device —
        # bitwise the reference collate division (inactive/train_model.py:109)
        # at 4x less host RAM + transfer
        Rp = np.zeros((cfg.max_t, cfg.roi_h, cfg.roi_w), np.uint8)
        Rp[:T] = R[:T]
        Xs.append(Xp)
        Rs.append(Rp)
        Ls.append(T)
        texts.append(label_to_text[c.label])
    enc = [ctc_model.encode_text(t) for t in texts]
    Lmax = max(len(e) for e in enc)
    ys = np.zeros((len(enc), Lmax), np.int32)
    ylens = np.zeros(len(enc), np.int32)
    for i, e in enumerate(enc):
        ys[i, : len(e)] = e
        ylens[i] = len(e)
    return (
        np.stack(Xs),
        np.stack(Rs),
        np.asarray(Ls, np.int32),
        ys,
        ylens,
        texts,
    )


def train_ctc(cfg: CTCTrainConfig, verbose: bool = True) -> dict:
    index = scan_corpus(cfg.clip_dir, verbose=False)
    uniq = sorted(set(index.labels))
    label_to_text = {l: ctc_model.normalize_label(l) for l in uniq}
    dictionary = Dictionary.from_words(uniq)

    sample = load_clip(index.files[0])
    x_dim = sample.D

    # per-label split (inactive/train_model.py:203-212)
    rng_py = random.Random(cfg.seed)
    by_lab = defaultdict(list)
    for f, l in zip(index.files, index.labels):
        by_lab[l].append(f)
    train_files, val_files = [], []
    for l, fs in by_lab.items():
        rng_py.shuffle(fs)
        n_val = max(1, int(len(fs) * cfg.val_frac))
        val_files += fs[:n_val]
        train_files += fs[n_val:]

    if not train_files:
        raise ValueError(
            f"no training clips after the per-label split "
            f"({len(index.files)} clips, val_frac={cfg.val_frac}) — the "
            f"corpus is too small (every label's clips went to validation)"
        )
    Xtr, Rtr, Ltr, ytr, yltr, _ = _load_ctc_arrays(train_files, label_to_text, cfg)
    Xva, Rva, Lva, _, _, va_texts = _load_ctc_arrays(val_files, label_to_text, cfg)
    # the normalized val labels ARE the text targets just loaded
    # (label_to_text[l] == normalize_label(l)) — no second disk pass
    va_labels = list(va_texts)

    key = jax.random.PRNGKey(cfg.seed)
    key, init_key = jax.random.split(key)
    params = ctc_model.init_params(
        init_key, x_dim, hidden=cfg.hidden, gru_layers=cfg.gru_layers,
        roi_emb=cfg.roi_emb,
    )
    optimizer = make_optimizer(cfg.lr, grad_clip_norm=1e9)  # reference: no clip
    opt_state = optimizer.init(params)

    compute_dtype = jnp.dtype(cfg.compute_dtype)

    def loss_fn(params, X, R, L, y, ylen, rng):
        lp = ctc_model.forward(params, X, R, L, train=True, rng=rng,
                               compute_dtype=compute_dtype)
        return ctc_loss(lp, L, y, ylen)

    @partial(jax.jit, donate_argnums=(0, 1))
    def train_step(params, opt_state, rng, X, R, L, y, ylen):
        rng, sub, k_gate, k_noise = jax.random.split(rng, 4)
        # per-clip gaussian feature noise, p=0.6 sigma=0.01 on valid frames
        # (inactive/train_model.py:77-80)
        apply = jax.random.bernoulli(k_gate, 0.6, (X.shape[0], 1, 1))
        valid = (jnp.arange(X.shape[1])[None, :, None] < L[:, None, None])
        noise = jax.random.normal(k_noise, X.shape, X.dtype) * 0.01
        X = jnp.where(apply & valid, X + noise, X)
        loss, grads = jax.value_and_grad(loss_fn)(params, X, R, L, y, ylen, sub)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, rng, loss

    @jax.jit
    def val_logprobs(params, X, R, L):
        # the per-epoch validation sweep serves at the serving precision
        return ctc_model.forward(params, X, R, L, train=False,
                                 matmul_precision=ctc_model.SERVING_PRECISION)

    @jax.jit
    def dict_scores(lp, T):
        s = ctc_word_logprobs_batch(
            lp, jnp.asarray(dictionary.ids), jnp.asarray(dictionary.lens), T
        )
        if cfg.len_lambda > 0:
            s = length_prior_penalty(
                s, jnp.asarray(dictionary.lens), T, cfg.len_lambda, cfg.len_per_char
            )
        return s

    # whole val set in one program: (N, T, C) x (N,) -> (N, n_words) — per-clip
    # dispatches would pay one device round trip per clip per epoch
    dict_scores_all = jax.jit(jax.vmap(dict_scores))

    n = len(Xtr)
    sampler = np.random.default_rng(cfg.seed)
    best, bad = 0.0, 0
    best_params = jax.tree.map(np.asarray, params)
    meta = dict(
        x_dim=x_dim, max_t=cfg.max_t, vocab=ctc_model.VOCAB,
        blank_id=ctc_model.BLANK_ID, label_to_text=label_to_text,
        uniq_labels=uniq, exp_len=cfg.len_per_char, len_lambda=cfg.len_lambda,
        gru_layers=cfg.gru_layers, seed=cfg.seed,
        roi_h=cfg.roi_h, roi_w=cfg.roi_w,
    )
    history = []
    for ep in range(1, cfg.epochs + 1):
        t0 = time.perf_counter()
        order = sampler.permutation(n)
        ep_loss = 0.0
        nb = 0
        for s in range(0, n, cfg.batch_size):
            idx = order[s : s + cfg.batch_size]
            params, opt_state, key, loss = train_step(
                params, opt_state, key,
                jnp.asarray(Xtr[idx]), jnp.asarray(Rtr[idx]),
                jnp.asarray(Ltr[idx]), jnp.asarray(ytr[idx]),
                jnp.asarray(yltr[idx]),
            )
            ep_loss += float(loss)
            nb += 1

        # dictionary-scored validation accuracy (one vmapped sweep)
        lp_all = val_logprobs(
            params, jnp.asarray(Xva), jnp.asarray(Rva), jnp.asarray(Lva)
        )
        scores_all = np.asarray(dict_scores_all(lp_all, jnp.asarray(Lva)))
        ok = sum(
            ctc_model.normalize_label(uniq[int(scores_all[b].argmax())])
            == va_labels[b]
            for b in range(len(Xva))
        )
        acc = ok / max(1, len(Xva))
        dt = time.perf_counter() - t0
        if verbose:
            print(f"ep {ep:03d} | loss {ep_loss / max(1, nb):.4f} | "
                  f"val acc {acc:.3f} [{dt:.1f}s]")
        history.append(dict(epoch=ep, loss=ep_loss / max(1, nb), val_acc=acc))

        if acc > best:
            best, bad = acc, 0
            best_params = jax.tree.map(np.asarray, params)
            save_checkpoint(cfg.out_path, best_params, meta)
        else:
            bad += 1
            if bad >= cfg.patience:
                break

    if verbose:
        print("Best val acc:", best)
    return dict(best_acc=best, params=best_params, meta=meta, history=history)
