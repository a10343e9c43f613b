"""Offline dataset evaluation — BASELINE config #2.

The reference sweeps every clip through the model one at a time
(inactive/dataset_eval.py:44-73) printing dataset accuracy, average
confidence, and the top-10 confusion pairs, with labels parsed from
filenames. Here the sweep is batched AND streamed: clips load in bounded
chunks through the native parallel loader (csrc/npz_loader.cpp), so host
memory stays O(chunk_size) regardless of corpus size — a corpus big enough to
motivate an accelerator never has to fit in host RAM at once.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core.schema import fix_dim, load_clip, parse_filename_label, sanitize_field
from ..data.corpus import scan_corpus
from ..data.native_loader import load_corpus_arrays
from .predictor import Predictor


def _softmax(x: np.ndarray, axis=-1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _npz_label(path: str) -> str:
    """Read only the label entry of a clip (cheap: one small zip member),
    falling back to the filename label when the npz lacks one — the same
    tolerance as core.schema.load_clip."""
    with np.load(path, allow_pickle=False) as z:
        if "label" in z.files:
            return str(z["label"])
    return parse_filename_label(path)


def evaluate_dataset(
    predictor: Predictor,
    clip_dir: str,
    *,
    batch_size: int = 64,
    chunk_size: int = 256,
    label_from_filename: bool = True,
    verbose: bool = True,
    top_confusions: int = 10,
) -> dict:
    """Sweep clip_dir with the official model's live forward.

    Returns {accuracy, avg_conf, confusions, n}. Mirrors the reference
    report format: dataset acc, avg conf, top-10 (true, pred) pairs.

    ``chunk_size`` bounds host memory: at most chunk_size padded clips are
    resident at a time (~0.5 MB/clip at the official shapes).
    """
    index = scan_corpus(clip_dir, verbose=False)
    use_roi = predictor.cfg.use_roi
    chunk_size = max(chunk_size, batch_size)

    correct, total, conf_sum = 0, 0, 0.0
    cm: Counter = Counter()
    for cs in range(0, len(index.files), chunk_size):
        files = index.files[cs:cs + chunk_size]
        X, R, L, _has_roi = load_corpus_arrays(
            files, predictor.max_t, predictor.cfg.x_dim, use_roi,
            roi_hw=(predictor.cfg.roi_h, predictor.cfg.roi_w),
        )
        true_labels = [
            parse_filename_label(f) if label_from_filename else _npz_label(f)
            for f in files
        ]
        for s in range(0, len(X), batch_size):
            e = s + batch_size
            logits = predictor.predict_batch(
                X[s:e], L[s:e], None if R is None else R[s:e]
            )
            probs = _softmax(logits)
            preds = probs.argmax(-1)
            for i, pid in enumerate(preds):
                pred_word = predictor.id_to_label.get(int(pid), str(int(pid)))
                if label_from_filename:
                    # filenames store the sanitized ('_'->'-') form; compare
                    # the prediction in the same form or 'my_word' clips
                    # would always score wrong
                    pred_word = sanitize_field(pred_word)
                true_word = true_labels[s + i]
                cm[(true_word, pred_word)] += 1
                correct += int(pred_word == true_word)
                conf_sum += float(probs[i, pid])
                total += 1

    acc = correct / total if total else 0.0
    avg_conf = conf_sum / total if total else 0.0
    confusions = [(p, n) for p, n in cm.most_common(top_confusions)]
    if verbose:
        print("dataset acc:", acc)
        print("avg conf:", avg_conf)
        print("top confusions:", confusions)
    return dict(accuracy=acc, avg_conf=avg_conf, confusions=confusions, n=total)


def zscore(X: np.ndarray) -> np.ndarray:
    """Per-clip feature z-scoring used by the legacy eval pipelines
    (inactive/dataset_eval.py:18-19)."""
    return (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)


def evaluate_variant_dataset(
    predictor,
    clip_dir: str,
    *,
    label_from_filename: bool = True,
    verbose: bool = True,
    top_confusions: int = 10,
) -> dict:
    """Corpus sweep for the feature-only variant families (VariantPredictor):
    per-clip predict with the family's exact preprocessing (fix_dim /
    z-score / deltas / trim), reference report format
    (inactive/dataset_eval.py:44-73)."""
    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    conf_sum = 0.0
    cm: Counter = Counter()
    for f in index.files:
        c = load_clip(f)
        top = predictor.predict_features(c.X.astype(np.float32), k=1)
        pred_word, conf = top[0]
        if label_from_filename:
            pred_word = sanitize_field(pred_word)
        true_word = parse_filename_label(f) if label_from_filename else c.label
        cm[(true_word, pred_word)] += 1
        correct += int(pred_word == true_word)
        conf_sum += float(conf)
        total += 1
    acc = correct / total if total else 0.0
    avg_conf = conf_sum / total if total else 0.0
    confusions = [(p, n) for p, n in cm.most_common(top_confusions)]
    if verbose:
        print("dataset acc:", acc)
        print("avg conf:", avg_conf)
        print("top confusions:", confusions)
    return dict(accuracy=acc, avg_conf=avg_conf, confusions=confusions, n=total)


def evaluate_temporal_cnn(
    params: dict,
    d_in: int,
    id_to_word: dict[int, str],
    clip_dir: str,
    *,
    verbose: bool = True,
) -> dict:
    """Legacy path parity: TemporalCNN over z-scored, dim-fixed clips
    (inactive/dataset_eval.py:44-73 semantics, batched per clip because the
    legacy model takes full variable-length clips)."""
    from ..models.variants import temporal_cnn_forward

    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    conf_sum = 0.0
    cm: Counter = Counter()
    for f in index.files:
        c = load_clip(f)
        X = zscore(fix_dim(c.X.astype(np.float32), d_in))
        logits = np.asarray(temporal_cnn_forward(params, jnp.asarray(X[None])))
        probs = _softmax(logits)[0]
        pid = int(probs.argmax())
        pred_word = sanitize_field(id_to_word.get(pid, str(pid)))
        true_word = parse_filename_label(f)
        cm[(true_word, pred_word)] += 1
        correct += int(pred_word == true_word)
        conf_sum += float(probs[pid])
        total += 1
    acc = correct / total if total else 0.0
    avg_conf = conf_sum / total if total else 0.0
    if verbose:
        print("dataset acc:", acc)
        print("avg conf:", avg_conf)
        print("top confusions:", cm.most_common(10))
        print("model d_in:", d_in)
    return dict(accuracy=acc, avg_conf=avg_conf,
                confusions=cm.most_common(10), n=total)


def evaluate_ctc_dataset(
    ckpt_path: str,
    clip_dir: str,
    *,
    verbose: bool = True,
    chunk_words: int = 0,
    batch_size: int = 64,
    mesh_shape: Optional[dict] = None,
    compute_dtype: str = "float32",
    matmul_precision: str = "",
) -> dict:
    """Dictionary-scored CTC sweep over a corpus: accuracy + top confusions.

    The offline counterpart of the CTC trainer's validation loop
    (inactive/train_model.py:235-251), usable on any saved CTC checkpoint.
    Clips sweep in batches of ``batch_size`` (one forward + one vmapped
    lattice chunk per dictionary chunk — the reference runs one clip at a
    time); serving knobs mirror evaluate_dataset's, and
    ``mesh_shape={'data': N}`` shards the batches over a device mesh
    (CTCDecoder.shard; ragged tails pad and slice back).
    """
    import jax

    from ..models import ctc_model
    from ..train.checkpoint import load_checkpoint
    from .ctc_decode import CTCDecoder, Dictionary, trim_silence

    params, meta, _ = load_checkpoint(ckpt_path)
    params = jax.tree.map(jnp.asarray, params)
    uniq = list(meta["uniq_labels"])
    kw = {}
    if matmul_precision:
        kw["matmul_precision"] = (
            None if matmul_precision in ("default", "none")
            else matmul_precision
        )
    dec = CTCDecoder(
        params, Dictionary.from_words(uniq), max_t=int(meta["max_t"]),
        len_lambda=float(meta.get("len_lambda", 0.02)),
        len_per_char=int(meta.get("exp_len", 5)),
        chunk_words=chunk_words,
        compute_dtype=compute_dtype, **kw,
    )
    if mesh_shape:
        from ..parallel.mesh import mesh_from_shape

        dec.shard(mesh_from_shape(mesh_shape))
        if verbose:
            print("Sharded CTC sweep on mesh", dict(mesh_shape))

    index = scan_corpus(clip_dir, verbose=False)
    correct = total = 0
    cm: Counter = Counter()
    batch: list = []

    def _flush():
        nonlocal correct, total
        if not batch:
            return
        Xb = np.stack([b[0] for b in batch])
        Rb = np.stack([b[1] for b in batch])
        Lb = np.asarray([b[2] for b in batch], np.int32)
        scores = dec.score_batch(Xb, Rb, Lb)
        for (_, _, _, true), pred_i in zip(batch, scores.argmax(-1)):
            pred_n = ctc_model.normalize_label(dec.dict.words[int(pred_i)])
            cm[(true, pred_n)] += 1
            correct += int(pred_n == true)
            total += 1
        batch.clear()

    for f in index.files:
        c = load_clip(f).aligned()
        if c.roi is None:
            continue
        X, R = trim_silence(np.asarray(c.X, np.float32), np.asarray(c.roi),
                            **dec.trim_kw)
        T = min(len(X), dec.max_t)
        if T == 0:
            continue
        Xp = np.zeros((dec.max_t, X.shape[1]), np.float32)
        Xp[:T] = X[:T]
        Rp = np.zeros((dec.max_t,) + R.shape[1:], np.uint8)
        Rp[:T] = R[:T]
        batch.append((Xp, Rp, T, ctc_model.normalize_label(c.label)))
        if len(batch) >= batch_size:
            _flush()
    _flush()
    acc = correct / total if total else 0.0
    if verbose:
        print("dataset acc:", acc)
        print("top confusions:", cm.most_common(10))
    return dict(accuracy=acc, confusions=cm.most_common(10), n=total)
