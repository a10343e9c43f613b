"""Production-scale end-to-end soak: 10k-clip corpus, full official pipeline.

Generates a 10,000-clip synthetic corpus (10 words x 1000, ROI included) in
the reference .npz layout, then runs the real production path on the GPU:

1. corpus scan + native parallel load into the device-resident dataset
   (ingest clips/s measured);
2. official training, B=256 bf16, a few epochs (wall/epoch measured);
3. the streaming offline evaluator over all 10k clips through the live
   forward (eval clips/s measured) + accuracy (should reach ~1.0: the
   synthetic classes are separable).

Prints one JSON summary line at the end.

Usage: python scripts/soak_scale.py [--clips-per-word N] [--epochs N]
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import os
import tempfile
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clips-per-word", type=int, default=1000)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--dir", default="")
    args = ap.parse_args()

    from silent_speech.core.config import TrainConfig
    from silent_speech.data.synthetic import WORDS, generate_corpus
    from silent_speech.infer import Predictor, evaluate_dataset
    from silent_speech.train import train

    root = args.dir or tempfile.mkdtemp(prefix="sst_soak_")
    corpus = os.path.join(root, "clips_npz")
    n_clips = args.clips_per_word * len(WORDS)

    t0 = time.perf_counter()
    generate_corpus(corpus, clips_per_word=args.clips_per_word, seed=11)
    t_gen = time.perf_counter() - t0
    print(f"generated {n_clips} clips in {t_gen:.1f}s ({root})", flush=True)

    ckpt = os.path.join(root, "word_model.ckpt")
    cfg = TrainConfig(
        clip_dir=corpus,
        out_path=ckpt,
        epochs=args.epochs,
        patience=args.epochs,
        batch_size=256,
        max_t=32,
        lr=1e-3,
        compute_dtype="bfloat16",
    )
    t0 = time.perf_counter()
    result = train(cfg, verbose=True)
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(ckpt, compute_dtype="bfloat16")
    ev = evaluate_dataset(pred, corpus, batch_size=256, verbose=True)
    t_eval = time.perf_counter() - t0

    # steady state excludes the first epoch (jit compile + corpus preflight)
    steady = [h["seconds"] for h in result["history"][1:]] or [t_train]
    steady_s = sum(steady) / len(steady)
    print(json.dumps({
        "n_clips": n_clips,
        "train_s_per_epoch_steady": round(steady_s, 2),
        "train_clips_per_sec_steady": round(n_clips * 0.85 / steady_s, 1),
        "train_wall_s_total": round(t_train, 1),
        "best_val_acc": round(float(result["best_acc"]), 4),
        "eval_clips_per_sec": round(ev["n"] / t_eval, 1),
        "eval_accuracy": round(float(ev["accuracy"]), 4),
    }))


if __name__ == "__main__":
    main()
