"""Head-to-head: the reference's per-frame / per-word loop algorithms vs this
framework's batched device programs, on identical inputs.

The reference publishes no numbers, so its *algorithms* are the baseline:

1. 180-D feature extraction (record_landmarks_official.py:62-100): the
   framework's own host single-frame port (`ops.features.extract_features_
   frame`, which mirrors the reference loop exactly and is parity-pinned by
   tests/test_features.py) driven frame-by-frame the way every reference
   script drives it — vs `extract_features_batched` on the device.
2. CTC dictionary scoring (inactive/train_model.py:166-192, :242-251): the
   reference's O(T*S) per-word NumPy recursion (same port as
   tests/test_ctc._np_word_logprob) — vs `ops.ctc.ctc_word_logprobs_batch`,
   one vmapped lattice sweep for the whole dictionary on the device.

Device timings use the in-graph scan protocol (dispatch excluded), host
timings are plain wall time (the reference ran host-only).

Usage: python scripts/bench_vs_reference.py
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import json
import time
from functools import partial

import numpy as np

import jax.numpy as jnp
from jax import jit, lax

from silent_speech.ops import ctc as ctc_ops
from silent_speech.ops import features as feat_ops


def timed_scan(fn, x, iters):
    @partial(jit, static_argnames=("n",))
    def loop(x, n):
        def body(c, _):
            out = fn(c)
            eps = (out.reshape(-1)[0] * 1e-30).astype(c.dtype)
            return c + eps, out.reshape(-1)[0]
        c, outs = lax.scan(body, x, None, length=n)
        return outs[-1] + c.reshape(-1)[0].astype(jnp.float32)

    float(loop(x, 2))
    float(loop(x, iters))
    t0 = time.perf_counter()
    float(loop(x, iters))
    return (time.perf_counter() - t0) / iters


# ---------------------------------------------------------------------------
# 1. feature extraction
# ---------------------------------------------------------------------------

def bench_features(B=256, T=32, iters=20, host_reps=3):
    rng = np.random.default_rng(0)
    lm = rng.uniform(0.2, 0.8, (B, T, 468, 2)).astype(np.float32)
    w, h = 640, 480

    t0 = time.perf_counter()
    for _ in range(host_reps):
        for b in range(B):
            prev = None
            for t in range(T):
                _, prev, _, _ = feat_ops.extract_features_frame(
                    lm[b, t] , w, h, prev)
    ref_dt = (time.perf_counter() - t0) / host_reps

    lm_j = jnp.asarray(lm)
    dev_dt = timed_scan(
        lambda x: feat_ops.extract_features_batched(x, w, h)[0], lm_j, iters)
    return ref_dt, dev_dt


# ---------------------------------------------------------------------------
# 2. CTC dictionary scoring
# ---------------------------------------------------------------------------

def _np_word_logprob(lp_tc, word_ids, blank=0):
    """Direct numpy port of the reference recursion
    (inactive/train_model.py:167-189) — same as tests/test_ctc.py."""
    ext = [blank]
    for i in word_ids:
        ext += [int(i), blank]
    S, T_ = len(ext), lp_tc.shape[0]
    NEG = -1e30
    alpha = np.full(S, NEG)
    alpha[0] = lp_tc[0, ext[0]]
    if S > 1:
        alpha[1] = lp_tc[0, ext[1]]
    for t in range(1, T_):
        prev = alpha
        alpha = np.full(S, NEG)
        for s in range(S):
            cand = [prev[s]]
            if s >= 1:
                cand.append(prev[s - 1])
            if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                cand.append(prev[s - 2])
            alpha[s] = np.logaddexp.reduce(cand) + lp_tc[t, ext[s]]
    return np.logaddexp(alpha[-1], alpha[-2])


def bench_ctc(T=60, C=27, n_words=1000, iters=10):
    rng = np.random.default_rng(1)
    lp = rng.standard_normal((T, C)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    ids = [rng.integers(1, C, size=rng.integers(3, 9)).tolist()
           for _ in range(n_words)]

    t0 = time.perf_counter()
    ref_scores = np.asarray([_np_word_logprob(lp, i) for i in ids])
    ref_dt = time.perf_counter() - t0

    maxlen = max(len(i) for i in ids)
    ids_pad = np.zeros((n_words, maxlen), np.int32)
    lens = np.zeros((n_words,), np.int32)
    for k, i in enumerate(ids):
        ids_pad[k, : len(i)] = i
        lens[k] = len(i)
    ids_j, lens_j = jnp.asarray(ids_pad), jnp.asarray(lens)
    T_j = jnp.asarray(T, jnp.int32)

    got = np.asarray(
        ctc_ops.ctc_word_logprobs_batch(jnp.asarray(lp), ids_j, lens_j, T_j))
    # reference recursion runs in float64; the device lattice is f32, so compare
    # relatively (scores are ~-190 log-prob units at T=60)
    err = float(np.max(np.abs(got - ref_scores) / np.abs(ref_scores)))

    dev_dt = timed_scan(
        lambda x: ctc_ops.ctc_word_logprobs_batch(x, ids_j, lens_j, T_j),
        jnp.asarray(lp), iters)
    return ref_dt, dev_dt, err


def main():
    f_ref, f_dev = bench_features()
    print(f"features (256x32 frames): ref per-frame loop {f_ref*1e3:9.1f} ms"
          f" | device batched {f_dev*1e3:7.3f} ms | {f_ref/f_dev:7.0f}x",
          flush=True)
    c_ref, c_dev, err = bench_ctc()
    print(f"ctc dict (1000 words, T=60): ref per-word loop {c_ref*1e3:9.1f} ms"
          f" | device vmapped {c_dev*1e3:7.3f} ms | {c_ref/c_dev:7.0f}x"
          f" | rel err {err:.2e}", flush=True)
    print(json.dumps({
        "features_speedup_vs_reference_loop": round(f_ref / f_dev, 1),
        "ctc_dictionary_speedup_vs_reference_loop": round(c_ref / c_dev, 1),
        "ctc_rel_err": err,
    }))


if __name__ == "__main__":
    main()
