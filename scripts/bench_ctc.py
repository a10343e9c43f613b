"""CTC family throughput: train step + batched dictionary eval.

- train: CTC loss fwd+bwd+Adam per step (inactive/train_model.py protocol
  B=32 T=80, plus a scaled B=256) — timed inside one jitted lax.scan
  chaining params (same pattern as bench_train.py).
- eval: CTCDecoder.score_batch (one batched forward + vmapped dictionary
  lattice sweep — the eval-ctc path) at default and serving precision,
  wall-clock over warm repeats with host materialization (the honest e2e).

Usage: python scripts/bench_ctc.py
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import json
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
import optax

from silent_speech.infer.ctc_decode import CTCDecoder, Dictionary
from silent_speech.models import ctc_model
from silent_speech.ops.ctc import ctc_loss
from silent_speech.train.step import make_optimizer

T = 80  # inactive/train_model.py MAX_T
D = 180


def bench_ctc_train(B: int, iters: int = 10, dtype=jnp.float32) -> float:
    params = ctc_model.init_params(jax.random.PRNGKey(0), D)
    opt = make_optimizer(1e-3, grad_clip_norm=1e9)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((B, T, D)).astype(np.float32))
    R = jnp.asarray(rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8))
    L = jnp.asarray(rng.integers(T // 2, T + 1, B).astype(np.int32))
    y = jnp.asarray(rng.integers(1, 27, (B, 6)).astype(np.int32))
    ylen = jnp.asarray(rng.integers(2, 7, B).astype(np.int32))

    def loss_fn(p, key):
        lp = ctc_model.forward(p, X, R, L, train=True, rng=key,
                               compute_dtype=dtype)
        return ctc_loss(lp, L, y, ylen)

    @partial(jax.jit, static_argnames=("n",))
    def run(params, opt_state, n):
        def body(carry, _):
            p, s, key = carry
            key, sub = jax.random.split(key)
            loss, grads = jax.value_and_grad(loss_fn)(p, sub)
            updates, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s, key), loss

        (p, s, _), losses = jax.lax.scan(
            body, (params, opt_state, jax.random.PRNGKey(1)), None, length=n)
        return p, s, losses[-1]

    # time by host materialization of the scan-chained loss. Warm BOTH
    # static-n programs (each n is its own jit cache entry).
    float(run(params, opt_state, n=2)[2])
    float(run(params, opt_state, n=iters)[2])
    t0 = time.perf_counter()
    float(run(params, opt_state, n=iters)[2])
    t1 = time.perf_counter()
    # subtract the fixed dispatch via a short warm run
    t2 = time.perf_counter()
    float(run(params, opt_state, n=2)[2])
    t3 = time.perf_counter()
    ms = 1e3 * ((t1 - t0) - (t3 - t2)) / (iters - 2)
    return ms


def bench_ctc_eval(B: int, n_words: int, *, prec, reps: int = 5) -> float:
    params = ctc_model.init_params(jax.random.PRNGKey(0), D)
    rng = np.random.default_rng(1)
    # synthetic a-z dictionary of n_words 3-8 char words
    words = ["".join(chr(97 + c) for c in rng.integers(0, 26,
                                                       rng.integers(3, 9)))
             for _ in range(n_words)]
    dec = CTCDecoder(params, Dictionary.from_words(words), max_t=T,
                     matmul_precision=prec)
    # pre-place the batch on device (jnp.asarray of a device array is free)
    # so the number is the device-side serving cost without the host copy
    X = jnp.asarray(rng.standard_normal((B, T, D)).astype(np.float32))
    R = jnp.asarray(rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8))
    L = jnp.asarray(rng.integers(T // 2, T + 1, B).astype(np.int32))
    dec.score_batch(X, R, L)  # compile+warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dec.score_batch(X, R, L)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    import sys

    out = {"backend": jax.default_backend(), "T": T}
    if "eval-only" not in sys.argv[1:]:
        for B in (32, 256):
            ms = bench_ctc_train(B)
            key = f"train_B{B}"
            out[key] = {"ms_per_step": round(ms, 3),
                        "clips_per_s": round(B / ms * 1e3, 1)}
            print(key, out[key], flush=True)
    for n_words in (10, 1000):
        for prec, tag in ((None, "default"), ("highest", "highest")):
            B = 256
            dt = bench_ctc_eval(B, n_words, prec=prec)
            key = f"eval_B{B}_W{n_words}_{tag}"
            out[key] = {"batch_s": round(dt, 4),
                        "clips_per_s": round(B / dt, 1)}
            print(key, out[key], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
