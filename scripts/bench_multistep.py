"""Reference-protocol (B=16) training: per-step dispatch vs steps_per_dispatch.

At B=16 the official train loop pays a host round trip per step to fetch
metrics. TrainConfig.steps_per_dispatch=K scans K optimizer steps over the
device-resident dataset inside ONE jit (train/step.make_multi_train_step, same
trajectory as the per-step loop — pinned by tests/test_train.py). This
script measures the real loop cost, host syncs included, for K = 1 (the
per-step path), 8, 32, and whole-epoch.

Usage: python scripts/bench_multistep.py [B] [T]
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from silent_speech.data.augment import OFFICIAL_AUGMENT
from silent_speech.models import bigru as model
from silent_speech.train.step import (
    StepConfig,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    N = 4096  # device-resident corpus size (clips)
    steps = N // B  # one epoch

    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    scfg = StepConfig(model=mcfg, augment=OFFICIAL_AUGMENT)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    opt = make_optimizer(3e-4)

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((N, T, 180)).astype(np.float32))
    L = jnp.asarray(rng.integers(8, T + 1, N).astype(np.int32))
    R = jnp.asarray(rng.integers(0, 256, (N, T, 48, 96), dtype=np.uint8))
    y = jnp.asarray(rng.integers(0, 10, N).astype(np.int32))
    order = rng.permutation(N)
    batches = [order[s:s + B] for s in range(0, N, B)]

    per_step = make_train_step(scfg, opt)
    multi = make_multi_train_step(scfg, opt)
    out = {"B": B, "T": T, "steps_per_epoch": steps}

    # the jitted steps donate (params, opt_state) — re-place fresh device
    # copies from host numpy each epoch or the second run reads deleted
    # buffers (the real loop never restarts from stale params)
    params_np = jax.tree.map(np.asarray, params)

    def _fresh():
        p = jax.tree.map(jnp.asarray, params_np)
        return p, opt.init(p)

    def epoch_per_step():
        p, s = _fresh()
        key = jax.random.PRNGKey(1)
        tot = 0.0
        for idx in batches:
            p, s, key, m = per_step(p, s, key, X, L, R, y, jnp.asarray(idx))
            tot += float(m["loss"])  # the real loop's per-step metric fetch
        return tot

    def epoch_multi(K):
        p, s = _fresh()
        key = jax.random.PRNGKey(1)
        tot = 0.0
        for c in range(0, steps, K):
            idx_mat = jnp.asarray(np.stack(batches[c:c + K]))
            p, s, key, ms = multi(p, s, key, X, L, R, y, idx_mat)
            tot += float(jnp.sum(ms["loss"]))
        return tot

    # warm both programs (first compile excluded from timing)
    epoch_per_step()
    for tag, fn in [("per_step", epoch_per_step)] + [
            (f"K={k}", (lambda k=k: epoch_multi(k)))
            for k in (8, 32, steps)]:
        fn()  # warm (K variants compile on their own shapes)
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            reps.append(time.perf_counter() - t0)
        dt = min(reps)
        out[tag] = {
            "epoch_s": round(dt, 4),
            "ms_per_step": round(1e3 * dt / steps, 4),
            "clips_per_s": round(N / dt, 1),
        }
        print(tag, out[tag], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
