"""Training throughput benchmark: steps/s and clips/s for the official train
step (gather + on-device augmentation + fwd + bwd + Adam in one program).

Reports the reference protocol batch (B=16) and a scaled batch (B=256), f32
and bf16, as one JSON line. The timing loop lives inside one jitted scan
(per-step dispatch would otherwise dominate), chaining params through
iterations, so every step is real sequential optimizer work.
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
from jax import lax
import optax

from silent_speech.data.augment import OFFICIAL_AUGMENT, augment_batch
from silent_speech.models import bigru as model
from silent_speech.train.step import make_optimizer, smoothed_cross_entropy

T = 32


def bench_train(B: int, dtype, iters: int = 20,
                roi_remat: bool = False) -> float:
    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    opt = make_optimizer(3e-4)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((B, T, 180)).astype(np.float32))
    L = jnp.asarray(rng.integers(8, T + 1, B).astype(np.int32))
    R = jnp.asarray(rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8))
    y = jnp.asarray(rng.integers(0, 10, B).astype(np.int32))

    def loss_fn(p, Xb, Lb, Rb, yb, key):
        logits = model.train_forward(p, mcfg, Xb, Lb, Rb, train=True, rng=key,
                                     compute_dtype=dtype,
                                     roi_remat=roi_remat)
        return smoothed_cross_entropy(logits, yb, 10, 0.05)

    @partial(jax.jit, static_argnames=("n",))
    def run(params, opt_state, X, L, R, y, n):
        def body(carry, _):
            p, s, key = carry
            key, k1, k2 = jax.random.split(key, 3)
            Xa, La = augment_batch(k1, X, L, OFFICIAL_AUGMENT)
            loss, grads = jax.value_and_grad(loss_fn)(p, Xa, La, R, y, k2)
            updates, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s, key), loss
        (_, _, _), losses = lax.scan(
            body, (params, opt_state, jax.random.PRNGKey(1)), None, length=n)
        return losses[-1]

    float(run(params, opt_state, X, L, R, y, 2))
    float(run(params, opt_state, X, L, R, y, iters))
    t0 = time.perf_counter()
    float(run(params, opt_state, X, L, R, y, iters))
    return (time.perf_counter() - t0) / iters


def main():
    out = {}
    for B, dtype, remat, tag in (
        (16, jnp.float32, False, "B16_f32"),
        (256, jnp.float32, False, "B256_f32"),
        (256, jnp.bfloat16, False, "B256_bf16"),
        # roi_remat: recompute the ROI-CNN activations in the backward
        (256, jnp.float32, True, "B256_f32_remat"),
        (256, jnp.bfloat16, True, "B256_bf16_remat"),
        (16, jnp.float32, True, "B16_f32_remat"),
    ):
        dt = bench_train(B, dtype, roi_remat=remat)
        out[tag] = {"step_ms": round(dt * 1e3, 3),
                    "clips_per_sec": round(B / dt, 1)}
        print(f"# {tag}: {out[tag]}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
