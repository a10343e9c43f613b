"""Benchmark: official-model inference throughput on one GPU.

Metric: clips/sec for 32-frame landmark+ROI windows through the
live-inference forward (the live_infer_official.py compute path), batched,
data device-resident, at the serving precision; plus
p50_frame_ms, the median time of a B=1 live forward — the work one new frame
triggers in the reference's sliding-window live loop
(inactive/live_feed.py:154-227 re-runs the full window forward per frame).

Runs only on a GPU: without one it exits non-zero and prints no result.
Prints exactly one JSON line naming the device it ran on.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

BASELINE_CLIPS_PER_SEC = 5000.0
T = 32  # frames per clip (reference median clip length)
ITERS = 50
# SST_BENCH_QUICK=1: few iterations — a smoke of the full code path
_QUICK = bool(int(os.environ.get("SST_BENCH_QUICK", "0")))


def main():
    from silent_speech.models import bigru as model
    from silent_speech.runtime.compile_cache import enable_compile_cache
    from silent_speech.runtime.device import card_info, require_gpu

    device = require_gpu()
    enable_compile_cache()
    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)

    @partial(jax.jit, static_argnames=("iters",))
    def loop_fwd(params, X, lengths, roi, iters):
        def body(carry, _):
            Xc, Rc = carry
            logits = model.live_forward(
                params, mcfg, Xc, lengths, Rc,
                matmul_precision=model.SERVING_PRECISION)
            # runtime-zero feedback: keeps every iteration live and distinct
            eps = logits[0, 0] * 1e-30
            Xc = Xc + eps
            Rc = Rc + (eps > 1e30).astype(jnp.uint8)
            return (Xc, Rc), logits[0, 0]
        (Xf, _), outs = lax.scan(body, (X, roi), None, length=iters)
        return outs[-1] + Xf[0, 0, 0]

    rng = np.random.default_rng(0)
    best, best_B = 0.0, 0
    iters = 4 if _QUICK else ITERS
    for B in ((16,) if _QUICK else (256, 512, 1024)):
        X = jnp.asarray(rng.standard_normal((B, T, 180)).astype(np.float32))
        lengths = jnp.asarray(np.full((B,), T, np.int32))
        roi = jnp.asarray(rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8))
        float(loop_fwd(params, X, lengths, roi, iters))  # compile + warm
        t0 = time.perf_counter()
        float(loop_fwd(params, X, lengths, roi, iters))
        dt = (time.perf_counter() - t0) / iters
        cps = B / dt
        if cps > best:
            best, best_B = cps, B

    LAT_ITERS, LAT_REPS = (8, 3) if _QUICK else (64, 9)
    X1 = jnp.asarray(rng.standard_normal((1, T, 180)).astype(np.float32))
    l1 = jnp.asarray(np.full((1,), T, np.int32))
    r1 = jnp.asarray(rng.integers(0, 256, (1, T, 48, 96), dtype=np.uint8))
    float(loop_fwd(params, X1, l1, r1, LAT_ITERS))  # compile + warm
    samples = []
    for _ in range(LAT_REPS):
        t0 = time.perf_counter()
        float(loop_fwd(params, X1, l1, r1, LAT_ITERS))
        samples.append((time.perf_counter() - t0) / LAT_ITERS * 1e3)
    p50_frame_ms = float(np.median(samples))

    print(json.dumps({
        "metric": f"inference_clips_per_sec_T{T}_B{best_B}",
        "value": round(best, 1),
        "unit": "clips/s",
        "vs_baseline": round(best / BASELINE_CLIPS_PER_SEC, 3),
        "p50_frame_ms": round(p50_frame_ms, 4),
        "device": device,
        "card": card_info(),
    }))


if __name__ == "__main__":
    main()
