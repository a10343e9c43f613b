"""Streaming latency benchmark (secondary metric): p50/p95 per-event latency.

Measures, on the real device:
- single-clip prediction latency (the live_infer_official predict block):
  (1, T<=90) live forward, p50/p95 over repeated calls;
- sliding-window step latency (live_feed cadence): (1, max_t, 83)
  GRUWordClassifier forward;
- per-frame carry-streaming step latency (CarryStreamingGRU).

Host dispatch is part of single-call latency, so each measurement also
reports the in-graph amortized time (scan of 100 steps) — the number that
matters once dispatch is pipelined.
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


def _p(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _amortized(fn, args, iters=100):
    @partial(jax.jit, static_argnames=())
    def loop(*a):
        def body(c, _):
            out = fn(*a)
            return c + out.ravel()[0] * 1e-30, out.ravel()[0]
        _, outs = lax.scan(body, jnp.float32(0), None, length=iters)
        return outs[-1]
    float(loop(*args))
    t0 = time.perf_counter()
    float(loop(*args))
    return (time.perf_counter() - t0) / iters


def main():
    from silent_speech.models import bigru as model
    from silent_speech.models.variants import (
        gru_word_classifier_forward,
        init_gru_word_classifier,
        init_unigru_classifier,
    )
    from silent_speech.infer.streaming import CarryStreamingGRU
    from silent_speech.ops.nn import dense

    rng = np.random.default_rng(0)
    # the pipeline comparison is host-dependent: with one host core the
    # producer's landmarker busy-wait and the consumer thread contend for
    # the GIL, so record the core count next to the numbers
    import os
    results = {"host_cpu_cores": os.cpu_count()}

    # 1. clip predict (official model, T=90 bucket)
    mcfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    X = jnp.asarray(rng.standard_normal((1, 90, 180)).astype(np.float32))
    L = jnp.asarray(np.asarray([60], np.int32))
    R = jnp.asarray(rng.integers(0, 256, (1, 90, 48, 96), dtype=np.uint8))

    fwd = jax.jit(lambda p, X, L, R: model.live_forward(p, mcfg, X, L, R))
    np.asarray(fwd(params, X, L, R))
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        np.asarray(fwd(params, X, L, R))
        ts.append(time.perf_counter() - t0)
    results["clip_predict_ms"] = {
        "p50": 1e3 * _p(ts, 0.5), "p95": 1e3 * _p(ts, 0.95),
        "amortized": 1e3 * _amortized(
            lambda p, X, L, R: fwd(p, X, L, R), (params, X, L, R)),
    }

    # 2. sliding-window step (83-D family, max_t=90)
    wparams = init_gru_word_classifier(jax.random.PRNGKey(1), 83, 20)
    Xw = jnp.asarray(rng.standard_normal((1, 90, 83)).astype(np.float32))
    wfwd = jax.jit(lambda p, X: gru_word_classifier_forward(p, X))
    np.asarray(wfwd(wparams, Xw))
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        np.asarray(wfwd(wparams, Xw))
        ts.append(time.perf_counter() - t0)
    results["window_step_ms"] = {
        "p50": 1e3 * _p(ts, 0.5), "p95": 1e3 * _p(ts, 0.95),
        "amortized": 1e3 * _amortized(lambda p, X: wfwd(p, X), (wparams, Xw)),
    }

    # 3. per-frame carry streaming (uni-GRU)
    uparams = init_unigru_classifier(jax.random.PRNGKey(2), 180, 10)
    eng = CarryStreamingGRU(uparams["gru"],
                            head=lambda h: dense(h, uparams["head"]))
    frame = rng.standard_normal(180).astype(np.float32)
    eng.push(frame)
    ts = []
    for _ in range(60):
        t0 = time.perf_counter()
        eng.push(frame)
        ts.append(time.perf_counter() - t0)
    results["carry_frame_ms"] = {
        "p50": 1e3 * _p(ts, 0.5), "p95": 1e3 * _p(ts, 0.95)}

    # 4. pipeline=threaded vs sequential at a paced 30 fps camera with an
    # emulated MediaPipe host cost: per-frame latency (frame ready -> engine
    # scored) p50/p99, achieved fps, and ring drops. The threaded pipeline
    # overlaps the landmarker busy-time with device dispatch
    # (runtime/pipeline.LivePipeline — apps/live.infer_stream
    # pipeline=threaded); the sequential loop adds them.
    results["pipeline_30fps"] = _pipeline_compare(wparams, rng)
    # stress: score EVERY frame with a slow (20 ms) landmarker — the
    # sequential loop's frame handler (landmarker + dispatch) now exceeds
    # the 33 ms budget, so it loses fps; the threaded pipeline overlaps the
    # two stages and holds the camera rate (dropping if the engine can't
    # keep up, which is visible instead of silent lag)
    results["pipeline_30fps_stress"] = _pipeline_compare(
        wparams, rng, lm_cost=0.020, pred_every=1)

    print(json.dumps(results, default=lambda o: round(float(o), 3)))


def _pipeline_compare(wparams, rng, n_frames=240, fps=30.0, lm_cost=0.008,
                      pred_every=2):
    from silent_speech.core.config import StreamConfig
    from silent_speech.infer.streaming import SlidingWindowEngine
    from silent_speech.models.variants import gru_word_classifier_forward
    from silent_speech.runtime.pipeline import FramePacker, LivePipeline

    period = 1.0 / fps
    feats = rng.standard_normal((n_frames, 83)).astype(np.float32)
    wfwd = jax.jit(lambda X: gru_word_classifier_forward(wparams, X))
    scfg = StreamConfig(max_t=90, pred_every=pred_every, warmup_min=10)

    def paced_source(t0):
        """30 fps camera + busy-wait landmarker emulation; ts in us."""
        for i in range(n_frames):
            target = t0 + i * period
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            busy_end = time.perf_counter() + lm_cost
            while time.perf_counter() < busy_end:
                pass
            yield feats[i], None, int((time.perf_counter() - t0) * 1e6)

    out = {}
    for mode in ("sequential", "threaded"):
        eng = SlidingWindowEngine(wfwd, 83, scfg)
        eng.push(feats[0])  # compile outside the timed run
        for _ in range(scfg.warmup_min * scfg.pred_every):
            eng.push(feats[0])
        eng.reset()
        lat = []
        t0 = time.perf_counter()
        if mode == "sequential":
            for feat, _roi, ts_us in paced_source(t0):
                eng.push(feat)
                lat.append((time.perf_counter() - t0) * 1e6 - ts_us)
            dropped = 0
        else:
            def sink(feat, _roi, ts_us, _eng=eng, _lat=lat, _t0=t0):
                _eng.push(feat)
                _lat.append((time.perf_counter() - _t0) * 1e6 - ts_us)

            pipe = LivePipeline(paced_source(t0), sink,
                                FramePacker(feat_dim=83), capacity=64)
            stats = pipe.run(timeout=n_frames * period * 4)
            dropped = stats["dropped"]
        wall = time.perf_counter() - t0
        out[mode] = {
            "lat_ms_p50": _p(lat, 0.5) / 1e3,
            "lat_ms_p99": _p(lat, 0.99) / 1e3,
            "achieved_fps": (len(lat) + dropped) / wall,
            "dropped": dropped,
        }
    return out


if __name__ == "__main__":
    main()
