"""Training-step profiling harness: where does the train step's time go?

Times the official train step (gather-free batch path: augment + fwd + bwd +
Adam as one XLA program) at B=256, captures a jax.profiler trace, then
aggregates the 'XLA Ops' rows from the chrome-trace JSON into a
per-op-category breakdown.

Usage: python scripts/profile_train.py [--trace DIR] [--dtype f32|bf16]
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import glob
import gzip
import json
import os
import re
import time
from collections import defaultdict
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
import optax

from silent_speech.data.augment import OFFICIAL_AUGMENT, augment_batch
from silent_speech.models import bigru as model
from silent_speech.train.step import make_optimizer, smoothed_cross_entropy

B, T = 256, 32
ITERS = 20


def build(dtype):
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
                                     compute_dtype=dtype)
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

    return run, (params, opt_state, X, L, R, y)


_CATEGORIES = [
    ("conv backward", re.compile(r"conv.*(backward|transpose|grad)|gradients.*conv", re.I)),
    ("convolution", re.compile(r"convolution|conv_general|%conv", re.I)),
    ("reduce-window/pool", re.compile(r"reduce-window|reduce_window|select-and-scatter", re.I)),
    ("matmul/dot", re.compile(r"dot|einsum|matmul", re.I)),
    ("while/scan (GRU)", re.compile(r"while", re.I)),
    ("copy/transpose/layout", re.compile(r"copy|transpose|bitcast|reshape", re.I)),
    ("dynamic-slice/gather", re.compile(r"slice|gather|scatter|take", re.I)),
    ("rng", re.compile(r"rng|random|threefry", re.I)),
    ("fusion (elementwise)", re.compile(r"fusion", re.I)),
]


def categorize(name: str) -> str:
    for cat, pat in _CATEGORIES:
        if pat.search(name):
            return cat
    return "other"


def parse_trace(trace_dir: str):
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        print(f"no trace.json.gz found under {trace_dir}")
        return
    with gzip.open(files[-1]) as f:
        d = json.load(f)
    ev = d.get("traceEvents", [])
    # find the 'XLA Ops' thread ids per pid
    op_tids = {(e["pid"], e["tid"]) for e in ev
               if e.get("ph") == "M" and e.get("name") == "thread_name"
               and e.get("args", {}).get("name") == "XLA Ops"}
    by_cat = defaultdict(float)
    by_name = defaultdict(float)
    total = 0.0
    for e in ev:
        if e.get("ph") != "X" or (e.get("pid"), e.get("tid")) not in op_tids:
            continue
        dur = e.get("dur", 0) / 1e3  # us -> ms
        name = e.get("name", "?")
        by_cat[categorize(name)] += dur
        by_name[name] += dur
        total += dur
    print(f"\n== XLA Ops breakdown ({files[-1]}, total {total:.2f} ms) ==")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:>28s}: {ms:9.2f} ms  {100*ms/max(total,1e-9):5.1f}%")
    print("\n== top 20 ops ==")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.2f} ms  {name[:110]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="/tmp/train_trace")
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    dtype = jnp.float32 if args.dtype == "f32" else jnp.bfloat16

    run, state = build(dtype)
    float(run(*state, 2))
    float(run(*state, args.iters))
    t0 = time.perf_counter()
    float(run(*state, args.iters))
    dt = (time.perf_counter() - t0) / args.iters
    print(f"train step B={B} {args.dtype}: "
          f"{dt*1e3:.3f} ms/step ({B/dt:.0f} clips/s)", flush=True)

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        # silence the host/python tracers — a jitted scan emits ~1M python
        # events that crowd the device rows out of the trace-event cap
        opts = jax.profiler.ProfileOptions()
        opts.host_tracer_level = 0
        opts.python_tracer_level = 0
        jax.profiler.start_trace(args.trace, profiler_options=opts)
        try:
            out = run(*state, 3)
            np.asarray(out)
        finally:
            jax.profiler.stop_trace()
        parse_trace(args.trace)


if __name__ == "__main__":
    main()
