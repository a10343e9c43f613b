"""Scaled-workload benchmark: the framework beyond the 1.19 M-param model.

SURVEY.md section 2.4 scopes TP/SP hooks to "the scaled workload (bigger
vocab, higher-res ROI)". This script builds that workload — hidden=1024,
3 GRU layers, 512-dim features, 1000-word vocab, 96x192 ROI (49.2 M params)
— and measures:

1. single-GPU train-step throughput (f32 + bf16);
2. single-GPU inference throughput (bf16 serving);
3. the DP+TP sharded step on an 8-virtual-device ('data'=4, 'model'=2) CPU
   mesh: executes, loss finite, and the GRU/head params are actually laid
   out on the 'model' axis (sharding asserted) — proving the TP hooks carry
   a model where activations/params are worth sharding.

Usage: python scripts/bench_scaled.py [--mesh-only]
"""

from __future__ import annotations

import sys as _sys, pathlib as _pathlib  # _REPO_ROOT_BOOTSTRAP: run without PYTHONPATH
_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
import optax

from silent_speech.models import bigru as model
from silent_speech.train.step import make_optimizer, smoothed_cross_entropy

SCALED = dict(x_dim=512, num_classes=1000, use_roi=True, roi_emb=64,
              hidden=1024, gru_layers=3, head_hidden=512, roi_h=96, roi_w=192)
B, T = 64, 32


def n_params(params):
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))


def bench_train_scaled(dtype, iters=10):
    mcfg = model.BiGRUConfig(**SCALED)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    opt = make_optimizer(3e-4)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((B, T, mcfg.x_dim)).astype(np.float32))
    L = jnp.asarray(rng.integers(8, T + 1, B).astype(np.int32))
    R = jnp.asarray(rng.integers(0, 256, (B, T, mcfg.roi_h, mcfg.roi_w),
                                 dtype=np.uint8))
    y = jnp.asarray(rng.integers(0, mcfg.num_classes, B).astype(np.int32))

    def loss_fn(p, key):
        logits = model.train_forward(p, mcfg, X, L, R, train=True, rng=key,
                                     compute_dtype=dtype)
        return smoothed_cross_entropy(logits, y, mcfg.num_classes, 0.05)

    @partial(jax.jit, static_argnames=("n",))
    def run(params, opt_state, n):
        def body(carry, _):
            p, s, key = carry
            key, k = jax.random.split(key)
            loss, grads = jax.value_and_grad(loss_fn)(p, k)
            updates, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s, key), loss
        (_, _, _), losses = lax.scan(
            body, (params, opt_state, jax.random.PRNGKey(1)), None, length=n)
        return losses[-1]

    float(run(params, opt_state, 2))
    float(run(params, opt_state, iters))
    t0 = time.perf_counter()
    float(run(params, opt_state, iters))
    dt = (time.perf_counter() - t0) / iters
    return dt, n_params(params)


def bench_infer_scaled(dtype, iters=20):
    mcfg = model.BiGRUConfig(**SCALED)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((B, T, mcfg.x_dim)).astype(np.float32))
    L = jnp.asarray(np.full((B,), T, np.int32))
    R = jnp.asarray(rng.integers(0, 256, (B, T, mcfg.roi_h, mcfg.roi_w),
                                 dtype=np.uint8))

    @partial(jax.jit, static_argnames=("n",))
    def run(X, n):
        def body(c, _):
            logits = model.live_forward(params, mcfg, c, L, R,
                                        compute_dtype=dtype)
            eps = (logits[0, 0] * 1e-30).astype(c.dtype)
            return c + eps, logits[0, 0]
        c, outs = lax.scan(body, X, None, length=n)
        return outs[-1] + c[0, 0, 0]

    float(run(X, 2))
    float(run(X, iters))
    t0 = time.perf_counter()
    float(run(X, iters))
    return (time.perf_counter() - t0) / iters


def bench_cnn_share(dtype, iters=20):
    """Time the scaled-geometry ROI-CNN embedding ALONE (96x192, B*T frames)
    — the CNN is ~11M MACs/frame vs the h=1024 3-layer GRU's ~48M, so its
    e2e share bounds what any CNN kernel can buy at this shape."""
    mcfg = model.BiGRUConfig(**SCALED)
    params = model.init_params(jax.random.PRNGKey(0), mcfg)
    rng = np.random.default_rng(0)
    R = jnp.asarray(rng.integers(0, 256, (B, T, mcfg.roi_h, mcfg.roi_w),
                                 dtype=np.uint8))

    @partial(jax.jit, static_argnames=("n",))
    def run(R, n):
        def body(c, _):
            e = model.roi_embedding(params["roi_cnn"], c, standardize=False,
                                    compute_dtype=dtype)
            eps = (e[0, 0, 0] * 0).astype(c.dtype)
            return c + eps, e[0, 0, 0]
        c, outs = lax.scan(body, R, None, length=n)
        return outs[-1] + c[0, 0, 0, 0].astype(jnp.float32)

    float(run(R, 2))
    float(run(R, iters))
    t0 = time.perf_counter()
    float(run(R, iters))
    return (time.perf_counter() - t0) / iters


def mesh_check():
    """DP+TP sharded step for the scaled model on 8 virtual CPU devices."""
    from jax.sharding import PartitionSpec as P

    from silent_speech.data.augment import OFFICIAL_AUGMENT
    from silent_speech.parallel import make_mesh, make_sharded_train_step
    from silent_speech.train.step import StepConfig

    cpus = jax.devices("cpu")
    assert len(cpus) >= 8, (
        "run with JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8")
    with jax.default_device(cpus[0]):
        mesh = make_mesh(cpus[:8], data=4, model=2)
        mcfg = model.BiGRUConfig(**SCALED)
        params = model.init_params(jax.random.PRNGKey(0), mcfg)
        scfg = StepConfig(model=mcfg, augment=OFFICIAL_AUGMENT)
        opt = make_optimizer(3e-4)
        params, opt_state, step = make_sharded_train_step(
            scfg, opt, mesh, params, tensor_parallel=True)

        # assert the TP layout is real: GRU gate matrices split on 'model'
        wi = params["gru"][0]["fwd"]["wi"]
        spec = wi.sharding.spec
        assert spec == P(None, "model"), f"unexpected TP spec: {spec}"

        rng = np.random.default_rng(0)
        Bs = 8
        X = rng.standard_normal((Bs, T, mcfg.x_dim)).astype(np.float32)
        L = rng.integers(8, T + 1, Bs).astype(np.int32)
        R = rng.integers(0, 256, (Bs, T, mcfg.roi_h, mcfg.roi_w), np.uint8)
        y = rng.integers(0, mcfg.num_classes, Bs).astype(np.int32)
        params, opt_state, m = step(params, opt_state, jax.random.PRNGKey(1),
                                    X, L, R, y)
        loss = float(m["loss"])
        assert np.isfinite(loss)
        print(f"scaled mesh check: 4x2 DP+TP step ok, params "
              f"{n_params(params)/1e6:.1f}M, loss={loss:.3f}, "
              f"wi spec={spec}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-only", action="store_true")
    args = ap.parse_args()
    if args.mesh_only or jax.default_backend() != "gpu":
        mesh_check()
        return
    out = {}
    for dtype, tag in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
        dt, nparams = bench_train_scaled(dtype)
        out[f"train_{tag}"] = {"step_ms": round(dt * 1e3, 2),
                               "clips_per_sec": round(B / dt, 1)}
        print(f"scaled train {tag} ({nparams/1e6:.1f}M params, B={B}): "
              f"{dt*1e3:.2f} ms/step, {B/dt:.0f} clips/s", flush=True)
    dt = bench_infer_scaled(jnp.bfloat16)
    out["infer_bf16"] = {"batch_ms": round(dt * 1e3, 2),
                         "clips_per_sec": round(B / dt, 1)}
    print(f"scaled infer bf16 (B={B}): {dt*1e3:.2f} ms, "
          f"{B/dt:.0f} clips/s", flush=True)
    for dtype, tag in ((jnp.bfloat16, "bf16"), (jnp.float32, "f32")):
        dtc = bench_cnn_share(dtype)
        out[f"cnn_only_{tag}"] = {"batch_ms": round(dtc * 1e3, 2)}
        print(f"  ROI-CNN alone ({tag}): {dtc*1e3:.2f} ms "
              f"({100*dtc/dt:.0f}% of bf16 e2e)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
