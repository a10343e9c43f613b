"""Run the lip-reader's train and serve paths on one GPU, end to end.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases, in one process, on the official model at full width (BiGRUConfig
defaults: 180-D features + 48x96 u8 ROI, TinyROICNN -> 32, 2-layer BiGRU
h=192, 10 classes), with random weights and data made from --seed:

1. identity  the default backend must be a GPU; prints the device and the
             card's name and power limit (nvidia-smi, a child off JAX)
2. train     the `train` command at the reference protocol (B=16,
             steps_per_dispatch=0) for 2 epochs on a synthetic corpus of the
             10 reference words, clips up to max_t=90; then steps at B=256.
             Loss finite and falling, a checkpoint written
3. serve     Predictor.from_checkpoint at its defaults: B=1 (T=32, T=90) and
             B=256 (T=32); `eval-dataset`, `infer-live sim=64` and
             `infer-stream sim=64` through the CLI; `train-ctc` steps and a
             W=10 dictionary sweep through `eval-ctc`
4. timing    the served forward (p50 at B=1/T=32, clips/s at B=256/T=32)
             and the ROI CNN alone (8192 and 32 frames), each at the two
             precision modes, timed in turns
5. fidelity  served logits against the plain reference (the same forward
             on the host CPU at 'highest'): max |dlogit| <= 1e-3 and equal
             argmax at B=256/T=32, random and trained weights, for each
             matmul_precision mode; the serving default must hold the bar
6. memory    compiled.memory_analysis() of the B=256 serve step and the
             B=16 train step

Any failure ends the run with a non-zero code; nothing is caught and
continued. The last line, printed only on success, is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
LOGIT_TOL = 1e-3
PRECISION_MODES = (None, "highest")  # cheapest first
TIMING_CALLS = 20

# sizes (the rehearsal on the host shrinks them)
CLIPS_PER_WORD = 24
MAX_T = 90
SERVE_B = 256
SERVE_T = 32
TRAIN_B = 16
BIG_TRAIN_B = 256
BIG_TRAIN_STEPS = 4
ROI_FRAMES = (SERVE_B * SERVE_T, 32)


# ---------------------------------------------------------------------------
# pure helpers (tested on the CPU: tests/test_chip_smoke.py)
# ---------------------------------------------------------------------------

def compare_logits(got, ref, tol: float = LOGIT_TOL) -> dict:
    """max |got - ref| and argmax agreement of two (B, C) logit arrays."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} != reference {ref.shape}")
    finite = bool(np.isfinite(got).all())
    max_abs = float(np.abs(got - ref).max()) if finite else float("inf")
    argmax_equal = bool((got.argmax(-1) == ref.argmax(-1)).all())
    return {"max_abs": max_abs, "argmax_equal": argmax_equal,
            "finite": finite,
            "ok": finite and argmax_equal and max_abs <= tol}


def loss_falls(losses) -> bool:
    """Every loss finite and the last below the first."""
    losses = [float(x) for x in losses]
    return (len(losses) >= 2 and all(np.isfinite(losses))
            and losses[-1] < losses[0])


def alternate_medians(run_a, run_b, calls: int = TIMING_CALLS):
    """Median seconds of ``run_a`` and ``run_b`` timed in turns A, B, B, A,
    ``calls`` timed calls per turn. Each run blocks until its result is
    ready; the caller warms both up first."""
    samples = {"a": [], "b": []}
    for side in ("a", "b", "b", "a"):
        run = run_a if side == "a" else run_b
        for _ in range(calls):
            t0 = time.perf_counter()
            run()
            samples[side].append(time.perf_counter() - t0)
    return float(np.median(samples["a"])), float(np.median(samples["b"]))


def last_line(device: dict) -> str:
    """The success line: the device exactly as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def fmt_memory(ma) -> str:
    """One line from a CompiledMemoryStats."""
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes",
            "generated_code_size_in_bytes")
    return " ".join(f"{k.replace('_size_in_bytes', '')}="
                    f"{getattr(ma, k, 0) / 2**20:.2f}MiB" for k in keys)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

class CompileStats:
    """Backend compile seconds and persistent-cache hits in this process."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.programs = 0
        self.cache_hits = 0

        def on_duration(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.seconds += duration
                self.programs += 1

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)


def serving_precision():
    """The Predictor's default matmul_precision."""
    from silent_speech.infer import Predictor

    return Predictor.__dataclass_fields__["matmul_precision"].default


def _cache_entries(path) -> int:
    return len(os.listdir(path)) if path and os.path.isdir(path) else 0


def _batch(rng, B, T, *, ragged: bool = True):
    X = rng.standard_normal((B, T, 180)).astype(np.float32)
    L = (rng.integers(5, T + 1, B) if ragged
         else np.full((B,), T)).astype(np.int32)
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    return X, L, R


def phase_train(seed: int) -> dict:
    import jax
    import jax.numpy as jnp

    from silent_speech.apps import cli
    from silent_speech.core.landmarks import WORDS
    from silent_speech.data.augment import OFFICIAL_AUGMENT
    from silent_speech.data.synthetic import generate_corpus
    from silent_speech.models import bigru as model
    from silent_speech.train.step import (StepConfig, make_batch_train_step,
                                          make_optimizer)

    clip_dir = os.path.join(WORK, "clips")
    ckpt = os.path.join(WORK, "word_model.ckpt")
    metrics = os.path.join(WORK, "train_metrics.jsonl")
    shutil.rmtree(WORK, ignore_errors=True)
    generate_corpus(clip_dir, clips_per_word=CLIPS_PER_WORD, words=WORDS,
                    seed=seed, t_range=(6, MAX_T + 1))
    print(f"train: corpus {len(WORDS)} words x {CLIPS_PER_WORD} clips, "
          f"T in [6, {MAX_T}]")
    t0 = time.perf_counter()
    rc = cli.main(["train", f"clip_dir={clip_dir}", f"out_path={ckpt}",
                   f"metrics_path={metrics}", "epochs=2", "patience=2",
                   f"batch_size={TRAIN_B}", "steps_per_dispatch=0",
                   f"max_t={MAX_T}", "lr=1e-3", f"seed={seed}"])
    check(rc == 0, f"train command exited {rc}")
    with open(metrics) as f:
        losses = [json.loads(line)["train_loss"] for line in f]
    print(f"train B={TRAIN_B}: epoch losses {losses} "
          f"[{time.perf_counter() - t0:.1f}s incl. compile]")
    check(loss_falls(losses), f"B={TRAIN_B} train loss not finite+falling")
    check(os.path.exists(ckpt), "train wrote no checkpoint")

    mcfg = model.BiGRUConfig()
    scfg = StepConfig(model=mcfg, augment=OFFICIAL_AUGMENT)
    opt = make_optimizer(1e-3)
    step = make_batch_train_step(scfg, opt)
    rng = np.random.default_rng(seed)
    X, L, R = _batch(rng, BIG_TRAIN_B, MAX_T)
    y = rng.integers(0, mcfg.num_classes, BIG_TRAIN_B).astype(np.int32)
    params = model.init_params(jax.random.PRNGKey(seed), mcfg)
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(seed + 1)
    batch = tuple(jnp.asarray(a) for a in (X, L, R, y))
    big_losses, times = [], []
    for _ in range(BIG_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, key, m = step(params, opt_state, key, *batch)
        big_losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    print(f"train B={BIG_TRAIN_B} T={MAX_T}: step losses "
          f"{[round(v, 4) for v in big_losses]}, step ms after the first "
          f"{[round(t * 1e3, 2) for t in times[1:]]}")
    check(loss_falls(big_losses), f"B={BIG_TRAIN_B} loss not finite+falling")

    Xs, Ls, Rs = _batch(rng, TRAIN_B, MAX_T)
    ys = rng.integers(0, mcfg.num_classes, TRAIN_B).astype(np.int32)
    ma = step.lower(params, opt_state, key, Xs, Ls, Rs,
                     ys).compile().memory_analysis()
    print(f"memory train step B={TRAIN_B} T={MAX_T}: {fmt_memory(ma)}")
    return {"ckpt": ckpt, "clip_dir": clip_dir}


def phase_serve(paths: dict, seed: int) -> None:
    import jax

    from silent_speech.apps import cli
    from silent_speech.infer import Predictor
    from silent_speech.models.variants import init_gru_word_classifier
    from silent_speech.train import train_ctc
    from silent_speech.core.config import CTCTrainConfig
    from silent_speech.train.checkpoint import save_checkpoint

    pred = Predictor.from_checkpoint(paths["ckpt"])
    rng = np.random.default_rng(seed + 2)
    for B, T in ((1, 32), (1, 90), (SERVE_B, 32)):
        X, L, R = _batch(rng, B, T)
        logits = pred.predict_batch(X, L, R)
        check(logits.shape == (B, 10) and np.isfinite(logits).all(),
              f"serve B={B} T={T}: bad logits")
        print(f"serve B={B} T={T}: logits ok")
    ma = pred._fwd.lower(pred.params, X, L, R).compile().memory_analysis()
    print(f"memory serve step B={SERVE_B} T=32: {fmt_memory(ma)}")

    for argv in (
        ["eval-dataset", f"ckpt_path={paths['ckpt']}",
         f"clip_dir={paths['clip_dir']}"],
        ["infer-live", f"ckpt_path={paths['ckpt']}", "sim=64"],
    ):
        check(cli.main(argv) == 0, f"{argv[0]} failed")

    stream_ckpt = os.path.join(WORK, "stream_83d.ckpt")
    save_checkpoint(stream_ckpt, jax.tree.map(np.asarray, (
        init_gru_word_classifier(jax.random.PRNGKey(seed), 83, 10))),
        dict(input_dim=83, max_t=40,
             id_to_label={i: str(i) for i in range(10)}))
    check(cli.main(["infer-stream", f"ckpt_path={stream_ckpt}", "sim=64"])
          == 0, "infer-stream failed")

    ccfg = CTCTrainConfig(clip_dir=paths["clip_dir"],
                          out_path=os.path.join(WORK, "ctc.ckpt"),
                          epochs=1, max_t=MAX_T, seed=seed)
    res = train_ctc(ccfg)
    check(all(np.isfinite(h["loss"]) for h in res["history"]),
          "train-ctc loss not finite")
    ctc_ckpt = os.path.join(WORK, "ctc_scored.ckpt")
    save_checkpoint(ctc_ckpt, res["params"], res["meta"])
    check(cli.main(["eval-ctc", f"ckpt_path={ctc_ckpt}",
                    f"clip_dir={paths['clip_dir']}"]) == 0,
          "eval-ctc failed")


def phase_fidelity(paths: dict, seed: int, card: str) -> None:
    import jax

    from silent_speech.infer import Predictor
    from silent_speech.models import bigru as model
    from silent_speech.train.checkpoint import load_checkpoint

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(seed + 3)
    X, L, R = _batch(rng, SERVE_B, SERVE_T)
    mcfg = model.BiGRUConfig()
    trained = load_checkpoint(paths["ckpt"])[0]
    default_mode = serving_precision()
    held = {}
    for name, params in (
        ("random", model.init_params(jax.random.PRNGKey(seed), mcfg)),
        ("trained", trained),
    ):
        params = jax.tree.map(np.asarray, params)
        with jax.default_device(cpu), jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(
                lambda p, x, l, r: model.live_forward(p, mcfg, x, l, r)
            )(jax.device_put(params, cpu), X, L, R))
        for mode in PRECISION_MODES:
            pred = Predictor(params=jax.tree.map(jax.numpy.asarray, params),
                             cfg=mcfg, id_to_label={i: str(i)
                                                    for i in range(10)},
                             matmul_precision=mode)
            res = compare_logits(pred.predict_batch(X, L, R), ref)
            print(f"fidelity {name} precision={mode}: max|dlogit| "
                  f"{res['max_abs']:.3e} argmax_equal {res['argmax_equal']} "
                  f"holds_1e-3 {res['ok']} [{card}]")
            held[(name, mode)] = res["ok"]
    for name in ("random", "trained"):
        check(held[(name, default_mode)],
              f"serving default precision={default_mode} misses the "
              f"1e-3/argmax bar on {name} weights")


def phase_timing(seed: int, card: str) -> None:
    """The serving forward and the ROI CNN alone at each precision mode,
    timed in turns (A, B, B, A), TIMING_CALLS calls per turn."""
    import jax
    import jax.numpy as jnp

    from silent_speech.models import bigru as model

    rng = np.random.default_rng(seed + 4)
    mcfg = model.BiGRUConfig()
    params = model.init_params(jax.random.PRNGKey(seed), mcfg)
    fast, exact = PRECISION_MODES

    def timed(make, args):
        fns = [jax.jit(make(mode)) for mode in (fast, exact)]
        for f in fns:
            f(*args).block_until_ready()
        return alternate_medians(
            lambda: fns[0](*args).block_until_ready(),
            lambda: fns[1](*args).block_until_ready())

    for B in (1, SERVE_B):
        X, L, R = (jnp.asarray(a) for a in _batch(rng, B, SERVE_T,
                                                   ragged=False))
        t_f, t_e = timed(lambda mode: lambda p, x, l, r: model.live_forward(
            p, mcfg, x, l, r, matmul_precision=mode), (params, X, L, R))
        print(f"live_forward B={B} T={SERVE_T}: precision={fast} "
              f"{t_f * 1e3:.4f} ms ({B / t_f:.1f} clips/s) | precision="
              f"{exact} {t_e * 1e3:.4f} ms ({B / t_e:.1f} clips/s) [{card}]")

    for n in ROI_FRAMES:
        roi = jnp.asarray(rng.integers(0, 256, (n, 1, 48, 96), dtype=np.uint8))

        def make(mode):
            def f(p, r):
                with jax.default_matmul_precision(mode or "default"):
                    return model.roi_embedding(p, r, standardize=False)
            return f

        t_f, t_e = timed(make, (params["roi_cnn"], roi))
        print(f"roi_embedding {n} frames: precision={fast} {t_f * 1e3:.4f} "
              f"ms | precision={exact} {t_e * 1e3:.4f} ms [{card}]")


# Four-card bounds at 'highest'. The sharded and one-card steps sum the same
# terms in another order. One step with plain SGD at learning rate 1 moves
# each parameter by minus its gradient, so it compares the gradients
# themselves, relative to each leaf's largest entry: 9.7e-6 on four virtual
# CPU devices. After 3 Adam steps the parameters drifted 4.8e-6 ({data:4})
# and 3.2e-5 ({data:2, model:2}) on four H100s. Each bound is about ten
# times the larger reading; a gradient missing one shard's share is off by
# a quarter or more.
GRAD_RTOL = 1e-4
PARAM_TOL = 3e-4


def grad_drift(before, after_a, after_b) -> float:
    """Largest difference of two SGD(lr=1) updates from ``before``, each
    leaf relative to its largest update entry in ``after_a``."""
    worst = 0.0
    for p0, pa, pb in zip(*(_leaves(t) for t in (before, after_a,
                                                  after_b))):
        ga, gb = p0 - pa, p0 - pb
        scale = float(np.abs(ga).max())
        if scale > 0:
            worst = max(worst, float(np.abs(ga - gb).max()) / scale)
    return worst


def _leaves(tree):
    import jax

    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def phase_four_cards(seed: int, card: str) -> None:
    """Sharded train steps and sharded serving against one card."""
    import jax
    import jax.numpy as jnp
    import optax

    from silent_speech.data.augment import OFFICIAL_AUGMENT
    from silent_speech.infer import Predictor
    from silent_speech.models import bigru as model
    from silent_speech.parallel.mesh import mesh_from_shape
    from silent_speech.parallel.train_sharded import make_sharded_train_step
    from silent_speech.train.step import (StepConfig, make_batch_train_step,
                                          make_optimizer)

    lr, steps = 3e-4, 3
    mcfg = model.BiGRUConfig()
    scfg = StepConfig(model=mcfg, augment=OFFICIAL_AUGMENT)
    rng = np.random.default_rng(seed + 5)
    B = 32
    X, L, R = _batch(rng, B, SERVE_T)
    y = rng.integers(0, 10, B).astype(np.int32)
    init = jax.tree.map(np.asarray,
                        model.init_params(jax.random.PRNGKey(seed), mcfg))
    dev0 = jax.devices()[0]

    def one_card(opt, n):
        step = make_batch_train_step(scfg, opt)
        p = jax.device_put(init, dev0)
        s = opt.init(p)
        key, losses = jax.random.PRNGKey(seed + 6), []
        for _ in range(n):
            p, s, key, m = step(p, s, key, *(jnp.asarray(a)
                                             for a in (X, L, R, y)))
            losses.append(float(m["loss"]))
        return p, losses

    def on_mesh(opt, n, shape):
        mesh = mesh_from_shape(shape)
        p, s, step = make_sharded_train_step(
            scfg, opt, mesh, init, tensor_parallel=shape.get("model", 1) > 1)
        key, losses = jax.random.PRNGKey(seed + 6), []
        for _ in range(n):
            p, s, m = step(p, s, key, X, L, R, y)
            # the one-card step hands back the first of its 3-way split
            key = jax.random.split(key, 3)[0]
            losses.append(float(m["loss"]))
        return p, losses

    with jax.default_matmul_precision("highest"):
        sgd = optax.sgd(1.0)
        g1, _ = one_card(sgd, 1)
        adam = make_optimizer(lr)
        p1, ref_losses = one_card(adam, steps)
        for shape in ({"data": 4}, {"data": 2, "model": 2}):
            g4, _ = on_mesh(sgd, 1, shape)
            gd = grad_drift(init, g1, g4)
            p4, losses = on_mesh(adam, steps, shape)
            dmax = max(float(np.abs(a - b).max())
                       for a, b in zip(_leaves(p4), _leaves(p1)))
            print(f"sharded train mesh={shape}: first-step gradient "
                  f"max|dgrad|/max|grad| {gd:.3e} (tol {GRAD_RTOL:g}); "
                  f"losses {losses} vs one card {ref_losses}; max|dparam| "
                  f"after {steps} Adam steps {dmax:.3e} (tol {PARAM_TOL:g})"
                  f" [{card}]")
            check(gd <= GRAD_RTOL, f"mesh {shape} gradients drift {gd}")
            check(dmax <= PARAM_TOL, f"mesh {shape} params drift {dmax}")
            check(np.allclose(losses, ref_losses, rtol=1e-4, atol=1e-5),
                  f"mesh {shape} losses differ")

    params = jax.tree.map(jnp.asarray, init)
    kw = dict(cfg=mcfg, id_to_label={i: str(i) for i in range(10)})
    Xr, Lr, Rr = _batch(rng, 10, SERVE_T)  # 10 is ragged on data=4
    ref = Predictor(params=params, **kw).predict_batch(Xr, Lr, Rr)
    sharded = Predictor(params=params, **kw).shard(
        mesh_from_shape({"data": 4}))
    got = sharded.predict_batch(Xr, Lr, Rr)
    res = compare_logits(got, ref, tol=1e-5)
    print(f"Predictor.shard data=4 B=10: max|dlogit| {res['max_abs']:.3e} "
          f"argmax_equal {res['argmax_equal']} (tol 1e-5) [{card}]")
    check(res["ok"], "sharded serving disagrees with one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from silent_speech.runtime.compile_cache import (default_cache_dir,
                                                     enable_compile_cache)
    from silent_speech.runtime.device import card_info, require_gpu

    device = require_gpu()
    card = card_info()
    print(f"device: platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}")
    print("card (nvidia-smi --query-gpu=name,power.limit):")
    print(card)
    cache = enable_compile_cache() or os.environ.get("JAX_COMPILATION_CACHE_DIR")
    entries0 = _cache_entries(cache)
    stats = CompileStats()
    t0 = time.perf_counter()

    if args.four_cards:
        check(device["count"] >= 4, f"--four-cards needs 4 GPUs, found "
                                    f"{device['count']}")
        phase_four_cards(args.seed, card)
    else:
        paths = phase_train(args.seed)
        phase_serve(paths, args.seed)
        phase_timing(args.seed, card)
        phase_fidelity(paths, args.seed, card)

    print(f"compile: {stats.programs} programs, {stats.seconds:.1f} s "
          f"backend compile, {stats.cache_hits} persistent-cache hits; cache "
          f"{cache} ({'default' if cache == default_cache_dir() else 'env'})"
          f" entries {entries0} -> {_cache_entries(cache)}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    print(last_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
