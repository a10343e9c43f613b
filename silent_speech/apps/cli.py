"""Command-line entry points mirroring the reference scripts 1:1.

    python -m silent_speech <command> [key=value ...]

Commands:
    record          webcam clip recorder (record_landmarks_official.py)
    record-timed    countdown batch recorder (inactive/record_training_data.py)
    train           official classifier training (train_model_official.py)
    train-ctc       CTC character-model training (inactive/train_model.py)
    train-reduced   5-word BiGRU w/ rich augmentation (inactive/train_reduced.py)
    train-unigru    trim/delta/z-score uni-GRU (inactive/train_model_1130pm.py)
    train-mlp       mean+std summary MLP with TEST split (inactive/train_5_quick.py)
    infer-live      manual-toggle live inference (live_infer_official.py)
    infer-gated     openness-gated auto-clip inference (inactive/live_lower_half.py)
    infer-stream    sliding-window streaming (inactive/live_feed.py)
    predict         offline single-clip prediction (the live predict block
                    on an already-recorded .npz; accepts a glob)
    eval-dataset    offline corpus sweep (inactive/dataset_eval.py)
    eval-ctc        dictionary-scored CTC corpus sweep
    landmarks-view  landmark index explorer (all_landmarks.py)
    important-landmarks  lower-face selection demo (important_landmarks.py)
    infer-ctc       CTC dictionary live inference (inactive/facial_landmark_detection.py)
    debug-npz       corpus keys/shapes debugger (inactive/debug.py)
    export-torch    convert our checkpoint to a reference-consumable .pt
    status          collection-progress dashboard (record_training_data --status)
    doctor          environment diagnosis (backend, native libs, capture deps)
    bench           single-chip throughput benchmark

Overrides use the config dataclass field names, e.g.
``train clip_dir=clips_npz epochs=40 lr=1e-3``.

Camera commands (record, record-timed, infer-live, infer-gated, infer-stream,
infer-ctc, landmarks-view, important-landmarks) accept ``sim=N``: run N frames
against the headless simulation harness (synthetic face track + scripted
record-toggle keystrokes) instead of a real camera — works on hosts with no
cv2/mediapipe/camera.

Env: ``JAX_PLATFORMS=cpu`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` emulates an N-device
mesh on the host (e.g. ``eval-dataset mesh_shape=data:8`` without 8 cards);
``JAX_COMPILATION_CACHE_DIR`` places the persistent compile cache (default:
``build/jax_cache`` in the checkout); ``SILENT_SPEECH_DEBUG=1`` prints full
tracebacks.
"""

from __future__ import annotations

import contextlib
import sys

from ..core.config import (
    CTCTrainConfig,
    EvalConfig,
    InferConfig,
    RecorderConfig,
    StreamConfig,
    TrainConfig,
    apply_overrides,
    parse_bool as _parse_bool,
)


def _split_kv(args):
    return [a for a in args if "=" in a], [a for a in args if "=" not in a]


def _split_stream_kv(kv):
    """Partition key=value overrides into (StreamConfig fields, the rest) —
    shared by infer-gated and infer-stream so both commands route the
    gating/pipeline knobs through the same rule."""
    import dataclasses as _dc

    stream_fields = {f.name for f in _dc.fields(StreamConfig)}
    scfg_kv = [a for a in kv if a.partition("=")[0] in stream_fields]
    rest = [a for a in kv if a.partition("=")[0] not in stream_fields]
    return scfg_kv, rest


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    try:
        from ..runtime.compile_cache import enable_compile_cache

        enable_compile_cache()
        return _dispatch(argv)
    except (AttributeError, ValueError, RuntimeError, FileNotFoundError, IOError) as e:
        import os
        import traceback

        if os.environ.get("SILENT_SPEECH_DEBUG"):
            traceback.print_exc()
        print(f"error: {e}", file=sys.stderr)
        print("(set SILENT_SPEECH_DEBUG=1 for the full traceback)",
              file=sys.stderr)
        return 1


def _sim_context(sim_n: int, cmd: str = ""):
    """Default simulation scenario: face in range, openness bursts, 'r'
    toggled around the middle of the run (space + scaled wall-clock state
    machine for record-timed, which is countdown-driven)."""
    import contextlib as _ctx

    from ..runtime.fakes import NO_KEY, face_track, sim_session

    keys = [NO_KEY] * sim_n
    if cmd == "record-timed":
        # record-timed starts on SPACE and runs a wall-clock
        # countdown/record state machine — scale its constants and pace the
        # fake camera so sim_n frames can actually traverse it
        if sim_n >= 16:
            keys[2] = ord(" ")

        @_ctx.contextmanager
        def _timed_session():
            from . import record_timed as rt

            saved = (rt.COUNTDOWN_S, rt.RECORD_S)
            # budget from sim_n so the state machine completes for ANY
            # sim_n >= 16: space at frame 2, ~5 countdown frames, the rest
            # recording with margin (frames tick every frame_delay seconds)
            fd = 0.004
            rt.COUNTDOWN_S = 5 * fd
            rt.RECORD_S = max(8, sim_n - 12) * fd * 0.8
            try:
                with sim_session(keys=keys, n_frames=sim_n,
                                 faces=face_track(sim_n)) as (cv2f, cam, lmk):
                    cam.frame_delay = fd
                    yield cv2f, cam, lmk
            finally:
                rt.COUNTDOWN_S, rt.RECORD_S = saved

        return _timed_session()
    if sim_n >= 16:
        keys[3] = ord("r")
        keys[sim_n - 8] = ord("r")
    # openness square wave: speaking bursts for the gated/stream modes
    open_seq = [20.0 if (i // 12) % 2 == 1 else 6.0 for i in range(sim_n)]
    return sim_session(keys=keys, n_frames=sim_n,
                       faces=face_track(sim_n, open_seq=open_seq))


def _dispatch(argv) -> int:
    cmd, args = argv[0], argv[1:]
    kv, flags = _split_kv(args)

    sim_n = 0
    for a in list(kv):
        if a.startswith("sim="):
            sim_n = int(a.split("=", 1)[1])
            kv.remove(a)
    with _sim_context(sim_n, cmd) if sim_n else contextlib.nullcontext():
        return _dispatch_cmd(cmd, kv, flags)


def _extras(kv, *allowed) -> dict:
    """Parse free-form key=value args, erroring on unknown keys (the same
    typo protection apply_overrides gives the dataclass commands)."""
    d = {}
    for a in kv:
        k, _, v = a.partition("=")
        if k not in allowed:
            raise ValueError(
                f"unknown option {k!r} (allowed: {', '.join(sorted(allowed))})"
            )
        d[k] = v
    return d


def _pop_kwargs(kv, *names) -> dict:
    """Extract named key=value args that are train()-function kwargs rather
    than config fields (resume_from/metrics_path/profile_dir) — without this
    the resume path would be unreachable from the user surface."""
    out = {}
    for a in list(kv):
        k, _, v = a.partition("=")
        if k in names:
            kv.remove(a)
            out[k] = v
    return out


def _pop_model_path(kv) -> dict:
    """Extract model_path= for the camera commands (every app main takes it
    as a function parameter, not a config field — the doctor's remedy)."""
    for a in list(kv):
        if a.startswith("model_path="):
            kv.remove(a)
            return {"model_path": a.split("=", 1)[1]}
    return {}


# commands whose app mains take the mediapipe model_path= parameter; any
# other command leaves model_path in kv so apply_overrides/_extras reject it
# as an unknown option instead of silently swallowing it
_CAMERA_CMDS = frozenset({
    "record", "record-timed", "infer-live", "infer-gated", "infer-stream",
    "landmarks-view", "important-landmarks", "infer-ctc",
})


def _dispatch_cmd(cmd, kv, flags) -> int:
    mp = _pop_model_path(kv) if cmd in _CAMERA_CMDS else {}
    if cmd in ("doctor", "bench") and kv:
        raise ValueError(f"{cmd} takes no options (got {', '.join(kv)})")
    if cmd == "record":
        from .record import main as run
        run(apply_overrides(RecorderConfig(), kv), **mp)
    elif cmd == "record-timed":
        from .record_timed import main as run
        run(apply_overrides(RecorderConfig(), kv),
            status_only="--status" in flags, **mp)
    elif cmd == "status":
        from .record_timed import print_progress_summary
        cfg = apply_overrides(RecorderConfig(), kv)
        print_progress_summary(cfg.videos_dir, npz_fallback_dir=cfg.out_dir)
    elif cmd == "train":
        from ..train import train
        kw = _pop_kwargs(kv, "resume_from", "metrics_path", "profile_dir")
        train(apply_overrides(TrainConfig(), kv), **kw)
    elif cmd == "train-ctc":
        from ..train import train_ctc
        train_ctc(apply_overrides(CTCTrainConfig(), kv))
    elif cmd == "train-reduced":
        from ..train.legacy_loops import ReducedConfig, train_reduced
        train_reduced(apply_overrides(ReducedConfig(), kv))
    elif cmd == "train-unigru":
        from ..train.legacy_loops import UniGRUConfig, train_unigru
        train_unigru(apply_overrides(UniGRUConfig(), kv))
    elif cmd == "train-mlp":
        from ..train.legacy_loops import MLPQuickConfig, train_mlp_quick
        train_mlp_quick(apply_overrides(MLPQuickConfig(), kv))
    elif cmd == "infer-live":
        from .live import infer_live
        infer_live(apply_overrides(InferConfig(), kv), **mp)
    elif cmd == "infer-gated":
        from .live import infer_gated
        # gating thresholds + pipeline knobs are StreamConfig fields
        # (live_lower_half.py:143-151 constants); the rest is InferConfig
        scfg_kv, icfg_kv = _split_stream_kv(kv)
        infer_gated(apply_overrides(InferConfig(), icfg_kv),
                    apply_overrides(StreamConfig(), scfg_kv), **mp)
    elif cmd == "infer-stream":
        from .live import infer_stream
        scfg_kv, other = _split_stream_kv(kv)
        extras = _extras(other, "ckpt_path", "cam_index")
        if "ckpt_path" not in extras:
            print("usage: infer-stream ckpt_path=<path> [cam_index=N] "
                  "[<StreamConfig field>=...]")
            return 2
        infer_stream(extras["ckpt_path"],
                     apply_overrides(StreamConfig(), scfg_kv),
                     cam_index=int(extras.get("cam_index", 0)), **mp)
    elif cmd == "eval-dataset":
        from ..core.config import serving_kwargs
        from ..infer import VariantPredictor, evaluate_dataset, load_predictor
        from ..infer.evaluator import evaluate_variant_dataset
        cfg = apply_overrides(EvalConfig(), kv)
        pred = load_predictor(cfg.ckpt_path, **serving_kwargs(cfg))
        if isinstance(pred, VariantPredictor):
            # batch_size / mesh_shape do not apply: variant families predict
            # per clip
            evaluate_variant_dataset(pred, cfg.clip_dir,
                                     top_confusions=cfg.top_confusions)
        else:
            if cfg.mesh_shape:
                from ..parallel.mesh import mesh_from_shape
                pred.shard(mesh_from_shape(cfg.mesh_shape))
            evaluate_dataset(pred, cfg.clip_dir, batch_size=cfg.batch_size,
                             top_confusions=cfg.top_confusions)
    elif cmd == "predict":
        # offline single-clip prediction: the live predict block
        # (live_infer_official.py:338-359) applied to an already-recorded
        # .npz — reference users replay clips through the camera apps or a
        # whole-corpus sweep; this is the direct path. Routes through
        # load_predictor, so every checkpoint family (.ckpt and reference
        # .pt generations) works.
        import glob as _glob

        import numpy as np

        from ..core.config import serving_kwargs
        from ..core.schema import load_clip
        from ..infer import VariantPredictor, load_predictor
        extras = _extras(kv, "ckpt_path", "clip", "k", "compute_dtype",
                         "matmul_precision")
        if "ckpt_path" not in extras or "clip" not in extras:
            print("usage: predict ckpt_path=<path> clip=<clip.npz|glob> "
                  "[k=3] [serving knobs]")
            return 2
        k = int(extras.get("k", 3))
        paths = sorted(_glob.glob(extras["clip"])) or [extras["clip"]]
        ckpt_path = extras["ckpt_path"]
        is_ctc = False
        if not ckpt_path.endswith(".pt"):
            from ..train.checkpoint import load_checkpoint
            is_ctc = bool(load_checkpoint(ckpt_path)[1].get("vocab"))
        if is_ctc:
            # dictionary-scored CTC route (the offline counterpart of
            # infer-ctc's predict block)
            from ..infer.ctc_decode import CTCDecoder, Dictionary
            from ..train.checkpoint import load_checkpoint

            import jax as _jax
            import jax.numpy as _jnp

            params, meta, _ = load_checkpoint(ckpt_path)
            params = _jax.tree.map(_jnp.asarray, params)
            dec = CTCDecoder(
                params, Dictionary.from_words(list(meta["uniq_labels"])),
                max_t=int(meta["max_t"]),
                len_lambda=float(meta.get("len_lambda", 0.02)),
                len_per_char=int(meta.get("exp_len", 5)),
            )
            for p in paths:
                c = load_clip(p).aligned()
                if c.roi is None:
                    print(f"{p}: no roi in clip — CTC scoring needs it")
                    continue
                print(f"{p}: {dec.score_clip(c.X, c.roi)[:k]}")
        else:
            icfg = apply_overrides(
                InferConfig(), [f"{kk}={v}" for kk, v in extras.items()
                                if kk in ("compute_dtype",
                                          "matmul_precision")])
            pred = load_predictor(ckpt_path, **serving_kwargs(icfg))
            for p in paths:
                c = load_clip(p)
                if isinstance(pred, VariantPredictor):
                    top = pred.predict_features(c.X.astype(np.float32), k=k)
                else:
                    top = pred.predict_clip(c, k=k)
                print(f"{p}: {top}")
    elif cmd == "eval-ctc":
        from ..core.config import _parse_dict_override
        from ..infer.evaluator import evaluate_ctc_dataset
        extras = _extras(kv, "ckpt_path", "clip_dir", "chunk_words",
                         "batch_size", "mesh_shape", "compute_dtype",
                         "matmul_precision")
        if "ckpt_path" not in extras:
            print("usage: eval-ctc ckpt_path=<path> [clip_dir=clips_npz] "
                  "[chunk_words=N] [batch_size=64] [mesh_shape=data:N] "
                  "[serving knobs: compute_dtype= matmul_precision=]")
            return 2
        evaluate_ctc_dataset(
            extras["ckpt_path"],
            extras.get("clip_dir", "clips_npz"),
            chunk_words=int(extras.get("chunk_words", 0)),
            batch_size=int(extras.get("batch_size", 64)),
            mesh_shape=(_parse_dict_override(extras["mesh_shape"])
                        if "mesh_shape" in extras else None),
            compute_dtype=extras.get("compute_dtype", "float32"),
            matmul_precision=extras.get("matmul_precision", ""),
        )
    elif cmd == "landmarks-view":
        from .landmarks_view import main as run
        extras = _extras(kv, "cam_index", "label_every")
        run(cam_index=int(extras.get("cam_index", 0)),
            label_every=int(extras.get("label_every", 1)), **mp)
    elif cmd == "important-landmarks":
        from .important_landmarks import main as run
        extras = _extras(kv, "cam_index", "open_low", "open_high", "ema_alpha")
        # reference defaults: 0.02 both ways, EMA 0.25
        # (important_landmarks.py:57-61)
        run(cam_index=int(extras.get("cam_index", 0)),
            open_low=float(extras.get("open_low", 0.02)),
            open_high=float(extras.get("open_high", 0.02)),
            ema_alpha=float(extras.get("ema_alpha", 0.25)), **mp)
    elif cmd == "infer-ctc":
        from .live import infer_ctc
        extras = _extras(kv, "ckpt_path", "cam_index", "chunk_words",
                         "predict_async", "compute_dtype",
                         "matmul_precision")
        if "ckpt_path" not in extras:
            print("usage: infer-ctc ckpt_path=<path> [cam_index=N] "
                  "[chunk_words=N] [predict_async=true] [serving knobs: "
                  "compute_dtype= matmul_precision=]")
            return 2
        infer_ctc(extras["ckpt_path"],
                  cam_index=int(extras.get("cam_index", 0)),
                  chunk_words=int(extras.get("chunk_words", 0)),
                  predict_async=_parse_bool(
                      "predict_async", extras.get("predict_async", "false")),
                  compute_dtype=extras.get("compute_dtype", "float32"),
                  matmul_precision=extras.get("matmul_precision", ""),
                  **mp)
    elif cmd == "export-torch":
        extras = _extras(kv, "ckpt_path", "out_path")
        if "ckpt_path" not in extras or "out_path" not in extras:
            print("usage: export-torch ckpt_path=<ours.ckpt> out_path=<ref.pt>")
            return 2
        from ..core.torch_export import export_reference_checkpoint
        from ..train.checkpoint import load_checkpoint
        params, meta, _ = load_checkpoint(extras["ckpt_path"])
        export_reference_checkpoint(params, meta, extras["out_path"])
        print("wrote", extras["out_path"])
    elif cmd == "debug-npz":
        from .debug_npz import main as run
        extras = _extras(kv, "clip_dir")
        return run(extras.get("clip_dir", "clips_npz"))
    elif cmd == "doctor":
        from .doctor import run_doctor
        return run_doctor()
    elif cmd == "bench":
        import runpy
        import os
        bench_path = os.path.join(
            os.path.dirname(__file__), "..", "..", "bench.py")
        if not os.path.exists(bench_path):
            raise FileNotFoundError(
                "bench.py lives at the repository root (source checkout "
                "only) — run `python bench.py` from the repo instead"
            )
        runpy.run_path(bench_path, run_name="__main__")
    else:
        print(f"unknown command: {cmd}\n{__doc__}")
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
