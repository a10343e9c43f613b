"""Configuration dataclasses.

One dataclass per pipeline, with field names and defaults taken from the
reference scripts' CONSTANTS blocks so existing workflows map 1:1
(reference: record_landmarks_official.py:5-25, train_model_official.py:20-47,
inactive/train_model.py:10-29, inactive/live_lower_half.py:143-151).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class RecorderConfig:
    """Official recorder settings (record_landmarks_official.py:5-25)."""

    out_dir: str = "clips_npz"
    # labeled .mp4s from the timed recorder land here, separate from the
    # npz clips (record_training_data.py:13-19); progress is counted by
    # these videos, the reference's rule
    videos_dir: str = "videos_labeled"
    speaker: str = "me"
    cam_index: int = 1
    roi_w: int = 96
    roi_h: int = 48
    save_roi: bool = True
    draw_points: bool = True
    mouth_w_min_px: float = 60.0
    mouth_w_max_px: float = 150.0
    min_frames: int = 5
    # EMA stabilization of the ROI center/scale, 0 = off
    # (inactive/record_landmarks_v2.py:70-73,231-242)
    roi_ema_alpha: float = 0.0
    # landmark selection: "fixed" = the official 88-point set; "dynamic" =
    # per-clip lower-face selection locked on the first in-range frame
    # (inactive/lower_face_record.py:66-85, span-norm features)
    idxs_mode: str = "fixed"


@dataclasses.dataclass
class TrainConfig:
    """Official trainer settings (train_model_official.py:20-47)."""

    clip_dir: str = "clips_npz"
    out_path: str = "word_model_points_roi.ckpt"
    seed: int = 42
    val_frac: float = 0.15
    batch_size: int = 16
    epochs: int = 80
    lr: float = 3e-4
    patience: int = 12
    max_t: int = 90
    use_roi_if_present: bool = True
    roi_w: int = 96
    roi_h: int = 48
    # augmentation (train_model_official.py:41-43,144-152)
    noise_std: float = 0.01
    noise_prob: float = 0.7
    drop_frames_prob: float = 0.35
    drop_frames_max: int = 2
    # loss / optimization (train_model_official.py:405,438)
    label_smoothing: float = 0.05
    grad_clip_norm: float = 1.0
    # model (train_model_official.py:402)
    hidden: int = 192
    gru_layers: int = 2
    roi_emb: int = 32
    gru_dropout: float = 0.1
    head_dropout: float = 0.2
    # accelerator knobs (no reference counterpart)
    compute_dtype: str = "float32"  # "bfloat16" for throughput
    # recompute ROI-CNN activations in the backward instead of storing them
    # (identical gradients, less activation memory traffic)
    roi_remat: bool = False
    # train steps per device dispatch on the device-resident-dataset path:
    # 0 (the default) = the whole epoch as one lax.scan dispatch; K>=2 =
    # chunks of K steps; 1 = one jitted step per batch (per-step metric
    # fetch — the reference's dispatch granularity). Same rng/update
    # sequence in every mode (pinned by tests); ignored when mesh_shape or
    # host_data is set (scripts/bench_multistep.py times the modes).
    steps_per_dispatch: int = 0
    mesh_shape: Optional[dict] = None  # e.g. {"data": 4, "model": 2}
    # keep the corpus in host RAM and ship batches per step instead of
    # holding the whole padded dataset on the device (for corpora larger
    # than device memory)
    host_data: bool = False
    # "npz" (single file) or "orbax" (checkpoint directory, async-capable)
    checkpoint_format: str = "npz"
    async_checkpoint: bool = False  # orbax only: commit saves in background


@dataclasses.dataclass
class InferConfig:
    """Live/offline inference settings (live_infer_official.py:17-43)."""

    ckpt_path: str = "word_model_points_roi.ckpt"
    cam_index: int = 1
    roi_w: int = 96
    roi_h: int = 48
    mouth_w_min_px: float = 60.0
    mouth_w_max_px: float = 150.0
    draw_points: bool = True
    min_frames: int = 5
    topk: int = 3
    # accelerator serving knobs (no reference counterpart)
    compute_dtype: str = "float32"  # "bfloat16" = fast serving mode
    # "" = the Predictor default (models/bigru.SERVING_PRECISION);
    # "default" = backend default matmuls (TF32 for float32 on an H100);
    # "highest" = true float32
    matmul_precision: str = ""
    # pre-compile every (bucket, B=1) shape at startup so the first clip
    # predicts at steady-state latency instead of paying the first-compile
    # cost mid-session (Predictor.warmup)
    warmup: bool = False
    # run the clip predict on a worker thread so the camera/UI loop never
    # freezes on device dispatch (the reference blocks the feed for the
    # whole predict — live_infer_official.py:338-359; a first compile can
    # take seconds). False = the reference's blocking semantics.
    predict_async: bool = False


@dataclasses.dataclass
class CTCTrainConfig:
    """CTC trainer settings (inactive/train_model.py:10-29)."""

    clip_dir: str = "clips_npz"
    out_path: str = "ctc_word_model_roi.ckpt"
    seed: int = 42
    val_frac: float = 0.15
    batch_size: int = 32
    epochs: int = 120
    lr: float = 1e-3
    patience: int = 6
    max_t: int = 80
    roi_w: int = 96
    roi_h: int = 48
    roi_emb: int = 32
    hidden: int = 192
    gru_layers: int = 3
    len_lambda: float = 0.02  # length-prior penalty (inactive/train_model.py:29)
    len_per_char: int = 5  # expected frames per character (inactive/train_model.py:247)
    # silence trimming (inactive/train_model.py:48-57)
    trim_open_idx: int = -3
    trim_thresh: float = 0.05
    trim_pad: int = 2
    # accelerator knobs (no reference counterpart)
    compute_dtype: str = "float32"  # "bfloat16" for throughput


@dataclasses.dataclass
class StreamConfig:
    """Streaming / auto-clip settings.

    Sliding-window knobs from inactive/live_feed.py:161-163; openness-gating
    knobs from inactive/live_lower_half.py:143-151.
    """

    max_t: int = 90
    pred_every: int = 2
    warmup_min: int = 10
    # openness-gated auto-clip segmentation
    open_thresh: float = 0.15
    start_n: int = 2
    end_n: int = 4
    max_clip: int = 80
    hold_frames: int = 20
    conf_thresh: float = 0.45
    # --- streaming runtime (no reference counterpart) ---
    # 'sequential' = the reference's one-thread loop; 'threaded' = capture+
    # landmarker producer -> C++ SPSC ring -> dispatch thread (runtime/
    # pipeline.LivePipeline), drops surfaced on the overlay
    pipeline: str = "sequential"
    # 'window' = sliding-window re-score (live_feed.py semantics); 'carry' =
    # O(1)/frame incremental GRU for unidirectional (uni-GRU) checkpoints
    engine: str = "window"
    ring_capacity: int = 256


@dataclasses.dataclass
class EvalConfig:
    """Offline dataset evaluation (inactive/dataset_eval.py)."""

    clip_dir: str = "clips_npz"
    ckpt_path: str = "word_model_points_roi.ckpt"
    batch_size: int = 64
    top_confusions: int = 10
    # accelerator serving knobs (no reference counterpart)
    compute_dtype: str = "float32"
    matmul_precision: str = ""  # see InferConfig.matmul_precision
    # data-parallel serving sweep over a device mesh, e.g. {"data": 8}
    # (Predictor.shard; batches shard on 'data', params replicate)
    mesh_shape: Optional[dict] = None


def parse_bool(key: str, raw: str) -> bool:
    """Strict CLI boolean: a typo ('ture') must not silently become False."""
    low = str(raw).lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(
        f"{key}={raw!r} is not a boolean (use true/false, 1/0, yes/no, on/off)"
    )


def serving_kwargs(cfg) -> dict:
    """Predictor serving kwargs from an Infer/EvalConfig.

    ``matmul_precision``: empty string defers to the Predictor default
    (models/bigru.SERVING_PRECISION); 'default'/'none' force backend-default
    matmuls; anything else ('high', 'highest') passes through."""
    kw = dict(compute_dtype=cfg.compute_dtype)
    if cfg.matmul_precision:
        kw["matmul_precision"] = (
            None if cfg.matmul_precision in ("default", "none")
            else cfg.matmul_precision
        )
    return kw


def _parse_dict_override(raw: str) -> dict:
    """Accept JSON ('{"data": 4, "model": 2}') or compact 'data:4,model:2'."""
    import json

    try:
        val = json.loads(raw)
        if not isinstance(val, dict):
            raise ValueError(f"expected a dict, got {type(val).__name__}")
        return val
    except json.JSONDecodeError:
        out = {}
        for part in raw.split(","):
            if ":" not in part:
                raise ValueError(
                    f"dict override must be JSON or k:v[,k:v...], got {raw!r}"
                )
            k, v = part.split(":", 1)
            out[k.strip()] = int(v)
        return out


def apply_overrides(cfg, overrides: Sequence[str]):
    """Apply ``key=value`` CLI overrides to a config dataclass in place.

    Dict-typed fields (e.g. ``mesh_shape``) accept JSON or ``k:v,k:v``
    (``mesh_shape=data:4,model:2``)."""
    import dataclasses as _dc

    dict_fields = {
        f.name for f in _dc.fields(cfg)
        if f.type in ("Optional[dict]", "dict") or isinstance(f.default, dict)
    }
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, raw = item.split("=", 1)
        if not hasattr(cfg, key):
            raise AttributeError(f"{type(cfg).__name__} has no field {key!r}")
        cur = getattr(cfg, key)
        if key in dict_fields or isinstance(cur, dict):
            val = _parse_dict_override(raw)
        elif isinstance(cur, bool):
            val = parse_bool(key, raw)
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        else:
            val = raw
        setattr(cfg, key, val)
    return cfg
