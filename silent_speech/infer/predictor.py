"""Offline/clip prediction — the live-inference compute path.

Reproduces live_infer_official.py's predict block (:338-359): truncate the
recorded clip to max_t, run the *live* forward (no ROI standardization), and
return the top-k (word, prob) list. The forward is jitted once per (T, D)
bucket; clips are padded to bucketed lengths so repeated predictions hit the
jit cache.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.schema import Clip, pad_trim_time
from ..models import bigru as model
from ..train.checkpoint import load_checkpoint


def topk_from_logits(
    logits: np.ndarray, id_to_label: dict[int, str], k: int = 3
) -> list[tuple[str, float]]:
    """Softmax + top-k, formatted as the reference
    (live_infer_official.py:223-226)."""
    x = np.asarray(logits, dtype=np.float64).reshape(-1)
    x = x - x.max()
    p = np.exp(x)
    p /= p.sum()
    top = np.argsort(p)[::-1][:k]
    return [(id_to_label[int(i)], float(p[i])) for i in top]


def _bucket(T: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if T <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Predictor:
    """Jitted clip predictor for the official model."""

    params: dict
    cfg: model.BiGRUConfig
    id_to_label: dict[int, str]
    max_t: int = 90
    min_frames: int = 5
    buckets: tuple[int, ...] = (16, 32, 64, 90)
    compute_dtype: str = "float32"  # "bfloat16" = fast serving mode
    # None = backend default matmuls (TF32 for float32 on an H100);
    # "highest" = true float32. The default is the cheapest mode that holds
    # the fidelity bar on the card (models/bigru.SERVING_PRECISION).
    matmul_precision: Optional[str] = model.SERVING_PRECISION

    def __post_init__(self):
        self.buckets = tuple(sorted(set(list(self.buckets) + [self.max_t])))
        dtype = jnp.dtype(self.compute_dtype)

        @jax.jit
        def _fwd(params, X, lengths, roi):
            return model.live_forward(
                params, self.cfg, X, lengths, roi, compute_dtype=dtype,
                matmul_precision=self.matmul_precision)

        self._fwd = _fwd

    @classmethod
    def from_checkpoint(cls, path: str, _loaded=None, **kw) -> "Predictor":
        params, meta, _ = _loaded if _loaded is not None else load_checkpoint(path)
        cfg = model.BiGRUConfig(
            x_dim=int(meta["x_dim"]),
            num_classes=len(meta["labels"]),
            use_roi=bool(meta["use_roi"]),
            gru_layers=int(meta.get("gru_layers", 2)),
            roi_h=int(meta.get("roi_h", 48)),
            roi_w=int(meta.get("roi_w", 96)),
        )
        id_to_label = {int(k): v for k, v in meta["id_to_label"].items()}
        params = jax.tree.map(jnp.asarray, params)
        return cls(params=params, cfg=cfg, id_to_label=id_to_label,
                   max_t=int(meta["max_t"]), **kw)

    @classmethod
    def from_torch_checkpoint(cls, path: str, _ckpt=None, **kw) -> "Predictor":
        """Load a reference-trained PyTorch checkpoint directly
        (live_infer_official.py:198-221 loader semantics incl. the
        gru_layers-defaults-to-2 tolerance)."""
        import torch

        from ..core.torch_import import import_bigru_classifier

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        gru_layers = int(ckpt.get("gru_layers", 2))
        use_roi = bool(ckpt.get("use_roi", False))
        cfg = model.BiGRUConfig(
            x_dim=int(ckpt["x_dim"]),
            num_classes=len(ckpt["labels"]),
            use_roi=use_roi,
            gru_layers=gru_layers,
        )
        params = import_bigru_classifier(
            ckpt["model"], gru_layers=gru_layers, use_roi=use_roi
        )
        params = jax.tree.map(jnp.asarray, params)
        id_to_label = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        return cls(params=params, cfg=cfg, id_to_label=id_to_label,
                   max_t=int(ckpt["max_t"]), **kw)

    def shard(self, mesh) -> "Predictor":
        """Serve over a device mesh: params replicate, batches shard their
        leading axis on the mesh's data axes (GSPMD inserts the collectives).
        Ragged batches pad up to the data-axis multiple and slice back, so
        ``predict_batch``/``evaluate_dataset`` work unchanged — the
        ``eval-dataset mesh_shape={'data':N}`` path."""
        import math

        from ..parallel.mesh import bigru_param_specs, shard_params
        from ..parallel.train_sharded import make_sharded_infer_fn

        self.params = shard_params(
            self.params, mesh, bigru_param_specs(self.params))
        run = make_sharded_infer_fn(
            self.cfg, mesh, compute_dtype=jnp.dtype(self.compute_dtype),
            matmul_precision=self.matmul_precision,
        )
        n_data = math.prod(
            n for a, n in zip(mesh.axis_names, mesh.devices.shape)
            if a != "model"
        )

        def fwd(params, X, lengths, roi):
            B = X.shape[0]
            pad = (-B) % n_data
            if pad:
                X = jnp.concatenate([X, jnp.zeros((pad,) + X.shape[1:],
                                                  X.dtype)])
                lengths = jnp.concatenate(
                    [lengths, jnp.ones((pad,), lengths.dtype)])
                if roi is not None:
                    roi = jnp.concatenate(
                        [roi, jnp.zeros((pad,) + roi.shape[1:], roi.dtype)])
            return run(params, X, lengths, roi)[:B]

        self._fwd = fwd
        return self

    def warmup(self, batch_sizes: Sequence[int] = (1,)) -> "Predictor":
        """Pre-compile the forward for every (bucket, batch) shape so the
        first live clip predicts at steady-state latency instead of paying
        the first compile mid-session."""
        for B in batch_sizes:
            for Tb in self.buckets:
                X = np.zeros((B, Tb, self.cfg.x_dim), np.float32)
                L = np.full((B,), min(self.min_frames, Tb), np.int32)
                R = (np.zeros((B, Tb, self.cfg.roi_h, self.cfg.roi_w),
                              np.uint8) if self.cfg.use_roi else None)
                self.predict_batch(X, L, R)
        return self

    def predict_arrays(
        self,
        feats: np.ndarray,
        roi: Optional[np.ndarray],
        k: int = 3,
    ) -> list[tuple[str, float]]:
        """feats: (T, D); roi: (T, H, W) uint8 or None. Matches the reference
        predict block: truncate to max_t, zero-ROI when absent."""
        T = min(len(feats), self.max_t)
        if T < self.min_frames:
            raise ValueError(f"clip too short: {T} < {self.min_frames} frames")
        feats = np.asarray(feats[:T], np.float32)
        Tb = _bucket(T, self.buckets)
        X, _ = pad_trim_time(feats, Tb)
        X = X[None]
        lengths = np.asarray([T], np.int32)
        if self.cfg.use_roi:
            if roi is None:
                R = np.zeros((1, Tb, self.cfg.roi_h, self.cfg.roi_w), np.uint8)
            else:
                Rt, _ = pad_trim_time(np.asarray(roi[:T], np.uint8), Tb)
                R = Rt[None]
        else:
            R = None
        logits = self._fwd(
            self.params, jnp.asarray(X), jnp.asarray(lengths),
            None if R is None else jnp.asarray(R),
        )
        return topk_from_logits(np.asarray(logits)[0], self.id_to_label, k)

    def predict_clip(self, clip: Clip, k: int = 3) -> list[tuple[str, float]]:
        clip = clip.aligned() if self.cfg.use_roi else clip
        return self.predict_arrays(clip.X, clip.roi, k)

    def predict_batch(
        self,
        X: np.ndarray,
        lengths: np.ndarray,
        roi: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Batched logits for padded (B, T, D) [+ (B, T, H, W) u8] arrays."""
        return np.asarray(
            self._fwd(
                self.params, jnp.asarray(X), jnp.asarray(lengths),
                None if roi is None else jnp.asarray(roi),
            )
        )


def load_predictor(path: str, **kw):
    """Route any checkpoint to the right predictor family.

    Accepts reference PyTorch checkpoints in every generation's schema —
    official (x_dim/model/..., live_infer_official.py:198-221), reduced
    word_model_5.pt (input_dim/max_t, inactive/train_reduced.py:250-257),
    both word_model.pt generations (uni-GRU with t_target,
    inactive/train_model_1130pm.py:230-241, vs TemporalCNN,
    inactive/dataset_eval.py:34-42), and the quick-MLP (in_dim/labels) — as
    well as this framework's own npz/orbax checkpoints (variant families
    dispatch on their ``model`` metadata tag).

    ``kw`` (serving knobs) applies to the official family; variant families
    are feature-only and ignore it.
    """
    from .variant_predictor import VariantPredictor

    if path.endswith(".pt"):
        import torch

        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if not isinstance(ckpt, dict):
            raise ValueError(f"{path}: not a checkpoint dict")
        if "vocab" in ckpt:
            raise ValueError(
                f"{path} is a CTC checkpoint — use infer-ctc / eval-ctc"
            )
        if "x_dim" in ckpt:
            return Predictor.from_torch_checkpoint(path, _ckpt=ckpt, **kw)
        if "input_dim" in ckpt:
            # word_model_5.pt (reduced, 1-layer h=64) and the live_feed
            # GRUWordClassifier (2-layer h=128, LN+MLP head) share the same
            # top-level keys — disambiguate on the layer-1 GRU weights
            if "gru.weight_ih_l1" in ckpt.get("model", {}):
                return VariantPredictor.from_torch_gru_word(path, _ckpt=ckpt)
            return VariantPredictor.from_torch_reduced(path, _ckpt=ckpt)
        if "t_target" in ckpt:
            return VariantPredictor.from_torch_unigru(path, _ckpt=ckpt)
        if "model_state" in ckpt and "d_in" in ckpt:
            return VariantPredictor.from_torch_temporal_cnn(path, _ckpt=ckpt)
        if "in_dim" in ckpt and "labels" in ckpt:
            return VariantPredictor.from_torch_mlp(path, _ckpt=ckpt)
        raise ValueError(
            f"{path}: unrecognized torch checkpoint schema "
            f"(keys: {sorted(ckpt)})"
        )

    loaded = load_checkpoint(path)
    meta = loaded[1]
    if meta.get("vocab"):
        raise ValueError(f"{path} is a CTC checkpoint — use infer-ctc / eval-ctc")
    if meta.get("model"):
        return VariantPredictor.from_checkpoint(path, _loaded=loaded)
    return Predictor.from_checkpoint(path, _loaded=loaded, **kw)
