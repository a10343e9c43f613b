"""Predictors for the non-official model families.

Dispatches on the ``model`` tag our checkpoints carry (train/legacy_loops.py,
train/ctc_loop.py); also loads the corresponding reference PyTorch
checkpoints (word_model.pt / word_model_5.pt schema variants,
inactive/dataset_eval.py:34-42, inactive/caden_record.py:138-148).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.schema import fix_dim, pad_trim_time
from ..models import variants as V
from ..train.checkpoint import load_checkpoint
from .predictor import topk_from_logits


class VariantPredictor:
    """Jitted clip predictor over a feature-only variant model."""

    def __init__(self, forward: Callable, id_to_label: dict[int, str],
                 d_in: int, max_t: int, *,
                 zscore: bool = False, add_deltas: bool = False,
                 trim: Optional[dict] = None,
                 summary_host: bool = False, time_bucketed: bool = False):
        import types

        self._fwd = jax.jit(forward)
        self.id_to_label = id_to_label
        self.d_in = d_in
        self.max_t = max_t
        self.zscore = zscore
        self.add_deltas = add_deltas
        self.trim = trim  # activity-trim config (unigru family)
        # jit-cache discipline for variable-length families (max_t unbounded):
        # summary_host computes the (2D,) mean/std summary in numpy so the
        # jitted MLP sees one fixed shape; time_bucketed pads T to a bucket
        # and passes lengths (forward must mask — bitwise-equal, see
        # models.variants.temporal_cnn_forward). Without these, every
        # distinct clip length costs a fresh compile.
        self.summary_host = summary_host
        self.time_bucketed = time_bucketed
        # duck-typed model-config shim so the live app loops (apps/live.py)
        # can drive any family: variant models are feature-only
        self.cfg = types.SimpleNamespace(use_roi=False, roi_h=48, roi_w=96)

    @classmethod
    def from_checkpoint(cls, path: str, _loaded=None) -> "VariantPredictor":
        params, meta, _ = _loaded if _loaded is not None else load_checkpoint(path)
        model = meta.get("model")
        if model == "reduced_bigru":
            fwd = lambda X: V.reduced_bigru_forward(params, X)
            i2l = {int(k): v for k, v in meta["id_to_label"].items()}
            return cls(fwd, i2l, int(meta["x_dim"]), int(meta["max_t"]))
        if model == "unigru":
            fwd = lambda X: V.unigru_classifier_forward(params, X)
            i2l = {int(k): v for k, v in meta["id_to_word"].items()}
            return cls(fwd, i2l, int(meta["d_target"]),
                       int(meta["t_target"]),
                       zscore=True, add_deltas=bool(meta.get("use_deltas")),
                       trim=dict(meta.get("trim", {})))
        if model == "summary_mlp":
            fwd = lambda s: V.mlp_forward(params, s)  # s: (B, 2D) host summary
            i2l = {int(k): v for k, v in meta["id_to_label"].items()}
            return cls(fwd, i2l, int(meta["in_dim"]) // 2, 10 ** 6,
                       summary_host=True)
        raise ValueError(f"unknown variant model tag: {model!r}")

    @classmethod
    def from_torch_reduced(cls, path: str, _ckpt=None) -> "VariantPredictor":
        """Reference word_model_5.pt (inactive/train_reduced.py:250-257:
        model/id_to_label/input_dim/max_t). train_reduced declares the head
        as a Sequential ('head.0.*') while the caden demos re-declare it as a
        bare Linear ('head.*') — a naming skew that makes the reference's own
        loader fail; accept both."""
        import torch

        from ..core.torch_import import import_reduced_bigru

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        sd = dict(ckpt["model"])
        if "head.weight" in sd and "head.0.weight" not in sd:
            sd["head.0.weight"] = sd.pop("head.weight")
            sd["head.0.bias"] = sd.pop("head.bias")
        params = import_reduced_bigru(sd)
        i2l = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        fwd = lambda X: V.reduced_bigru_forward(params, X)
        return cls(fwd, i2l, int(ckpt["input_dim"]), int(ckpt["max_t"]))

    @classmethod
    def from_torch_gru_word(cls, path: str, _ckpt=None) -> "VariantPredictor":
        """Reference GRUWordClassifier ckpt (inactive/live_feed.py:29-50,
        :131-141): same top-level keys as word_model_5.pt
        (model/id_to_label/input_dim/max_t) but a 2-layer BiGRU h=128 with a
        LayerNorm+MLP head — distinguished by the 'gru.weight_ih_l1' state
        entry."""
        import torch

        from ..core.torch_import import import_gru_word_classifier

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        params = import_gru_word_classifier(ckpt["model"])
        i2l = {int(k): str(v) for k, v in ckpt["id_to_label"].items()}
        fwd = lambda X: V.gru_word_classifier_forward(params, X)
        return cls(fwd, i2l, int(ckpt["input_dim"]), int(ckpt["max_t"]))

    @classmethod
    def from_torch_unigru(cls, path: str, _ckpt=None) -> "VariantPredictor":
        """Reference 1130pm word_model.pt (inactive/train_model_1130pm.py:
        230-241: model_state/d_in/id_to_word/t_target/d_target/use_deltas/
        trim)."""
        import torch

        from ..core.torch_import import import_unigru_classifier

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        params = import_unigru_classifier(ckpt["model_state"])
        i2l = {int(k): str(v) for k, v in ckpt["id_to_word"].items()}
        fwd = lambda X: V.unigru_classifier_forward(params, X)
        return cls(fwd, i2l, int(ckpt["d_target"]), int(ckpt["t_target"]),
                   zscore=True, add_deltas=bool(ckpt.get("use_deltas")),
                   trim=dict(ckpt.get("trim", {})))

    @classmethod
    def from_torch_mlp(cls, path: str, _ckpt=None) -> "VariantPredictor":
        """Reference quick-MLP ckpt (inactive/train_5_quick.py:133-136:
        model_state/labels/in_dim; in_dim = 2*D mean+std summary)."""
        import torch

        from ..core.torch_import import import_mlp

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        params = import_mlp(ckpt["model_state"])
        labels = list(ckpt["labels"])
        i2l = {i: str(w) for i, w in enumerate(labels)}
        fwd = lambda s: V.mlp_forward(params, s)  # s: (B, 2D) host summary
        return cls(fwd, i2l, int(ckpt["in_dim"]) // 2, 10 ** 6,
                   summary_host=True)

    @classmethod
    def from_torch_temporal_cnn(cls, path: str, _ckpt=None) -> "VariantPredictor":
        """Legacy word_model.pt with the TemporalCNN schema
        (inactive/dataset_eval.py:34-42: d_in / num_classes / model_state /
        id_to_word)."""
        import torch

        from ..core.torch_import import import_temporal_cnn

        ckpt = _ckpt if _ckpt is not None else torch.load(
            path, map_location="cpu", weights_only=False)
        i2l = {int(k): str(v) for k, v in ckpt.get("id_to_word", {}).items()}
        if not i2l:
            # fail BEFORE weight import — topk_from_logits indexes the map
            # directly, so an empty one would KeyError mid-session
            raise ValueError(
                f"{path} has no id_to_word map in its checkpoint — cannot "
                "name predictions (re-save the checkpoint with its label map)"
            )
        params = import_temporal_cnn(ckpt["model_state"])
        d_in = int(ckpt["d_in"])
        fwd = lambda X, L: V.temporal_cnn_forward(params, X, L)
        return cls(fwd, i2l, d_in, 10 ** 6, zscore=True, time_bucketed=True)

    def predict_features(self, X: np.ndarray, k: int = 3):
        """X: (T, D_any) -> top-k (word, prob). Applies the family's exact
        training-time preprocessing: fix_dim, then (unigru) activity trim to
        the target window, then z-score over the padded window, deltas, and a
        second z-score — the same order as the trainer
        (train/legacy_loops._unigru_preprocess)."""
        X = fix_dim(np.asarray(X, np.float32), self.d_in)
        if self.trim is not None and self.max_t < 10 ** 6:
            from ..train.legacy_loops import trim_by_activity

            X = trim_by_activity(
                X, self.max_t,
                margin=int(self.trim.get("margin", 2)),
                q=float(self.trim.get("q", 0.60)),
                min_keep=int(self.trim.get("min_keep", 6)),
            )
        elif self.max_t < 10 ** 6:
            X, _ = pad_trim_time(X, self.max_t)
        if self.zscore:
            X = (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)
        if self.add_deltas:
            d = np.zeros_like(X)
            d[1:] = X[1:] - X[:-1]
            X = np.concatenate([X, d], axis=1)
            X = (X - X.mean(0, keepdims=True)) / (X.std(0, keepdims=True) + 1e-6)
        if self.summary_host:
            # numpy mean/population-std == models.variants.clip_to_summary
            summ = np.concatenate([X.mean(0), X.std(0)]).astype(np.float32)
            logits = np.asarray(self._fwd(jnp.asarray(summ[None])))[0]
        elif self.time_bucketed:
            T = len(X)
            Tb = max(32, -(-T // 32) * 32)  # next multiple of 32
            Xp = np.zeros((Tb, X.shape[1]), np.float32)
            Xp[:T] = X
            logits = np.asarray(self._fwd(
                jnp.asarray(Xp[None]), jnp.asarray(np.asarray([T], np.int32))
            ))[0]
        else:
            logits = np.asarray(self._fwd(jnp.asarray(X[None])))[0]
        return topk_from_logits(logits, self.id_to_label, k)

    def predict_arrays(self, feats, roi, k: int = 3):
        """Predictor-interface adapter (apps/live.py): variant families are
        feature-only, so the ROI stack is ignored."""
        del roi
        return self.predict_features(np.asarray(feats, np.float32), k=k)
