"""The official model: TinyROICNN + 2-layer BiGRU + AttnPool + MLP head.

Re-implements the architecture of reference train_model_official.py:209-310 as
pure functions over a param pytree, with the reference's *dual forward*
preserved explicitly (SURVEY.md section 2.5 item 1):

- ``forward(..., roi_standardize=True)`` — the training-path forward:
  ROI is /255 then per-frame mean/std standardized
  (train_model_official.py:286-291).
- ``forward(..., roi_standardize=False)`` — the live-inference forward:
  ROI is only /255 (live_infer_official.py:124-128). The same weights produce
  different logits on the two paths; parity targets are defined against the
  live path.

The per-frame ROI std uses Bessel's correction (ddof=1) to match
``torch.Tensor.std``'s default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops import gru as gru_ops
from ..ops import pooling
from ..ops.nn import (
    conv2d_nhwc,
    conv_init,
    dense,
    dropout,
    gru_dir_init,
    layer_norm,
    layer_norm_init,
    linear_init,
    max_pool_2x2,
)


# Serving matmul precision: the cheapest mode that holds max |dlogit| <= 1e-3
# with equal argmax against the host's float32 reference on the card, on
# random and trained weights (chip_smoke.py measures None and 'highest'). On
# an H100 the default precision runs float32 matmuls in TF32, which drifts
# 5e-4..7e-4 and flips the argmax of near-tied random-weight logits, so only
# 'highest' holds.
SERVING_PRECISION = "highest"


@dataclasses.dataclass(frozen=True)
class BiGRUConfig:
    """Architecture hyperparameters (reference defaults,
    train_model_official.py:254,402)."""

    x_dim: int = 180
    num_classes: int = 10
    use_roi: bool = True
    roi_emb: int = 32
    hidden: int = 192
    gru_layers: int = 2
    gru_dropout: float = 0.1
    head_dropout: float = 0.2
    head_hidden: int = 128
    roi_h: int = 48
    roi_w: int = 96


# ----------------------------------------------------------------------------
# TinyROICNN (train_model_official.py:209-229)
# ----------------------------------------------------------------------------

def init_roi_cnn(key, out_dim: int = 32, dtype=jnp.float32) -> dict:
    k0, k1, k2, k3 = jax.random.split(key, 4)
    return {
        "conv0": conv_init(k0, 3, 3, 1, 8, dtype),
        "conv1": conv_init(k1, 3, 3, 8, 16, dtype),
        "conv2": conv_init(k2, 3, 3, 16, 24, dtype),
        "fc": linear_init(k3, 24, out_dim, dtype),
    }


def roi_cnn_forward(params: dict, roi: jnp.ndarray) -> jnp.ndarray:
    """roi: (B, T, H, W) float (already normalized) -> (B, T, out_dim).

    The frames fold into the batch axis so the convs see one large NHWC batch
    (B*T, H, W, 1). AdaptiveAvgPool2d((1,1)) over the 12x24
    post-pool map is a plain global mean (SURVEY.md section 2.5 item 4).
    """
    B, T, H, W = roi.shape
    x = roi.reshape(B * T, H, W, 1)
    x = jax.nn.relu(conv2d_nhwc(x, params["conv0"]))
    x = max_pool_2x2(x)
    x = jax.nn.relu(conv2d_nhwc(x, params["conv1"]))
    x = max_pool_2x2(x)
    x = jax.nn.relu(conv2d_nhwc(x, params["conv2"]))
    x = jnp.mean(x, axis=(1, 2))  # (B*T, 24)
    x = dense(x, params["fc"])
    return x.reshape(B, T, -1)


# ----------------------------------------------------------------------------
# BiGRUClassifier
# ----------------------------------------------------------------------------

def init_params(key, cfg: BiGRUConfig, dtype=jnp.float32) -> dict:
    keys = jax.random.split(key, 4 + 2 * cfg.gru_layers)
    in_dim = cfg.x_dim + (cfg.roi_emb if cfg.use_roi else 0)
    layers = []
    d = in_dim
    for li in range(cfg.gru_layers):
        layers.append(
            {
                "fwd": gru_dir_init(keys[4 + 2 * li], d, cfg.hidden, dtype),
                "bwd": gru_dir_init(keys[5 + 2 * li], d, cfg.hidden, dtype),
            }
        )
        d = 2 * cfg.hidden
    params = {
        "gru": layers,
        "pool": {"score": linear_init(keys[1], 2 * cfg.hidden, 1, dtype)},
        "head": {
            "ln": layer_norm_init(2 * cfg.hidden, dtype),
            "fc1": linear_init(keys[2], 2 * cfg.hidden, cfg.head_hidden, dtype),
            "fc2": linear_init(keys[3], cfg.head_hidden, cfg.num_classes, dtype),
        },
    }
    if cfg.use_roi:
        params["roi_cnn"] = init_roi_cnn(keys[0], cfg.roi_emb, dtype)
    return params


def standardize_frames(r: jnp.ndarray) -> jnp.ndarray:
    """Per-frame mean/std standardization over the trailing (H, W) axes
    (train_model_official.py:286-291; torch-std ddof=1)."""
    n = r.shape[-1] * r.shape[-2]
    mu = jnp.mean(r, axis=(-1, -2), keepdims=True)
    var = jnp.sum(jnp.square(r - mu), axis=(-1, -2), keepdims=True) / (n - 1)
    std = jnp.maximum(jnp.sqrt(var), 1e-6)
    return (r - mu) / std


def preprocess_roi(roi_u8: jnp.ndarray, standardize: bool) -> jnp.ndarray:
    """uint8 (B, T, H, W) -> float, /255 and optionally per-frame standardized.

    ``standardize=True`` is the training-path normalization
    (train_model_official.py:286-291, torch-std ddof=1);
    ``standardize=False`` is the live path (live_infer_official.py:126).
    """
    r = roi_u8.astype(jnp.float32) / 255.0
    return standardize_frames(r) if standardize else r


def roi_embedding(
    p_roi: dict,
    roi: jnp.ndarray,
    *,
    standardize: bool,
    train: bool = False,
    compute_dtype=jnp.float32,
    roi_remat: bool = False,
) -> jnp.ndarray:
    """TinyROICNN embedding, shared by the official forward and the CTC
    model (inactive/train_model.py:141-150 embeds its ROI with the same
    TinyROICNN).

    ``roi``: (B, T, H, W) uint8 frames (normalized on device), or float
    frames already /255 (the CTC collate contract,
    inactive/train_model.py:109). Returns (B, T, emb) in ``compute_dtype``.
    """

    def _embed(p_roi, roi_in):
        if roi_in.dtype == jnp.uint8:
            r = preprocess_roi(roi_in, standardize)
        else:
            r = roi_in.astype(jnp.float32)
            if standardize:
                r = standardize_frames(r)
        return roi_cnn_forward(p_roi, r.astype(compute_dtype))

    if roi_remat and train:
        # recompute the ROI-CNN activations in the backward instead of
        # storing them: only the input is saved
        _embed = jax.checkpoint(_embed)
    return _embed(p_roi, roi)


def forward(
    params: dict,
    cfg: BiGRUConfig,
    X: jnp.ndarray,
    lengths: jnp.ndarray,
    roi: Optional[jnp.ndarray] = None,
    *,
    roi_standardize: bool = True,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    compute_dtype=jnp.float32,
    matmul_precision: Optional[str] = None,
    roi_remat: bool = False,
) -> jnp.ndarray:
    """X: (B, T, D) f32; lengths: (B,) i32; roi: (B, T, H, W) uint8 or None.

    ``roi_remat`` (training only): jax.checkpoint the ROI embedding so the
    conv activations are recomputed in the backward instead of stored —
    bitwise-identical gradients, less activation memory traffic.

    ``matmul_precision``: None = backend default; a string ('high',
    'highest', ...) applies to every matmul and conv of this forward.
    Returns logits (B, num_classes) f32.
    """
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return forward(
                params, cfg, X, lengths, roi,
                roi_standardize=roi_standardize, train=train, rng=rng,
                compute_dtype=compute_dtype, roi_remat=roi_remat,
            )
    X = X.astype(compute_dtype)
    if cfg.use_roi:
        if roi is None:
            raise ValueError("model was built with use_roi=True but got roi=None")
        roi_e = roi_embedding(
            params["roi_cnn"], roi, standardize=roi_standardize,
            train=train, compute_dtype=compute_dtype, roi_remat=roi_remat,
        )
        Z = jnp.concatenate([X, roi_e], axis=-1)
    else:
        Z = X

    if train:
        if rng is None:
            raise ValueError("rng is required for the training forward "
                             "(GRU/head dropout)")
        rng, gru_rng, head_rng = jax.random.split(rng, 3)
    else:
        gru_rng = head_rng = None

    out, _ = gru_ops.bigru(
        Z,
        lengths,
        params["gru"],
        bidirectional=True,
        dropout_rate=cfg.gru_dropout if cfg.gru_layers > 1 else 0.0,
        train=train,
        rng=gru_rng,
    )
    pooled = pooling.attn_pool(out, lengths, params["pool"])  # (B, 2H)

    h = layer_norm(pooled, params["head"]["ln"])
    h = jax.nn.relu(dense(h, params["head"]["fc1"]))
    if train:
        h = dropout(h, cfg.head_dropout, head_rng, train)
    logits = dense(h, params["head"]["fc2"])
    return logits.astype(jnp.float32)


def live_forward(params, cfg, X, lengths, roi=None, compute_dtype=jnp.float32,
                 matmul_precision: Optional[str] = None):
    """The live-inference forward (no ROI standardization, no dropout) —
    the parity target against live_infer_official.py:124-138."""
    return forward(
        params,
        cfg,
        X,
        lengths,
        roi,
        roi_standardize=False,
        train=False,
        compute_dtype=compute_dtype,
        matmul_precision=matmul_precision,
    )


def train_forward(params, cfg, X, lengths, roi=None, *, train=True, rng=None,
                  compute_dtype=jnp.float32, roi_remat: bool = False):
    """The training-path forward (per-frame ROI standardization,
    train_model_official.py:279-310).

    ``roi_remat`` recomputes the ROI-CNN activations in the backward
    (identical grads, less memory traffic).
    """
    return forward(
        params,
        cfg,
        X,
        lengths,
        roi,
        roi_standardize=True,
        train=train,
        rng=rng,
        compute_dtype=compute_dtype,
        roi_remat=roi_remat,
    )
