"""BiGRU-CTC model: the open-vocabulary path.

Reference: inactive/train_model.py:141-164 ``BiGRUCTCWithROI`` — TinyROICNN
ROI embedding fused with point features, 3-layer BiGRU(h=192), per-frame
linear projection to the character vocabulary, log-softmax over chars.

The vocabulary is ``<blank>`` + a-z (inactive/train_model.py:32-35).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops import gru as gru_ops
from ..ops.nn import dense, gru_dir_init, linear_init
from .bigru import (  # noqa: F401  (SERVING_PRECISION is re-exported)
    SERVING_PRECISION,
    init_roi_cnn,
    roi_embedding,
)

VOCAB = ["<blank>"] + list("abcdefghijklmnopqrstuvwxyz")
BLANK_ID = 0
CHAR2ID = {c: i for i, c in enumerate(VOCAB)}
ID2CHAR = {i: c for c, i in CHAR2ID.items()}


def normalize_label(word: str) -> str:
    """Lowercase and keep a-z only (inactive/train_model.py:42-43)."""
    return "".join(ch for ch in word.lower() if "a" <= ch <= "z")


def encode_text(text: str) -> list[int]:
    return [CHAR2ID[ch] for ch in text]


def init_params(key, x_dim: int, *, hidden: int = 192, gru_layers: int = 3,
                roi_emb: int = 32, num_classes: int = len(VOCAB)):
    keys = jax.random.split(key, 2 + 2 * gru_layers)
    layers = []
    d = x_dim + roi_emb
    for li in range(gru_layers):
        layers.append({
            "fwd": gru_dir_init(keys[2 + 2 * li], d, hidden),
            "bwd": gru_dir_init(keys[2 + 2 * li + 1], d, hidden),
        })
        d = 2 * hidden
    return {
        "roi_cnn": init_roi_cnn(keys[0], roi_emb),
        "gru": layers,
        "proj": linear_init(keys[1], 2 * hidden, num_classes),
    }


def forward(
    params: dict,
    X: jnp.ndarray,
    roi: jnp.ndarray,
    lengths: jnp.ndarray,
    *,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    dropout_rate: float = 0.1,
    compute_dtype=jnp.float32,
    matmul_precision: Optional[str] = None,
    roi_remat: bool = False,
) -> jnp.ndarray:
    """X: (B, T, D); roi: (B, T, H, W) uint8 frames or float already /255
    (the CTC collate contract, inactive/train_model.py:109 — the division is
    bitwise the same either side of the transfer); lengths (B,).

    ``matmul_precision`` (None | 'high' | 'highest' ...) applies to every
    matmul and conv of this forward, as in models/bigru.forward.

    Returns per-frame log-probs (B, T, C) f32 — batch-first (the transpose
    to (T, B, C) that torch's CTCLoss wants is a reference-API artifact our
    CTC ops don't need).
    """
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return forward(
                params, X, roi, lengths, train=train, rng=rng,
                dropout_rate=dropout_rate, compute_dtype=compute_dtype,
                roi_remat=roi_remat,
            )
    X = X.astype(compute_dtype)
    roi_e = roi_embedding(
        params["roi_cnn"], roi, standardize=False, train=train,
        compute_dtype=compute_dtype, roi_remat=roi_remat,
    )
    Z = jnp.concatenate([X, roi_e], axis=-1)
    out, _ = gru_ops.bigru(
        Z, lengths, params["gru"], bidirectional=True,
        dropout_rate=dropout_rate, train=train, rng=rng,
    )
    logits = dense(out, params["proj"]).astype(jnp.float32)
    return jax.nn.log_softmax(logits, axis=-1)
