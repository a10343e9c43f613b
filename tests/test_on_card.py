"""Checks that need the card. Each carries the ``gpu`` marker and skips on
the CPU; on the card: ``python -m pytest tests/test_on_card.py``."""

import numpy as np
import pytest

import jax


@pytest.mark.gpu
def test_served_logits_match_cpu_reference():
    """The serving default on the GPU against the plain reference (the same
    forward on the host CPU at 'highest'): max |dlogit| <= 1e-3 and equal
    argmax, at the official model's full width."""
    from chip_smoke import compare_logits
    from silent_speech.infer import Predictor
    from silent_speech.models import bigru as model

    cfg = model.BiGRUConfig()
    params = jax.tree.map(np.asarray,
                          model.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    B, T = 8, 32
    X = rng.standard_normal((B, T, 180)).astype(np.float32)
    L = rng.integers(5, T + 1, B).astype(np.int32)
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(
            lambda p, x, l, r: model.live_forward(p, cfg, x, l, r))(
                jax.device_put(params, cpu), X, L, R))
    pred = Predictor(params=jax.tree.map(jax.numpy.asarray, params), cfg=cfg,
                     id_to_label={i: str(i) for i in range(10)})
    res = compare_logits(pred.predict_batch(X, L, R), ref)
    assert res["ok"], res
