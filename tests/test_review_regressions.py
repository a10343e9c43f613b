"""Regression tests for the round-1 code-review findings.

Later rounds' review findings are pinned where they naturally live:
- round-3 device_put-aliasing under donation (make_sharded_train_step
  deleting a caller's params): test_parallel::test_grad_sync_is_global_mean
  re-creates the step from the same params tree after stepping.
- round-3 resume best-acc bar: test_metrics_resume::test_train_resume_continues.
- round-3 ring-accepted causal-reset latch:
  test_apps_headless::test_flagged_source_latch_survives_dropped_sentinel.
"""

import numpy as np

from silent_speech.core.config import TrainConfig, apply_overrides
from silent_speech.data.dataset import epoch_batches
from silent_speech.data.synthetic import generate_corpus


def test_eval_batches_cover_each_sample_once():
    """pad=False: no wrap-padding — every index exactly once (the padded mode
    double-counted head samples in validation metrics)."""
    rng = np.random.default_rng(0)
    idxs = np.concatenate(list(epoch_batches(31, 16, rng, shuffle=False,
                                             pad=False)))
    assert sorted(idxs.tolist()) == list(range(31))
    # padded mode still yields fixed-size batches for training
    padded = list(epoch_batches(31, 16, rng, shuffle=False))
    assert all(len(b) == 16 for b in padded)


def test_mesh_shape_cli_override():
    cfg = apply_overrides(TrainConfig(), ["mesh_shape=data:4,model:2"])
    assert cfg.mesh_shape == {"data": 4, "model": 2}
    cfg2 = apply_overrides(TrainConfig(), ['mesh_shape={"data": 8}'])
    assert cfg2.mesh_shape == {"data": 8}


def test_ctc_trains_on_small_corpus(tmp_path):
    """Corpus smaller than batch_size must still take training steps (the old
    range() silently ran zero steps and saved an untrained model)."""
    from silent_speech.core.config import CTCTrainConfig
    from silent_speech.train import train_ctc

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=3, words=["yes", "no"], seed=4)
    r = train_ctc(CTCTrainConfig(
        clip_dir=str(corpus), out_path=str(tmp_path / "c.ckpt"),
        epochs=2, patience=3, batch_size=64,  # 4 train clips << 64
        max_t=40, hidden=16, gru_layers=1, roi_emb=8,
    ), verbose=False)
    assert r["history"][0]["loss"] > 0.0  # a real step ran


def test_train_forward_requires_rng():
    import pytest
    import jax
    import jax.numpy as jnp

    from silent_speech.models import bigru as model

    cfg = model.BiGRUConfig(x_dim=8, num_classes=3, use_roi=False,
                            hidden=4, gru_layers=1)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    X = jnp.zeros((1, 4, 8))
    L = jnp.asarray(np.asarray([4], np.int32))
    with pytest.raises(ValueError, match="rng is required"):
        model.train_forward(params, cfg, X, L, train=True, rng=None)


def test_best_params_survive_no_improvement(tmp_path):
    """best_params must be a host copy, never an alias of donated buffers."""
    from silent_speech.core.config import TrainConfig
    from silent_speech.train import train

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"], seed=5)
    r = train(TrainConfig(
        clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
        epochs=1, patience=1, batch_size=4, max_t=40,
    ), verbose=False)
    # materializing every returned param must not raise 'Array deleted'
    total = sum(float(np.abs(np.asarray(a)).sum())
                for a in __import__("jax").tree.leaves(r["params"]))
    assert np.isfinite(total)
