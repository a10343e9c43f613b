"""Legacy trainer pipelines run end-to-end on synthetic corpora."""

import numpy as np

from silent_speech.data.synthetic import generate_corpus
from silent_speech.train.legacy_loops import (
    MLPQuickConfig,
    ReducedConfig,
    UniGRUConfig,
    activity_from_X,
    add_deltas,
    train_mlp_quick,
    train_reduced,
    train_unigru,
    trim_by_activity,
    zscore_per_clip,
)
from silent_speech.train import load_checkpoint


def test_reduced_trainer(tmp_path):
    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=6,
                    words=["hello", "water", "thanks", "please", "apple"],
                    seed=1, with_roi=False)
    cfg = ReducedConfig(clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
                        epochs=12, batch_size=8, max_t=48, plateau_patience=4)
    r = train_reduced(cfg, verbose=False)
    assert 0.0 <= r["best_acc"] <= 1.0
    _, meta, _ = load_checkpoint(cfg.out_path)
    assert meta["model"] == "reduced_bigru" and meta["hidden"] == 64


def test_unigru_trainer_and_preprocessing(tmp_path):
    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=5, words=["yes", "no"],
                    seed=2, with_roi=False)
    cfg = UniGRUConfig(clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
                       epochs=6, batch_size=4, t_target=24)
    r = train_unigru(cfg, verbose=False)
    assert 0.0 <= r["best_acc"] <= 1.0
    _, meta, _ = load_checkpoint(cfg.out_path)
    # the 1130pm checkpoint carries its trim/delta config
    # (inactive/train_model_1130pm.py:231-242)
    assert meta["use_deltas"] is True
    assert meta["trim"]["q"] == 0.60
    assert meta["d_in"] == meta["d_target"] * 2


def test_unigru_preprocessing_helpers(rng):
    X = rng.standard_normal((40, 180)).astype(np.float32)
    a = activity_from_X(X)
    assert a.shape == (40,)
    Xt = trim_by_activity(X, 32)
    assert Xt.shape == (32, 180)
    Xd = add_deltas(X)
    assert Xd.shape == (40, 360)
    np.testing.assert_allclose(Xd[1:, 180:], X[1:] - X[:-1], atol=1e-6)
    Xz = zscore_per_clip(X)
    np.testing.assert_allclose(Xz.mean(0), 0.0, atol=1e-4)

    # odd-D activity uses the last column directly
    Xodd = np.concatenate([X, np.arange(40, dtype=np.float32)[:, None]], axis=1)
    np.testing.assert_allclose(activity_from_X(Xodd), Xodd[:, -1])


def test_mlp_quick_has_test_split(tmp_path):
    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=8, words=["yes", "no", "hello"],
                    seed=3, with_roi=False)
    cfg = MLPQuickConfig(clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
                         epochs=20, batch_size=8)
    r = train_mlp_quick(cfg, verbose=False)
    assert "test_acc" in r  # the true held-out TEST evaluation
    assert 0.0 <= r["test_acc"] <= 1.0
    # strong separability + summary features: MLP should learn this corpus
    assert r["best_acc"] >= 0.5
