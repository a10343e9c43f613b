"""Metrics logging, stage timers, and training resume."""

import json

from silent_speech.core.config import TrainConfig
from silent_speech.data.synthetic import generate_corpus
from silent_speech.train import train
from silent_speech.train.metrics import MetricsLogger, StageTimer


def test_metrics_logger(tmp_path):
    p = str(tmp_path / "m.jsonl")
    log = MetricsLogger(p)
    log.log(step=1, loss=0.5, acc=0.9)
    log.log(step=2, loss=0.4, note="hello")
    log.close()
    lines = [json.loads(l) for l in open(p)]
    assert lines[0]["step"] == 1 and lines[0]["loss"] == 0.5
    assert lines[1]["note"] == "hello"
    assert all("t" in l for l in lines)


def test_stage_timer():
    t = StageTimer()
    for _ in range(3):
        with t.stage("a"):
            pass
    s = t.summary()
    assert s["a"]["n"] == 3 and s["a"]["p50_ms"] >= 0


def test_train_resume_continues(tmp_path):
    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"], seed=3)
    base = dict(clip_dir=str(corpus), out_path=str(tmp_path / "m.ckpt"),
                batch_size=4, max_t=40, lr=1e-3, patience=20)

    r1 = train(TrainConfig(epochs=2, **base), verbose=False,
               metrics_path=str(tmp_path / "metrics.jsonl"))
    assert len(r1["history"]) == 2

    # resume from the saved checkpoint: epochs continue past the saved epoch
    r2 = train(TrainConfig(epochs=4, **base), verbose=False,
               resume_from=str(tmp_path / "m.ckpt"))
    eps = [h["epoch"] for h in r2["history"]]
    assert eps[0] > 1 and eps[-1] == 4

    # metrics file captured both epochs of run 1
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert len(lines) == 2 and {l["step"] for l in lines} == {1, 2}

    # the best-so-far bar resumed too: a post-resume epoch can only have
    # improved on run 1's best, never regressed it (best_acc restarting at
    # 0.0 would let a worse epoch overwrite the best checkpoint)
    assert r2["best_acc"] >= r1["best_acc"]
    from silent_speech.train.checkpoint import load_checkpoint

    _, meta, _ = load_checkpoint(str(tmp_path / "m.ckpt"))
    assert float(meta["best_val_acc"]) == r2["best_acc"]


def test_orbax_checkpoint_roundtrip_matches_npz(tmp_path):
    """Both checkpoint backends round-trip identically."""
    import jax
    import numpy as np

    from silent_speech.models import bigru as model
    from silent_speech.train import make_optimizer
    from silent_speech.train.checkpoint import (
        load_checkpoint,
        reference_meta,
        save_checkpoint,
        wait_for_async_saves,
    )

    mcfg = model.BiGRUConfig(x_dim=16, num_classes=3, use_roi=True,
                             hidden=8, roi_emb=4)
    params = jax.tree.map(np.asarray,
                          model.init_params(jax.random.PRNGKey(0), mcfg))
    opt = make_optimizer(1e-3)
    leaves = [np.asarray(a) for a in jax.tree.leaves(opt.init(params))]
    meta = reference_meta(
        x_dim=16, max_t=40, use_roi=True, roi_w=96, roi_h=48,
        labels=["a", "b", "c"], label_to_id={"a": 0, "b": 1, "c": 2},
        id_to_label={0: "a", 1: "b", 2: "c"}, seed=42, epoch=3,
    )

    npz_path = str(tmp_path / "ck.npz.ckpt")
    orb_path = str(tmp_path / "ck_orbax")
    save_checkpoint(npz_path, params, meta, opt_state_arrays=leaves)
    save_checkpoint(orb_path, params, meta, opt_state_arrays=leaves,
                    format="orbax", async_save=True)
    wait_for_async_saves()

    pa, ma, oa = load_checkpoint(npz_path)
    pb, mb, ob = load_checkpoint(orb_path)  # auto-detected directory
    assert ma == mb
    assert jax.tree.structure(pa) == jax.tree.structure(pb)
    for x, y in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(oa, ob):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_train_orbax_format_resume_and_predict(tmp_path):
    """train(checkpoint_format='orbax') saves a loadable dir: resume works and
    the Predictor consumes it like an npz checkpoint."""
    from silent_speech.infer.predictor import Predictor

    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no"], seed=3)
    base = dict(clip_dir=str(corpus), out_path=str(tmp_path / "m_orbax"),
                batch_size=4, max_t=40, lr=1e-3, patience=20,
                checkpoint_format="orbax", async_checkpoint=True)

    r1 = train(TrainConfig(epochs=2, **base), verbose=False)
    assert (tmp_path / "m_orbax").is_dir()

    r2 = train(TrainConfig(epochs=3, **base), verbose=False,
               resume_from=str(tmp_path / "m_orbax"))
    eps = [h["epoch"] for h in r2["history"]]
    assert eps and eps[0] > 1 and eps[-1] == 3

    p = Predictor.from_checkpoint(str(tmp_path / "m_orbax"))
    import numpy as np
    X = np.random.default_rng(0).standard_normal((12, 180)).astype(np.float32)
    roi = np.zeros((12, 48, 96), np.uint8)
    top = p.predict_arrays(X, roi)
    assert len(top) == 2 and {w for w, _ in top} == {"yes", "no"}
