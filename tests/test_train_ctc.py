"""CTC training pipeline smoke + checkpoint metadata contract."""

from silent_speech.core.config import CTCTrainConfig
from silent_speech.data.synthetic import generate_corpus
from silent_speech.train import load_checkpoint, train_ctc


def test_ctc_training_runs_and_checkpoints(tmp_path):
    corpus = tmp_path / "clips"
    generate_corpus(str(corpus), clips_per_word=4, words=["yes", "no", "hello"],
                    seed=5)
    cfg = CTCTrainConfig(
        clip_dir=str(corpus), out_path=str(tmp_path / "ctc.ckpt"),
        epochs=3, patience=3, batch_size=4, max_t=40,
        hidden=24, gru_layers=2, roi_emb=8,
    )
    r = train_ctc(cfg, verbose=False)
    assert 0.0 <= r["best_acc"] <= 1.0
    assert len(r["history"]) >= 1
    # training loss should be finite and decreasing-ish
    assert r["history"][0]["loss"] > 0

    _, meta, _ = load_checkpoint(cfg.out_path)
    # the reference CTC checkpoint extras (inactive/train_model.py:258-266)
    assert meta["vocab"][0] == "<blank>" and len(meta["vocab"]) == 27
    assert meta["blank_id"] == 0
    assert set(meta["uniq_labels"]) == {"yes", "no", "hello"}
    assert meta["label_to_text"]["hello"] == "hello"
    assert meta["x_dim"] == 180 and meta["max_t"] == 40
