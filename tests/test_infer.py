"""Inference engines: clip predictor, evaluator, streaming, CTC decoding."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from silent_speech.core.config import StreamConfig
from silent_speech.data.synthetic import generate_corpus
from silent_speech.infer import (
    CarryStreamingGRU,
    CTCDecoder,
    Dictionary,
    OpennessGate,
    Predictor,
    SlidingWindowEngine,
    evaluate_dataset,
    topk_from_logits,
    trim_silence,
)
from silent_speech.models import bigru as model
from silent_speech.models import ctc_model
from silent_speech.models.variants import (
    init_unigru_classifier,
    unigru_classifier_forward,
)
from silent_speech.ops.nn import dense
from silent_speech.train.checkpoint import reference_meta, save_checkpoint


def _make_predictor(tmp_path, use_roi=True):
    cfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=use_roi)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    labels = sorted(["yes", "no", "hello", "thanks", "please", "fahhh", "six",
                     "seven", "lebron", "aura"])
    l2i = {lab: i for i, lab in enumerate(labels)}
    meta = reference_meta(
        x_dim=180, max_t=90, use_roi=use_roi, roi_w=96, roi_h=48,
        labels=labels, label_to_id=l2i,
        id_to_label={i: lab for lab, i in l2i.items()}, seed=42,
    )
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, jax.tree.map(np.asarray, params), meta)
    return Predictor.from_checkpoint(path)


def test_predictor_roundtrip_and_topk(tmp_path, rng):
    pred = _make_predictor(tmp_path)
    feats = rng.standard_normal((40, 180)).astype(np.float32)
    roi = rng.integers(0, 256, (40, 48, 96), dtype=np.uint8)
    top3 = pred.predict_arrays(feats, roi, k=3)
    assert len(top3) == 3
    assert abs(sum(p for _, p in topk_from_logits(
        np.zeros(10), pred.id_to_label, k=10)) - 1.0) < 1e-6
    # probabilities sorted descending
    assert top3[0][1] >= top3[1][1] >= top3[2][1]

    # matches a direct live_forward call with the same padding
    T = 40
    X = np.zeros((1, 64, 180), np.float32)  # bucket 64
    X[0, :T] = feats
    R = np.zeros((1, 64, 48, 96), np.uint8)
    R[0, :T] = roi
    direct = model.live_forward(
        pred.params, pred.cfg, jnp.asarray(X),
        jnp.asarray(np.asarray([T], np.int32)), jnp.asarray(R))
    direct_top = topk_from_logits(np.asarray(direct)[0], pred.id_to_label, 3)
    assert [w for w, _ in top3] == [w for w, _ in direct_top]


def test_predictor_from_torch_checkpoint(tmp_path, rng):
    """Config #1 golden path: a reference-style .pt checkpoint loads and
    reproduces the torch live forward."""
    from tests.test_model_parity import _TorchBiGRUClassifier

    torch.manual_seed(7)
    tm = _TorchBiGRUClassifier(180, 10, True, standardize_roi=False).eval()
    labels = ["yes", "no", "hello"] + [f"w{i}" for i in range(7)]
    ckpt = {
        "model": tm.state_dict(),
        "x_dim": 180, "max_t": 90, "use_roi": True, "roi_w": 96, "roi_h": 48,
        "labels": labels,
        "label_to_id": {l: i for i, l in enumerate(labels)},
        "id_to_label": {i: l for i, l in enumerate(labels)},
        "seed": 42,
    }
    p = str(tmp_path / "ref.pt")
    torch.save(ckpt, p)
    pred = Predictor.from_torch_checkpoint(p)

    feats = rng.standard_normal((33, 180)).astype(np.float32)
    roi = rng.integers(0, 256, (33, 48, 96), dtype=np.uint8)
    with torch.no_grad():
        ref_logits = tm(
            torch.from_numpy(feats[None]),
            torch.tensor([33]),
            torch.from_numpy(roi[None]),
        ).numpy()[0]
    got = pred.predict_arrays(feats, roi, k=3)
    ref_top = topk_from_logits(ref_logits, pred.id_to_label, 3)
    assert [w for w, _ in got] == [w for w, _ in ref_top]
    np.testing.assert_allclose(
        [p for _, p in got], [p for _, p in ref_top], atol=1e-3)


def test_evaluate_dataset_structure(tmp_path):
    corpus = tmp_path / "clips"
    generate_corpus(str(corpus), clips_per_word=2, seed=3)
    pred = _make_predictor(tmp_path)
    out = evaluate_dataset(pred, str(corpus), verbose=False)
    assert out["n"] == 20
    assert 0.0 <= out["accuracy"] <= 1.0
    assert len(out["confusions"]) <= 10



def test_evaluate_dataset_streams_bounded_chunks(tmp_path):
    """Chunked streaming sweep == whole-corpus sweep:
    host memory stays O(chunk_size) without changing any reported number."""
    corpus = tmp_path / "clips_big"
    generate_corpus(str(corpus), clips_per_word=3, seed=5)  # 30 clips
    pred = _make_predictor(tmp_path)
    whole = evaluate_dataset(pred, str(corpus), verbose=False,
                             chunk_size=1024, batch_size=8)
    # chunk smaller than the corpus AND not a multiple of batch size
    stream = evaluate_dataset(pred, str(corpus), verbose=False,
                              chunk_size=8, batch_size=8)
    assert stream["n"] == whole["n"] == 30
    assert stream["accuracy"] == whole["accuracy"]
    np.testing.assert_allclose(stream["avg_conf"], whole["avg_conf"],
                               rtol=1e-6)
    assert sorted(stream["confusions"]) == sorted(whole["confusions"])

def test_sliding_window_engine_cadence(rng):
    calls = []

    def fwd(X):
        calls.append(np.asarray(X).copy())
        return jnp.zeros((1, 5))

    eng = SlidingWindowEngine(fwd, input_dim=83,
                              cfg=StreamConfig(max_t=20, pred_every=2, warmup_min=10))
    results = [eng.push(rng.standard_normal(83).astype(np.float32))
               for _ in range(24)]
    # no predictions before warmup
    assert all(r is None for r in results[:9])
    fired = [i for i, r in enumerate(results) if r is not None]
    # every 2nd frame after warmup (frame_idx % 2 == 0)
    assert fired and all((i + 1) % 2 == 0 for i in fired)
    assert calls[0].shape == (1, 20, 83)


def test_openness_gate_segmentation(rng):
    cfg = StreamConfig(open_thresh=0.5, start_n=2, end_n=3, max_clip=50)
    gate = OpennessGate(cfg)
    opens = [0.1, 0.6, 0.7, 0.8, 0.9, 0.8, 0.2, 0.1, 0.05, 0.1]
    events = []
    for i, o in enumerate(opens):
        ev = gate.push(o, np.full(4, float(i), np.float32))
        if ev is not None:
            events.append(ev)
    assert len(events) == 1
    # speaking started at frame 2 (2nd consecutive above), clip collects from
    # frame 3 onward until 3 consecutive below (frames 6,7,8)
    assert events[0].frames.shape[1] == 4
    assert len(events[0].frames) >= 4

    # max_clip cap
    gate.reset()
    n_ev = 0
    for i in range(120):
        ev = gate.push(0.9, np.zeros(4, np.float32))
        n_ev += ev is not None
    assert n_ev == 2  # 120 frames / max_clip 50 -> two capped clips


def test_carry_streaming_equals_full_scan(rng):
    """Incremental carry inference == full-window scan (uni-GRU family)."""
    params = init_unigru_classifier(jax.random.PRNGKey(1), 12, 5, hidden=16)
    T = 25
    seq = rng.standard_normal((T, 12)).astype(np.float32)

    full = unigru_classifier_forward(params, jnp.asarray(seq[None]))

    eng = CarryStreamingGRU(
        params["gru"], head=lambda h: dense(h, params["head"]))
    for t in range(T):
        out = eng.push(seq[t])
    np.testing.assert_allclose(out, np.asarray(full)[0], atol=1e-5)


def test_trim_silence_and_ctc_decoder(rng):
    # silence trimming on the openness channel (index -3)
    X = np.zeros((20, 180), np.float32)
    X[5:12, -3] = 1.0
    R = rng.integers(0, 256, (20, 48, 96), dtype=np.uint8)
    Xt, Rt = trim_silence(X, R)
    assert len(Xt) == len(Rt) == (12 + 2) - (5 - 2)  # pad=2 both sides

    params = ctc_model.init_params(jax.random.PRNGKey(2), x_dim=180)
    d = Dictionary.from_words(["yes", "no", "hello"])
    dec = CTCDecoder(params, d, max_t=40)
    ranked = dec.score_clip(X, R)
    assert len(ranked) == 3
    assert dec.predict(X, R) in {"yes", "no", "hello"}
    assert ranked[0][1] >= ranked[-1][1]


def test_predictor_warmup_precompiles_buckets():
    """warmup() must hit every (bucket, B=1) jit entry so the first real
    clip predict is cache-hot (no new compile)."""
    import jax

    from silent_speech.models import bigru as model

    cfg = model.BiGRUConfig(x_dim=12, num_classes=3, use_roi=True, hidden=8,
                            roi_emb=4, head_hidden=8)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    p = Predictor(params=params, cfg=cfg, id_to_label={0: "a", 1: "b", 2: "c"},
                  max_t=20, buckets=(8, 20))
    p.warmup()
    misses0 = p._fwd._cache_size()
    assert misses0 == len(p.buckets)  # one entry per bucket at B=1
    feats = np.zeros((7, 12), np.float32)
    roi = np.zeros((7, 48, 96), np.uint8)
    p.predict_arrays(feats, roi)  # T=7 -> bucket 8: must be cache-hot
    assert p._fwd._cache_size() == misses0


def test_predictor_auto_guards_fused_geometry(rng):
    """The ROI CNN serves every ROI geometry, not only 48x96; a setting
    that named a removed kernel is refused instead of run in an
    interpreter or ignored."""
    import jax
    import pytest

    from silent_speech.models import bigru as model

    base = dict(x_dim=12, num_classes=3, use_roi=True, hidden=8,
                roi_emb=4, head_hidden=8)
    labels = {0: "a", 1: "b", 2: "c"}
    for hw in ((48, 96), (96, 192)):
        cfg = model.BiGRUConfig(roi_h=hw[0], roi_w=hw[1], **base)
        p = Predictor(params=model.init_params(jax.random.PRNGKey(0), cfg),
                      cfg=cfg, id_to_label=labels, max_t=20)
        X = rng.standard_normal((2, 8, 12)).astype(np.float32)
        L = np.array([8, 5], np.int32)
        R = rng.integers(0, 256, (2, 8) + hw, dtype=np.uint8)
        logits = p.predict_batch(X, L, R)
        assert logits.shape == (2, 3) and np.isfinite(logits).all()

    for removed in ("roi_impl", "gru_impl", "roi_variant"):
        with pytest.raises(TypeError, match=removed):
            Predictor(params=p.params, cfg=cfg, id_to_label=labels, max_t=20,
                      **{removed: "fused"})
