"""VariantPredictor: dispatch by model tag + legacy torch schema loaders."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn as nn

from silent_speech.data.synthetic import generate_corpus
from silent_speech.infer import VariantPredictor
from silent_speech.train.legacy_loops import (
    MLPQuickConfig,
    ReducedConfig,
    UniGRUConfig,
    train_mlp_quick,
    train_reduced,
    train_unigru,
)


def test_variant_predictor_roundtrips(tmp_path, rng):
    corpus = tmp_path / "c"
    generate_corpus(str(corpus), clips_per_word=4,
                    words=["hello", "water", "thanks", "please", "apple"],
                    seed=6, with_roi=False)

    train_reduced(ReducedConfig(clip_dir=str(corpus),
                                out_path=str(tmp_path / "r.ckpt"),
                                epochs=2, batch_size=8, max_t=40), verbose=False)
    p = VariantPredictor.from_checkpoint(str(tmp_path / "r.ckpt"))
    X = rng.standard_normal((25, 180)).astype(np.float32)
    top = p.predict_features(X, k=3)
    assert len(top) == 3 and abs(sum(x[1] for x in
                                     p.predict_features(X, k=5)) - 1.0) < 1e-4

    train_unigru(UniGRUConfig(clip_dir=str(corpus),
                              out_path=str(tmp_path / "u.ckpt"),
                              epochs=2, batch_size=4, t_target=24), verbose=False)
    pu = VariantPredictor.from_checkpoint(str(tmp_path / "u.ckpt"))
    assert pu.zscore and pu.add_deltas
    assert len(pu.predict_features(X, k=2)) == 2

    train_mlp_quick(MLPQuickConfig(clip_dir=str(corpus),
                                   out_path=str(tmp_path / "m.ckpt"),
                                   epochs=2), verbose=False)
    pm = VariantPredictor.from_checkpoint(str(tmp_path / "m.ckpt"))
    assert len(pm.predict_features(X, k=1)) == 1


def test_temporal_cnn_torch_schema(tmp_path, rng):
    """The legacy word_model.pt schema (d_in/num_classes/model_state/id_to_word)."""

    class TorchTemporalCNN(nn.Module):
        def __init__(self, d_in, num_classes):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv1d(d_in, 128, 5, padding=2), nn.ReLU(),
                nn.Conv1d(128, 128, 5, padding=2), nn.ReLU(),
                nn.AdaptiveAvgPool1d(1))
            self.head = nn.Linear(128, num_classes)

        def forward(self, x):
            return self.head(self.net(x.transpose(1, 2)).squeeze(-1))

    torch.manual_seed(0)
    tm = TorchTemporalCNN(100, 7).eval()
    path = str(tmp_path / "word_model.pt")
    torch.save({
        "model_state": tm.state_dict(), "d_in": 100, "num_classes": 7,
        "id_to_word": {i: f"w{i}" for i in range(7)},
    }, path)

    p = VariantPredictor.from_torch_temporal_cnn(path)
    X = rng.standard_normal((30, 120)).astype(np.float32)  # wider: fix_dim trims
    top = p.predict_features(X, k=3)

    # reference pipeline: fix_dim then z-score then model
    Xf = X[:, :100]
    Xz = (Xf - Xf.mean(0, keepdims=True)) / (Xf.std(0, keepdims=True) + 1e-6)
    with torch.no_grad():
        ref = torch.softmax(tm(torch.from_numpy(Xz[None])), -1)[0].numpy()
    order = ref.argsort()[::-1]
    assert [w for w, _ in top] == [f"w{i}" for i in order[:3]]
    np.testing.assert_allclose([pr for _, pr in top], ref[order[:3]], atol=1e-3)


def test_temporal_cnn_missing_label_map_fails_at_load(tmp_path):
    """A TemporalCNN .pt without id_to_word must fail at LOAD time with the
    re-save instruction — not KeyError mid-session at the first
    prediction."""
    import torch.nn as nn

    class TorchTemporalCNN(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv1d(10, 8, 5, padding=2), nn.ReLU(),
                nn.AdaptiveAvgPool1d(1))
            self.head = nn.Linear(8, 3)

    path = str(tmp_path / "word_model.pt")
    torch.save({"model_state": TorchTemporalCNN().state_dict(),
                "d_in": 10, "num_classes": 3}, path)
    with pytest.raises(ValueError, match="id_to_word"):
        VariantPredictor.from_torch_temporal_cnn(path)


def test_load_predictor_routes_all_torch_schemas(tmp_path, rng):
    """load_predictor dispatches every reference checkpoint generation by
    schema, and variant predictors satisfy the apps/live interface
    (cfg.use_roi + predict_arrays)."""
    import pytest

    from silent_speech.infer import load_predictor

    # reduced word_model_5.pt schema, with the caden-style bare-Linear head
    # naming (the skew that breaks the reference's own loader)
    class Reduced(nn.Module):
        def __init__(self, d, h, c):
            super().__init__()
            self.gru = nn.GRU(d, h, num_layers=1, batch_first=True,
                              bidirectional=True)
            self.head = nn.Linear(2 * h, c)

        def forward(self, x):
            out, _ = self.gru(x)
            return self.head(out.mean(dim=1))

    torch.manual_seed(1)
    tm = Reduced(83, 64, 5).eval()
    rpath = str(tmp_path / "word_model_5.pt")
    torch.save({
        "model": tm.state_dict(),
        "id_to_label": {i: f"w{i}" for i in range(5)},
        "label_to_id": {f"w{i}": i for i in range(5)},
        "input_dim": 83, "max_t": 60, "words": [f"w{i}" for i in range(5)],
    }, rpath)
    p = load_predictor(rpath)
    assert isinstance(p, VariantPredictor) and p.cfg.use_roi is False
    X = rng.standard_normal((40, 83)).astype(np.float32)
    top = p.predict_arrays(X, None, k=3)

    # reference predict_clip: pad to max_t with zeros, unmasked mean-pool
    Xp = np.zeros((60, 83), np.float32)
    Xp[:40] = X
    with torch.no_grad():
        ref = torch.softmax(tm(torch.from_numpy(Xp[None])), -1)[0].numpy()
    order = ref.argsort()[::-1]
    assert [w for w, _ in top] == [f"w{i}" for i in order[:3]]
    np.testing.assert_allclose([pr for _, pr in top], ref[order[:3]], atol=1e-3)

    # quick-MLP word_model.pt schema (in_dim/labels/model_state, net.0/3/6)
    class QuickMLP(nn.Module):
        def __init__(self, d_in, c):
            super().__init__()
            self.net = nn.Sequential(
                nn.Linear(d_in, 256), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(256, 128), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(128, c))

        def forward(self, x):
            return self.net(x)

    torch.manual_seed(2)
    mm = QuickMLP(166, 5).eval()
    mpath = str(tmp_path / "word_model_quick.pt")
    torch.save({"model_state": mm.state_dict(),
                "labels": [f"w{i}" for i in range(5)], "in_dim": 166}, mpath)
    pm = load_predictor(mpath)
    assert isinstance(pm, VariantPredictor)
    Xm = rng.standard_normal((20, 83)).astype(np.float32)
    topm = pm.predict_arrays(Xm, None, k=2)
    summ = np.concatenate([Xm.mean(0), Xm.std(0)])
    with torch.no_grad():
        refm = torch.softmax(mm(torch.from_numpy(summ[None])), -1)[0].numpy()
    assert topm[0][0] == f"w{int(refm.argmax())}"

    # CTC checkpoints route to a helpful error
    cpath = str(tmp_path / "ctc.pt")
    torch.save({"model": {}, "vocab": ["<b>", "a"], "blank_id": 0}, cpath)
    with pytest.raises(ValueError, match="infer-ctc"):
        load_predictor(cpath)


def test_load_predictor_on_actual_reference_checkpoints():
    """The two checkpoints physically present in the reference snapshot load
    and predict end-to-end (the strongest interop evidence available: real
    hackathon artifacts, not synthetic schemas)."""
    import os

    import pytest

    from silent_speech.infer import load_predictor

    ref = "/root/reference/inactive"
    if not os.path.isdir(ref):
        pytest.skip("reference snapshot not mounted")

    rng = np.random.default_rng(0)
    # word_model_5.pt: reduced BiGRU, 83-D features
    p5 = load_predictor(os.path.join(ref, "word_model_5.pt"))
    assert isinstance(p5, VariantPredictor)
    top = p5.predict_arrays(rng.standard_normal((32, 83)).astype(np.float32),
                            None, k=3)
    assert len(top) == 3
    assert {w for w, _ in top} <= {"hello", "water", "thanks", "please", "apple"}

    # word_model.pt: quick-MLP summary model
    pq = load_predictor(os.path.join(ref, "word_model.pt"))
    assert isinstance(pq, VariantPredictor)
    topq = pq.predict_arrays(rng.standard_normal((20, 83)).astype(np.float32),
                             None, k=3)
    assert abs(sum(pr for _, pr in pq.predict_arrays(
        rng.standard_normal((20, 83)).astype(np.float32), None, k=5)) - 1.0) < 1e-4
    assert len(topq) == 3


def test_evaluate_variant_dataset_structure(tmp_path, rng):
    """The dataset_eval.py workflow for feature-only families: sweep a corpus
    with a VariantPredictor, reference report format."""
    from silent_speech.infer.evaluator import evaluate_variant_dataset

    corpus = tmp_path / "c"
    words = ["hello", "water", "thanks", "please", "apple"]
    generate_corpus(str(corpus), clips_per_word=3, words=words, seed=9,
                    with_roi=False)
    train_reduced(ReducedConfig(clip_dir=str(corpus),
                                out_path=str(tmp_path / "r.ckpt"),
                                epochs=2, batch_size=8, max_t=40),
                  verbose=False)
    p = VariantPredictor.from_checkpoint(str(tmp_path / "r.ckpt"))
    out = evaluate_variant_dataset(p, str(corpus), verbose=False)
    assert out["n"] == 15
    assert 0.0 <= out["accuracy"] <= 1.0
    assert all(t in words for (t, _), _ in out["confusions"])


def test_load_predictor_disambiguates_gru_word_family(tmp_path, rng):
    """live_feed's GRUWordClassifier ckpt shares word_model_5.pt's top-level
    keys; routing must dispatch on the layer-1 GRU weights."""
    from silent_speech.infer import load_predictor

    class GRUWord(nn.Module):
        def __init__(self, d, h, c):
            super().__init__()
            self.gru = nn.GRU(d, h, num_layers=2, batch_first=True,
                              bidirectional=True, dropout=0.1)
            self.head = nn.Sequential(
                nn.LayerNorm(2 * h), nn.Linear(2 * h, 128), nn.ReLU(),
                nn.Dropout(0.2), nn.Linear(128, c))

        def forward(self, x):
            out, _ = self.gru(x)
            return self.head(out.mean(dim=1))

    torch.manual_seed(4)
    tm = GRUWord(83, 128, 20).eval()
    path = str(tmp_path / "word_model.pt")
    torch.save({
        "model": tm.state_dict(),
        "id_to_label": {i: f"w{i}" for i in range(20)},
        "input_dim": 83, "max_t": 60,
    }, path)
    p = load_predictor(path)
    assert isinstance(p, VariantPredictor)
    X = rng.standard_normal((60, 83)).astype(np.float32)
    top = p.predict_arrays(X, None, k=3)
    with torch.no_grad():
        ref = torch.softmax(tm(torch.from_numpy(X[None])), -1)[0].numpy()
    order = ref.argsort()[::-1]
    assert [w for w, _ in top] == [f"w{i}" for i in order[:3]]
    np.testing.assert_allclose([pr for _, pr in top], ref[order[:3]], atol=1e-3)


def test_temporal_cnn_bucketed_matches_unpadded(rng):
    """Masked temporal_cnn_forward on a zero-padded bucket == the unpadded
    forward (the jit-cache-friendly path is numerically exact)."""
    import jax

    from silent_speech.models.variants import (
        init_temporal_cnn,
        temporal_cnn_forward,
    )

    params = init_temporal_cnn(jax.random.PRNGKey(0), 24, 6)
    for T in (5, 17, 31):
        X = rng.standard_normal((1, T, 24)).astype(np.float32)
        ref = np.asarray(temporal_cnn_forward(params, jnp.asarray(X)))
        Xp = np.zeros((1, 32, 24), np.float32)
        Xp[:, :T] = X
        got = np.asarray(temporal_cnn_forward(
            params, jnp.asarray(Xp), jnp.asarray(np.asarray([T], np.int32))))
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_variant_predictors_avoid_per_length_recompiles(tmp_path, rng):
    """temporal-cnn and quick-MLP families must hit one compiled program
    across clip lengths (every new length would cost a recompile)."""

    class QuickMLP(nn.Module):
        def __init__(self, d_in, c):
            super().__init__()
            self.net = nn.Sequential(
                nn.Linear(d_in, 256), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(256, 128), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(128, c))

        def forward(self, x):
            return self.net(x)

    torch.manual_seed(5)
    mm = QuickMLP(166, 5).eval()
    mpath = str(tmp_path / "q.pt")
    torch.save({"model_state": mm.state_dict(),
                "labels": [f"w{i}" for i in range(5)], "in_dim": 166}, mpath)
    pm = VariantPredictor.from_torch_mlp(mpath)
    for T in (7, 19, 33, 58):
        pm.predict_features(rng.standard_normal((T, 83)).astype(np.float32))
    assert pm._fwd._cache_size() == 1, "summary MLP must compile once"

    class TorchTemporalCNN(nn.Module):
        def __init__(self, d_in, num_classes):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv1d(d_in, 128, 5, padding=2), nn.ReLU(),
                nn.Conv1d(128, 128, 5, padding=2), nn.ReLU(),
                nn.AdaptiveAvgPool1d(1))
            self.head = nn.Linear(128, num_classes)

        def forward(self, x):
            return self.head(self.net(x.transpose(1, 2)).squeeze(-1))

    torch.manual_seed(6)
    tm = TorchTemporalCNN(80, 5).eval()
    tpath = str(tmp_path / "t.pt")
    torch.save({"model_state": tm.state_dict(), "d_in": 80, "num_classes": 5,
                "id_to_word": {i: f"w{i}" for i in range(5)}}, tpath)
    pt = VariantPredictor.from_torch_temporal_cnn(tpath)
    for T in (7, 19, 30, 25):  # all bucket to 32
        top = pt.predict_features(
            rng.standard_normal((T, 80)).astype(np.float32), k=1)
        assert len(top) == 1
    assert pt._fwd._cache_size() == 1, "bucketed CNN must compile once per bucket"
