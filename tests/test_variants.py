"""Parity of the historical model families vs torch re-implementations."""

import numpy as np
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from silent_speech.core import torch_import as ti
from silent_speech.models import variants as V
from silent_speech.models import ctc_model as C


def test_temporal_cnn_parity(rng):
    """inactive/dataset_eval.py:5-16."""

    class TorchTemporalCNN(nn.Module):
        def __init__(self, d_in, num_classes):
            super().__init__()
            self.net = nn.Sequential(
                nn.Conv1d(d_in, 128, 5, padding=2), nn.ReLU(),
                nn.Conv1d(128, 128, 5, padding=2), nn.ReLU(),
                nn.AdaptiveAvgPool1d(1),
            )
            self.head = nn.Linear(128, num_classes)

        def forward(self, x):
            return self.head(self.net(x.transpose(1, 2)).squeeze(-1))

    torch.manual_seed(0)
    tm = TorchTemporalCNN(180, 10).eval()
    x = rng.standard_normal((3, 32, 180)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    params = ti.import_temporal_cnn(tm.state_dict())
    got = V.temporal_cnn_forward(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4, rtol=1e-4)


def test_gru_word_classifier_parity(rng):
    """inactive/live_feed.py:29-50 (2-layer BiGRU h=128, mean pool, LN head)."""

    class TorchGWC(nn.Module):
        def __init__(self, d, h, c):
            super().__init__()
            self.gru = nn.GRU(d, h, num_layers=2, batch_first=True,
                              bidirectional=True, dropout=0.1)
            self.head = nn.Sequential(
                nn.LayerNorm(h * 2), nn.Linear(h * 2, 128), nn.ReLU(),
                nn.Dropout(0.2), nn.Linear(128, c))

        def forward(self, x):
            out, _ = self.gru(x)
            return self.head(out.mean(dim=1))

    torch.manual_seed(1)
    tm = TorchGWC(83, 128, 20).eval()
    x = rng.standard_normal((2, 40, 83)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    params = ti.import_gru_word_classifier(tm.state_dict())
    got = V.gru_word_classifier_forward(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-4)


def test_unigru_parity(rng):
    """inactive/train_model_1130pm.py:88-98 (final hidden state head)."""

    class TorchUni(nn.Module):
        def __init__(self, d, h, c):
            super().__init__()
            self.gru = nn.GRU(d, h, batch_first=True)
            self.head = nn.Linear(h, c)

        def forward(self, x):
            _, hn = self.gru(x)
            return self.head(hn[0])

    torch.manual_seed(2)
    tm = TorchUni(344, 128, 20).eval()
    x = rng.standard_normal((3, 32, 344)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    params = ti.import_unigru_classifier(tm.state_dict())
    got = V.unigru_classifier_forward(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-4)


def test_reduced_bigru_parity(rng):
    """inactive/train_reduced.py:129-145 (1-layer BiGRU h=64, mean pool)."""

    class TorchReduced(nn.Module):
        def __init__(self, d, h, c):
            super().__init__()
            self.gru = nn.GRU(d, h, num_layers=1, batch_first=True, bidirectional=True)
            self.head = nn.Sequential(nn.Linear(h * 2, c))

        def forward(self, x):
            out, _ = self.gru(x)
            return self.head(out.mean(dim=1))

    torch.manual_seed(3)
    tm = TorchReduced(180, 64, 5).eval()
    x = rng.standard_normal((2, 60, 180)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    params = ti.import_reduced_bigru(tm.state_dict())
    got = V.reduced_bigru_forward(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-3, rtol=1e-4)


def test_mlp_parity(rng):
    """inactive/train_5_quick.py:36-50 + clip mean/std summary feature."""

    class TorchMLP(nn.Module):
        def __init__(self, d, c):
            super().__init__()
            self.net = nn.Sequential(
                nn.Linear(d, 128), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(128, 64), nn.ReLU(), nn.Dropout(0.2),
                nn.Linear(64, c))

        def forward(self, x):
            return self.net(x)

    torch.manual_seed(4)
    tm = TorchMLP(360, 5).eval()
    X = rng.standard_normal((2, 30, 180)).astype(np.float32)
    feat = np.concatenate([X.mean(1), X.std(1)], axis=-1)
    with torch.no_grad():
        ref = tm(torch.from_numpy(feat)).numpy()
    params = ti.import_mlp(tm.state_dict())
    jfeat = V.clip_to_summary(jnp.asarray(X))
    np.testing.assert_allclose(np.asarray(jfeat), feat, atol=1e-5)
    got = V.mlp_forward(params, jfeat)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-4, rtol=1e-4)


class _TorchCTCRoi(nn.Module):
    """Test fixture from spec: inactive/train_model.py:124-139 TinyROICNN."""

    def __init__(self, out_dim=32):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 8, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(8, 16, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(16, 24, 3, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool2d((1, 1)))
        self.fc = nn.Linear(24, out_dim)

    def forward(self, r):
        B, T, Cc, H, W = r.shape
        z = self.net(r.reshape(B * T, Cc, H, W)).reshape(B * T, -1)
        return self.fc(z).reshape(B, T, -1)


class _TorchCTC(nn.Module):
    """Test fixture from spec: inactive/train_model.py:141-164
    BiGRUCTCWithROI (module-level so other checks can audit
    the CTC family on-chip too)."""

    def __init__(self, x_dim, hidden=192, num_classes=27):
        super().__init__()
        self.roi = _TorchCTCRoi()
        self.gru = nn.GRU(x_dim + 32, hidden, num_layers=3,
                          bidirectional=True, batch_first=True, dropout=0.1)
        self.proj = nn.Linear(hidden * 2, num_classes)

    def forward(self, x, r, lengths):
        z = torch.cat([x, self.roi(r)], dim=2)
        packed = nn.utils.rnn.pack_padded_sequence(
            z, lengths.cpu(), batch_first=True, enforce_sorted=False)
        out, _ = self.gru(packed)
        out, _ = nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=x.shape[1])
        return torch.log_softmax(self.proj(out), dim=2)


def test_ctc_model_parity(rng):
    """inactive/train_model.py:141-164 BiGRUCTCWithROI."""
    torch.manual_seed(5)
    tm = _TorchCTC(180).eval()
    B, T = 2, 19
    x = rng.standard_normal((B, T, 180)).astype(np.float32)
    r = rng.random((B, T, 1, 48, 96)).astype(np.float32)
    lengths = np.array([19, 8], np.int32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x), torch.from_numpy(r),
                 torch.from_numpy(lengths.astype(np.int64))).numpy()

    params = ti.import_bigru_ctc(tm.state_dict())
    got = C.forward(params, jnp.asarray(x), jnp.asarray(r[:, :, 0]),
                    jnp.asarray(lengths))
    got = np.asarray(got)
    # compare only valid frames (padded frames differ by construction:
    # torch emits zeros post-pad, we emit log-softmax of frozen states)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got[1, :8], ref[1, :8], atol=1e-3, rtol=1e-4)


def test_ctc_vocab_and_encoding():
    assert C.VOCAB[0] == "<blank>" and len(C.VOCAB) == 27
    assert C.normalize_label("Hello!") == "hello"
    assert C.encode_text("abz") == [1, 2, 26]
