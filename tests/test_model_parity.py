"""Golden parity of the full official model vs a PyTorch re-implementation.

The torch model below is a test fixture reproducing the reference
architecture (train_model_official.py:209-310 / live_infer_official.py:68-138)
including the train/live forward skew: the trainer standardizes each ROI frame
(mean/std) after /255; the live script only does /255. Both paths must match
our dual forward to fp32 tolerance through weight import.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from silent_speech.core.torch_import import import_bigru_classifier
from silent_speech.models import bigru as jmodel


class _TorchRoiCNN(nn.Module):
    def __init__(self, out_dim=32):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 8, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(8, 16, 3, padding=1), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(16, 24, 3, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool2d((1, 1)),
        )
        self.fc = nn.Linear(24, out_dim)

    def forward(self, r):
        B, T, C, H, W = r.shape
        z = self.net(r.reshape(B * T, C, H, W)).reshape(B * T, -1)
        return self.fc(z).reshape(B, T, -1)


class _TorchAttnPool(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.score = nn.Linear(dim, 1)

    def forward(self, h, lengths):
        T = h.shape[1]
        mask = torch.arange(T)[None, :] < lengths[:, None]
        s = self.score(h).squeeze(-1).masked_fill(~mask, -1e9)
        w = torch.softmax(s, dim=1).unsqueeze(-1)
        return (h * w).sum(dim=1)


class _TorchBiGRUClassifier(nn.Module):
    def __init__(self, x_dim, num_classes, use_roi, roi_emb=32, hidden=192,
                 gru_layers=2, standardize_roi=True):
        super().__init__()
        self.use_roi = use_roi
        self.standardize_roi = standardize_roi
        self.roi_cnn = _TorchRoiCNN(roi_emb) if use_roi else None
        in_dim = x_dim + (roi_emb if use_roi else 0)
        self.gru = nn.GRU(in_dim, hidden, num_layers=gru_layers,
                          batch_first=True, bidirectional=True,
                          dropout=0.1 if gru_layers > 1 else 0.0)
        self.pool = _TorchAttnPool(hidden * 2)
        self.head = nn.Sequential(
            nn.LayerNorm(hidden * 2), nn.Linear(hidden * 2, 128), nn.ReLU(),
            nn.Dropout(0.2), nn.Linear(128, num_classes),
        )

    def forward(self, X, lengths, R=None):
        if self.use_roi:
            r = (R.float() / 255.0).unsqueeze(2)
            if self.standardize_roi:
                mu = r.mean(dim=(2, 3, 4), keepdim=True)
                std = r.std(dim=(2, 3, 4), keepdim=True).clamp_min(1e-6)
                r = (r - mu) / std
            Z = torch.cat([X, self.roi_cnn(r)], dim=2)
        else:
            Z = X
        packed = nn.utils.rnn.pack_padded_sequence(
            Z, lengths.cpu(), batch_first=True, enforce_sorted=False)
        out, _ = self.gru(packed)
        out, _ = nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=X.shape[1])
        return self.head(self.pool(out, lengths))


def _random_inputs(rng, B=4, T=23, D=180, H=48, W=96):
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    roi = rng.integers(0, 256, size=(B, T, H, W), dtype=np.uint8)
    lengths = np.array([23, 7, 15, 6], dtype=np.int32)[:B]
    return X, roi, lengths


@pytest.mark.parametrize("use_roi", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_bigru_classifier_parity(use_roi, standardize, rng):
    torch.manual_seed(3)
    tm = _TorchBiGRUClassifier(180, 10, use_roi, standardize_roi=standardize)
    tm.eval()
    X, roi, lengths = _random_inputs(rng)

    with torch.no_grad():
        ref = tm(
            torch.from_numpy(X),
            torch.from_numpy(lengths.astype(np.int64)),
            torch.from_numpy(roi) if use_roi else None,
        ).numpy()

    cfg = jmodel.BiGRUConfig(x_dim=180, num_classes=10, use_roi=use_roi)
    params = import_bigru_classifier(tm.state_dict(), use_roi=use_roi)
    logits = jmodel.forward(
        params, cfg,
        jnp.asarray(X), jnp.asarray(lengths),
        jnp.asarray(roi) if use_roi else None,
        roi_standardize=standardize, train=False,
    )
    np.testing.assert_allclose(np.asarray(logits), ref, atol=1e-3, rtol=1e-4)
    # argmax-word parity (the BASELINE acceptance bar)
    assert (np.asarray(logits).argmax(-1) == ref.argmax(-1)).all()


def test_dual_forward_skew_exists(rng):
    """The two forwards must differ on the same weights (SURVEY 2.5 item 1)."""
    torch.manual_seed(4)
    tm = _TorchBiGRUClassifier(180, 10, True)
    cfg = jmodel.BiGRUConfig()
    params = import_bigru_classifier(tm.state_dict())
    X, roi, lengths = _random_inputs(rng)
    a = jmodel.live_forward(params, cfg, jnp.asarray(X), jnp.asarray(lengths), jnp.asarray(roi))
    b = jmodel.train_forward(params, cfg, jnp.asarray(X), jnp.asarray(lengths), jnp.asarray(roi), train=False)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-3


def test_matmul_precision_knob_plumbs_through(rng):
    """matmul_precision='highest' is a no-op on the exact-f32 CPU backend —
    identical logits — and plumbs through forward/Predictor without error
    (on a GPU it turns off TF32; chip_smoke.py measures it there)."""
    import jax

    from silent_speech.models import bigru as model

    cfg = model.BiGRUConfig(x_dim=12, num_classes=4, use_roi=True,
                            hidden=16, roi_emb=8, head_hidden=8)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    X = jnp.asarray(rng.standard_normal((2, 10, 12)).astype(np.float32))
    L = jnp.asarray(np.asarray([10, 7], np.int32))
    R = jnp.asarray(rng.integers(0, 256, (2, 10, 48, 96), dtype=np.uint8))
    a = np.asarray(model.live_forward(params, cfg, X, L, R))
    b = np.asarray(model.live_forward(params, cfg, X, L, R,
                                      matmul_precision="highest"))
    np.testing.assert_allclose(a, b, atol=1e-6)
