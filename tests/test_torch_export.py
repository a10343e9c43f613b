"""JAX -> PyTorch export: round-trip and reference-loader compatibility."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from silent_speech.core.torch_export import (
    export_bigru_classifier,
    export_reference_checkpoint,
)
from silent_speech.core.torch_import import import_bigru_classifier
from silent_speech.infer import Predictor
from silent_speech.models import bigru as model


def test_export_import_roundtrip(rng):
    cfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(5), cfg)
    sd = export_bigru_classifier(params)
    back = import_bigru_classifier(sd)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_exported_ckpt_runs_in_torch_model(tmp_path, rng):
    """An exported .pt loads into the reference architecture and matches our
    live forward."""
    from tests.test_model_parity import _TorchBiGRUClassifier

    cfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(6), cfg)
    labels = [f"w{i}" for i in range(10)]
    meta = dict(x_dim=180, max_t=90, use_roi=True, roi_w=96, roi_h=48,
                labels=labels,
                label_to_id={l: i for i, l in enumerate(labels)},
                id_to_label={i: l for i, l in enumerate(labels)},
                seed=42, gru_layers=2)
    path = str(tmp_path / "exported.pt")
    export_reference_checkpoint(params, meta, path)

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    tm = _TorchBiGRUClassifier(180, 10, True, standardize_roi=False)
    tm.load_state_dict(ckpt["model"])
    tm.eval()

    X = rng.standard_normal((2, 30, 180)).astype(np.float32)
    roi = rng.integers(0, 256, (2, 30, 48, 96), dtype=np.uint8)
    lengths = np.asarray([30, 17], np.int32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(X),
                 torch.from_numpy(lengths.astype(np.int64)),
                 torch.from_numpy(roi)).numpy()
    ours = np.asarray(model.live_forward(
        params, cfg, jnp.asarray(X), jnp.asarray(lengths), jnp.asarray(roi)))
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=1e-4)

    # and our own torch-ckpt loader closes the loop
    pred = Predictor.from_torch_checkpoint(path)
    top = pred.predict_arrays(X[0], roi[0], k=1)
    assert top[0][0] in labels
