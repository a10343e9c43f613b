"""bf16 serving-mode guardrail.

BASELINE.md advertises a bfloat16 serving mode (~44.7k clips/s). This pins its
fidelity contract on a *trained* checkpoint: the bf16 live forward must agree
with f32 on argmax for every corpus clip, and logits must stay within a stated
tolerance. A silent bf16 numerical regression now fails CI instead of only
showing up as wrong words on camera.
"""

import numpy as np

import jax.numpy as jnp
import pytest

from silent_speech.core.config import TrainConfig
from silent_speech.data.synthetic import generate_corpus
from silent_speech.infer.predictor import Predictor
from silent_speech.models import bigru as model
from silent_speech.train import train

# bf16 has ~8 bits of mantissa; on this 10-logit head the observed drift on a
# trained model is <0.1 (CPU backend and on-chip alike). 0.15 = observed
# ceiling + 50% slack — a regression to 0.2+ now fails loudly instead of
# hiding under the old 0.35 blanket.
LOGIT_TOL = 0.15


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bf16")
    corpus = tmp / "clips_npz"
    generate_corpus(str(corpus), clips_per_word=5,
                    words=["yes", "no", "hello", "thanks", "please"], seed=11)
    cfg = TrainConfig(
        clip_dir=str(corpus), out_path=str(tmp / "m.ckpt"),
        epochs=8, patience=8, batch_size=10, max_t=48, lr=1e-3,
    )
    result = train(cfg, verbose=False)
    return result, str(corpus), str(tmp / "m.ckpt")


def _corpus_batch(corpus, mcfg, max_t):
    from silent_speech.core.schema import load_clip
    from silent_speech.data.corpus import scan_corpus

    index = scan_corpus(corpus, verbose=False)
    Xs, Ls, Rs = [], [], []
    for f in index.files:
        c = load_clip(f).aligned()
        T = min(c.T, max_t)
        Xp = np.zeros((max_t, mcfg.x_dim), np.float32)
        Xp[:T] = c.X[:T]
        Rp = np.zeros((max_t, mcfg.roi_h, mcfg.roi_w), np.uint8)
        if c.roi is not None:
            Rp[:T] = c.roi[:T]
        Xs.append(Xp)
        Ls.append(T)
        Rs.append(Rp)
    return np.stack(Xs), np.asarray(Ls, np.int32), np.stack(Rs)


def test_bf16_live_forward_matches_f32_on_trained_model(trained):
    result, corpus, _ = trained
    params, mcfg = result["params"], result["model_config"]
    X, L, R = _corpus_batch(corpus, mcfg, max_t=48)

    f32 = np.asarray(model.live_forward(
        params, mcfg, jnp.asarray(X), jnp.asarray(L), jnp.asarray(R)))
    bf16 = np.asarray(model.live_forward(
        params, mcfg, jnp.asarray(X), jnp.asarray(L), jnp.asarray(R),
        compute_dtype=jnp.bfloat16))

    assert bf16.dtype == np.float32  # logits come back f32 regardless
    np.testing.assert_array_equal(f32.argmax(-1), bf16.argmax(-1))
    drift = np.abs(f32 - bf16).max()
    assert drift < LOGIT_TOL, f"bf16 logit drift {drift:.3f} > {LOGIT_TOL}"


def test_predictor_bf16_serving_mode(trained):
    """Predictor(compute_dtype='bfloat16') is the supported serving switch."""
    _, corpus, ckpt = trained
    p32 = Predictor.from_checkpoint(ckpt)
    p16 = Predictor.from_checkpoint(ckpt, compute_dtype="bfloat16")
    X, L, R = _corpus_batch(corpus, p32.cfg, max_t=p32.max_t)
    a = p32.predict_batch(X, L, R)
    b = p16.predict_batch(X, L, R)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    assert np.abs(a - b).max() < LOGIT_TOL
