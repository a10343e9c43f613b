"""CTC flagship treatment: serving/training knob parity on the CTC model
(models/ctc_model.forward has the official model's matmul_precision and
compute_dtype surface), batched dictionary sweeps, and the sharded eval-ctc
path. All on the CPU backend."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from silent_speech.infer.ctc_decode import CTCDecoder, Dictionary
from silent_speech.models import ctc_model


@pytest.fixture(scope="module")
def ctc_setup():
    params = ctc_model.init_params(
        jax.random.PRNGKey(3), 180, hidden=24, gru_layers=2, roi_emb=8)
    rng = np.random.default_rng(7)
    B, T = 3, 12
    X = rng.standard_normal((B, T, 180)).astype(np.float32)
    R = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    L = np.array([12, 7, 3], np.int32)
    return params, jnp.asarray(X), jnp.asarray(R), jnp.asarray(L)


def _fwd(params, X, R, L, **kw):
    return np.asarray(ctc_model.forward(params, X, R, L, **kw))


def test_u8_input_matches_float_collate(ctc_setup):
    """Shipping raw uint8 and normalizing on-device must be bitwise the
    reference collate division (inactive/train_model.py:109)."""
    params, X, R, L = ctc_setup
    ref = _fwd(params, X, R.astype(jnp.float32) / 255.0, L)
    got = _fwd(params, X, R, L)
    np.testing.assert_array_equal(got, ref)


def test_roi_impl_parity(ctc_setup):
    """Each clip of a ragged batch gets the log-probs it gets alone (the
    frames of every clip share one conv batch); a removed kernel's setting
    raises."""
    params, X, R, L = ctc_setup
    ref = _fwd(params, X, R, L)
    for i, n in enumerate(np.asarray(L)):
        one = _fwd(params, X[i:i + 1, :n], R[i:i + 1, :n], L[i:i + 1])
        np.testing.assert_allclose(one[0], ref[i, :n], atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError, match="roi_impl"):
        _fwd(params, X, R, L, roi_impl="fused")


def test_precision_modes_and_bf16(ctc_setup):
    """'highest' is exact on the CPU backend (true-f32 matmuls already); an
    unknown mode (the removed per-site 'parity') raises; bf16 compute
    returns finite f32 log-probs."""
    params, X, R, L = ctc_setup
    ref = _fwd(params, X, R, L)
    np.testing.assert_array_equal(
        _fwd(params, X, R, L, matmul_precision="highest"), ref)
    with pytest.raises(ValueError, match="parity"):
        _fwd(params, X, R, L, matmul_precision="parity")
    lp16 = _fwd(params, X, R, L, compute_dtype=jnp.bfloat16)
    assert lp16.dtype == np.float32 and np.isfinite(lp16).all()


def _mk_decoder(params, words, **kw):
    return CTCDecoder(params, Dictionary.from_words(words), max_t=16, **kw)


def test_score_batch_matches_per_clip(ctc_setup):
    """The batched corpus sweep (eval-ctc) must reproduce the per-clip
    scores, including the chunked dictionary path."""
    params, X, R, L = ctc_setup
    words = ["yes", "no", "hello", "please", "thanks"]
    rng = np.random.default_rng(11)
    B, T = 4, 16
    Xc = rng.standard_normal((B, T, 180)).astype(np.float32)
    Xc[:, :, -3] = 1.0  # openness active: trim keeps all frames
    Rc = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)

    for cw in (0, 2):
        dec = _mk_decoder(params, words, chunk_words=cw)
        got = dec.score_batch(Xc, Rc, np.full((B,), T, np.int32))
        assert got.shape == (B, len(words))
        for b in range(B):
            per_clip = dec.score_clip(Xc[b], Rc[b])
            ref = {w: s for w, s in per_clip}
            np.testing.assert_allclose(
                got[b], [ref[w] for w in words], rtol=1e-5, atol=1e-5)


def test_ctc_decoder_sharded_sweep(ctc_setup):
    """CTCDecoder.shard over the virtual mesh: exact parity with the
    unsharded batched sweep, including the ragged pad/slice."""
    from silent_speech.parallel.mesh import mesh_from_shape

    params, X, R, L = ctc_setup
    words = ["yes", "no", "hello"]
    rng = np.random.default_rng(13)
    B, T = 5, 16  # 5 % 4 != 0: exercises the pad path
    Xc = rng.standard_normal((B, T, 180)).astype(np.float32)
    Rc = rng.integers(0, 256, (B, T, 48, 96), dtype=np.uint8)
    Lc = np.array([16, 9, 4, 12, 7], np.int32)

    ref = _mk_decoder(params, words).score_batch(Xc, Rc, Lc)
    dec = _mk_decoder(params, words).shard(mesh_from_shape({"data": 4}))
    got = dec.score_batch(Xc, Rc, Lc)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_evaluate_ctc_dataset_batched_and_sharded(tmp_path):
    """eval-ctc end-to-end on a synthetic corpus: the batched sweep scores
    every clip, and mesh_shape produces identical accuracy/confusions."""
    from silent_speech.core.config import CTCTrainConfig
    from silent_speech.data.synthetic import generate_corpus
    from silent_speech.infer.evaluator import evaluate_ctc_dataset
    from silent_speech.train import train_ctc

    corpus = tmp_path / "clips"
    generate_corpus(str(corpus), clips_per_word=3, words=["yes", "no"],
                    seed=5)
    cfg = CTCTrainConfig(
        clip_dir=str(corpus), out_path=str(tmp_path / "ctc.ckpt"),
        epochs=1, patience=1, batch_size=4, max_t=40,
        hidden=16, gru_layers=2, roi_emb=8,
    )
    train_ctc(cfg, verbose=False)

    r1 = evaluate_ctc_dataset(cfg.out_path, str(corpus), verbose=False,
                              batch_size=4)
    assert r1["n"] == 6
    r2 = evaluate_ctc_dataset(cfg.out_path, str(corpus), verbose=False,
                              batch_size=4, mesh_shape={"data": 2},
                              chunk_words=1)
    assert r2["accuracy"] == r1["accuracy"]
    assert r2["n"] == r1["n"]
    assert sorted(r2["confusions"]) == sorted(r1["confusions"])
