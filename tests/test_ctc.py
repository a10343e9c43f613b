"""CTC loss vs torch.nn.CTCLoss; dictionary word scoring vs a from-spec
numpy port of the reference forward algorithm (inactive/train_model.py:167-189)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from silent_speech.ops.ctc import (
    ctc_loss,
    ctc_word_logprob,
    ctc_word_logprobs_batch,
    length_prior_penalty,
)


def _rand_log_probs(rng, B, T, C):
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    return np.asarray(
        F.log_softmax(torch.from_numpy(logits), dim=-1).numpy(), np.float32
    )


def _np_word_logprob(lp_tc, word_ids, blank=0):
    """Direct numpy port of the reference recursion (spec, not code)."""
    ext = [blank]
    for c in word_ids:
        ext += [c, blank]
    S, T = len(ext), lp_tc.shape[0]
    alpha = np.full(S, -1e9)
    alpha[0] = lp_tc[0, blank]
    if S > 1:
        alpha[1] = lp_tc[0, ext[1]]
    for t in range(1, T):
        prev = alpha.copy()
        for s in range(S):
            cand = [prev[s]]
            if s > 0:
                cand.append(prev[s - 1])
            if s > 1 and ext[s] != blank and ext[s] != ext[s - 2]:
                cand.append(prev[s - 2])
            alpha[s] = np.logaddexp.reduce(cand) + lp_tc[t, ext[s]]
    return np.logaddexp(alpha[-1], alpha[-2])


def test_ctc_loss_matches_torch(rng):
    B, T, C = 4, 25, 27
    lp = _rand_log_probs(rng, B, T, C)
    input_lengths = np.array([25, 18, 25, 9], np.int32)
    label_lengths = np.array([5, 3, 7, 2], np.int32)
    L = label_lengths.max()
    labels = np.zeros((B, L), np.int64)
    for b in range(B):
        labels[b, : label_lengths[b]] = rng.integers(1, C, size=label_lengths[b])

    ref = torch.nn.CTCLoss(blank=0, zero_infinity=True)(
        torch.from_numpy(lp).transpose(0, 1),
        torch.from_numpy(labels),
        torch.from_numpy(input_lengths.astype(np.int64)),
        torch.from_numpy(label_lengths.astype(np.int64)),
    ).item()

    got = ctc_loss(
        jnp.asarray(lp), jnp.asarray(input_lengths),
        jnp.asarray(labels.astype(np.int32)), jnp.asarray(label_lengths),
    )
    np.testing.assert_allclose(float(got), ref, atol=1e-4, rtol=1e-4)


def test_word_logprob_matches_reference_spec(rng):
    T, C = 30, 27
    lp = _rand_log_probs(rng, 1, T, C)[0]
    for word in [[8, 5, 12, 12, 15], [1], [3, 3, 3]]:  # incl. repeated chars
        ref = _np_word_logprob(lp, word)
        L_pad = 8
        ids = np.zeros(L_pad, np.int32)
        ids[: len(word)] = word
        got = ctc_word_logprob(
            jnp.asarray(lp), jnp.asarray(ids),
            jnp.asarray(np.int32(len(word))), jnp.asarray(np.int32(T)),
        )
        np.testing.assert_allclose(float(got), ref, atol=1e-4, rtol=1e-4)


def test_word_logprob_respects_input_length(rng):
    """Scoring a truncated clip must equal scoring lp[:T_true]."""
    T, C = 40, 27
    lp = _rand_log_probs(rng, 1, T, C)[0]
    word = [20, 5, 19]
    ids = np.zeros(6, np.int32)
    ids[:3] = word
    got = ctc_word_logprob(
        jnp.asarray(lp), jnp.asarray(ids),
        jnp.asarray(np.int32(3)), jnp.asarray(np.int32(22)),
    )
    ref = _np_word_logprob(lp[:22], word)
    np.testing.assert_allclose(float(got), ref, atol=1e-4, rtol=1e-4)


def test_dictionary_batch_scoring(rng):
    T, C = 26, 27
    lp = _rand_log_probs(rng, 1, T, C)[0]
    words = [[25, 5, 19], [14, 15], [8, 5, 12, 12, 15], [1, 21, 18, 1]]
    L = max(len(w) for w in words)
    ids = np.zeros((len(words), L), np.int32)
    lens = np.zeros(len(words), np.int32)
    for i, w in enumerate(words):
        ids[i, : len(w)] = w
        lens[i] = len(w)
    scores = ctc_word_logprobs_batch(
        jnp.asarray(lp), jnp.asarray(ids), jnp.asarray(lens),
        jnp.asarray(np.int32(T)),
    )
    for i, w in enumerate(words):
        np.testing.assert_allclose(
            float(scores[i]), _np_word_logprob(lp, w), atol=1e-4, rtol=1e-4
        )
    # length-prior penalty (inactive/train_model.py:245-248)
    pen = length_prior_penalty(scores, jnp.asarray(lens), jnp.asarray(np.int32(T)),
                               len_lambda=0.02)
    ref_pen = np.asarray(scores) - 0.02 * np.abs(T - lens * 5)
    np.testing.assert_allclose(np.asarray(pen), ref_pen, atol=1e-5)


def test_ctc_dict_chunked_equals_oneshot(rng):
    """chunk_words=N (the open-vocabulary device-memory bound) must
    reproduce the one-shot vmapped sweep exactly, including the padded
    ragged tail chunk."""
    import jax

    from silent_speech.infer.ctc_decode import CTCDecoder, Dictionary
    from silent_speech.models import ctc_model

    params = ctc_model.init_params(jax.random.PRNGKey(0), 180, hidden=16,
                                   gru_layers=2, roi_emb=4)
    words = ["yes", "no", "hello", "please", "thanks", "six", "seven",
             "lebron", "aura", "fahhh"]
    d = Dictionary.from_words(words)
    X = rng.standard_normal((20, 180)).astype(np.float32)
    X[:, -3] = 1.0  # openness channel active: silence trim keeps all frames
    R = rng.integers(0, 256, (20, 48, 96), dtype=np.uint8)

    one = CTCDecoder(params, d, max_t=24).score_clip(X, R)
    for cw in (3, 4, 10, 64):  # ragged tail, exact division, >N
        chunked = CTCDecoder(params, d, max_t=24,
                             chunk_words=cw).score_clip(X, R)
        assert [w for w, _ in chunked] == [w for w, _ in one]
        np.testing.assert_allclose([s for _, s in chunked],
                                   [s for _, s in one], rtol=1e-5, atol=1e-5)

    import pytest

    with pytest.raises(ValueError, match="chunk_words"):
        CTCDecoder(params, d, max_t=24, chunk_words=-1)


@pytest.mark.parametrize("align", [1, 8, 16, 128])
@pytest.mark.parametrize("words", [
    [[1], [2, 3], [4, 4, 5]],
    [[7, 8, 9, 10, 11, 12, 13, 14, 15], [3, 3]],
    [[20, 21, 22, 23, 24, 25, 26, 1, 2, 3, 4, 5]],
])
def test_scores_identical_across_lattice_paddings(rng, align, words):
    """Padded lattice states never reach the real ones, so every padding of
    the state axis gives the same scores as the reference spec."""
    from silent_speech.ops.ctc import _ctc_nll_single

    T, C = 30, 27
    lp = _rand_log_probs(rng, 1, T, C)[0]
    L = max(len(w) for w in words)
    ids = np.zeros((len(words), L), np.int32)
    for i, w in enumerate(words):
        ids[i, :len(w)] = w
    lens = np.asarray([len(w) for w in words], np.int32)
    lp_b = jnp.asarray(np.broadcast_to(lp, (len(words), T, C)))
    got = -np.asarray(_ctc_nll_single(
        lp_b, jnp.full((len(words),), T, jnp.int32), jnp.asarray(ids),
        jnp.asarray(lens), 0, align))
    base = -np.asarray(_ctc_nll_single(
        lp_b, jnp.full((len(words),), T, jnp.int32), jnp.asarray(ids),
        jnp.asarray(lens), 0, 1))
    np.testing.assert_array_equal(got, base)
    for i, w in enumerate(words):
        np.testing.assert_allclose(got[i], _np_word_logprob(lp, w),
                                   rtol=1e-4, atol=1e-3)


def test_lattice_pad():
    from silent_speech.ops.ctc import LATTICE_ALIGN, lattice_pad

    assert LATTICE_ALIGN == 8
    assert [lattice_pad(s) for s in (1, 7, 8, 9, 25)] == [8, 8, 8, 16, 32]
    assert lattice_pad(25, 128) == 128


@pytest.mark.parametrize("stats,want", [
    (None, 1 << 30),
    ({}, 1 << 30),
    ({"bytes_limit": 80 * 2 ** 30}, int(80 * 2 ** 30 * 0.05)),
])
def test_lattice_budget_follows_device_memory(stats, want):
    """The dictionary sweep's chunk bound is a share of the device's
    reported memory, or 1 GiB where the device reports none (the CPU)."""
    from silent_speech.infer.ctc_decode import lattice_budget_bytes

    class Dev:
        def memory_stats(self):
            return stats

    assert lattice_budget_bytes(Dev()) == want
