"""CTC: loss and dictionary word scoring, vectorized for the accelerator.

The reference uses ``nn.CTCLoss`` for training (inactive/train_model.py:222)
and a hand-written O(T*S) Python double loop for dictionary-constrained word
scoring (inactive/train_model.py:167-189 ``ctc_word_logprob``). Both are
re-implemented here as batched `lax.scan`s over time with the alpha lattice as
the carry — the per-step work is elementwise vector math, and the whole
dictionary is scored at once via ``vmap`` instead of a Python loop over words.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

NEG_INF = -1e30
# the lattice axis pads up to a multiple of this many states; padded states
# never reach the real lattice (see _ctc_alphas), so any value gives the
# same scores
LATTICE_ALIGN = 8


def lattice_pad(n_states: int, align: int = LATTICE_ALIGN) -> int:
    """Padded lattice width for ``n_states`` extended-label states."""
    return -(-n_states // align) * align


def _extend_labels(labels: jnp.ndarray, blank: int) -> jnp.ndarray:
    """(.., L) labels -> (.., 2L+1) blank-interleaved extended sequence.

    Built with stack+reshape+concat only (no strided scatter).
    """
    L = labels.shape[-1]
    blanks = jnp.full_like(labels, blank)
    inter = jnp.stack([blanks, labels], axis=-1).reshape(
        labels.shape[:-1] + (2 * L,)
    )
    tail = jnp.full(labels.shape[:-1] + (1,), blank, dtype=labels.dtype)
    return jnp.concatenate([inter, tail], axis=-1)


def _shift2(ext: jnp.ndarray, blank: int) -> jnp.ndarray:
    """ext shifted right by two states (prev-prev label), blank-filled."""
    pad = jnp.full(ext.shape[:-1] + (2,), blank, dtype=ext.dtype)
    return jnp.concatenate([pad, ext[..., :-2]], axis=-1)


def _ctc_alphas(log_probs, input_lengths, ext, allow_skip,
                align: int = LATTICE_ALIGN):
    """Run the CTC forward recursion.

    log_probs: (B, T, C) log-softmax outputs; input_lengths: (B,);
    ext: (B, S) extended labels; allow_skip: (B, S) bool.
    Returns final alpha (B, S) with per-sample time freezing.

    The emission gather for all timesteps is hoisted out of the scan into
    one one-hot matmul, and the lattice axis S pads up to a multiple of
    ``align``. Padding is sound because the recursion only moves mass toward
    higher s (shift right), so states >= S never influence the real lattice.
    """
    B, T, C = log_probs.shape
    S = ext.shape[-1]
    ext_orig_s = S
    S_pad = lattice_pad(S, align)
    if S_pad != S:
        ext = jnp.pad(ext, ((0, 0), (0, S_pad - S)))  # padded states emit class 0
        allow_skip = jnp.pad(allow_skip, ((0, 0), (0, S_pad - S)))
        S = S_pad

    # (B, S, C) one-hot of ext -> emissions (B, T, S) via one batched matmul.
    # precision=HIGHEST: the exact one-hot gather must not round the
    # log-probs (a TF32 or bf16 pass would lose ~0.1 at magnitude ~30).
    ext_onehot = jax.nn.one_hot(ext, C, dtype=log_probs.dtype)  # (B, S, C)
    emit = jnp.einsum("btc,bsc->bts", log_probs, ext_onehot,
                      precision=jax.lax.Precision.HIGHEST)  # (B, T, S)

    alpha0 = jnp.full((B, S), NEG_INF)
    alpha0 = alpha0.at[:, 0].set(emit[:, 0, 0])
    if S > 1:
        alpha0 = alpha0.at[:, 1].set(emit[:, 0, 1])

    def shift(a, k):
        pad = jnp.full((B, k), NEG_INF)
        return jnp.concatenate([pad, a[:, : S - k]], axis=-1)

    def step(alpha, inp):
        e_t, t = inp
        a0 = alpha
        a1 = shift(alpha, 1)
        a2 = jnp.where(allow_skip, shift(alpha, 2), NEG_INF)
        m = jnp.maximum(jnp.maximum(a0, a1), a2)
        m_safe = jnp.maximum(m, NEG_INF)
        new = (
            m_safe
            + jnp.log(
                jnp.exp(a0 - m_safe) + jnp.exp(a1 - m_safe) + jnp.exp(a2 - m_safe)
            )
            + e_t
        )
        new = jnp.where(m <= NEG_INF, NEG_INF, new)
        valid = (t < input_lengths)[:, None]
        return jnp.where(valid, new, alpha), None

    alpha, _ = lax.scan(
        step, alpha0,
        (emit[:, 1:].swapaxes(0, 1), jnp.arange(1, T)),
    )
    return alpha[:, : ext_orig_s]


@partial(jax.jit, static_argnames=("blank", "zero_infinity"))
def ctc_loss(
    log_probs: jnp.ndarray,
    input_lengths: jnp.ndarray,
    labels: jnp.ndarray,
    label_lengths: jnp.ndarray,
    *,
    blank: int = 0,
    zero_infinity: bool = True,
) -> jnp.ndarray:
    """Batched CTC negative log-likelihood.

    Matches ``nn.CTCLoss(reduction='mean')``: each sample's NLL is divided by
    its target length, then averaged over the batch.

    log_probs: (B, T, C) log-softmax; labels: (B, L_max) padded label ids.
    """
    nll = _ctc_nll_single(log_probs, input_lengths, labels, label_lengths,
                          blank)
    if zero_infinity:
        nll = jnp.where(jnp.isfinite(nll) & (nll < -NEG_INF), nll, 0.0)
    return jnp.mean(nll / jnp.maximum(label_lengths.astype(nll.dtype), 1.0))


@jax.jit
def ctc_word_logprob(
    log_probs_tc: jnp.ndarray,
    word_ids: jnp.ndarray,
    word_len: jnp.ndarray,
    input_length: jnp.ndarray,
    blank: int = 0,
) -> jnp.ndarray:
    """Log P(word | frames) under CTC for one word.

    Vectorized equivalent of the reference's Python double loop
    (inactive/train_model.py:167-189). ``word_ids`` may be padded to a fixed
    length; ``word_len`` gives the true length.
    """
    lp = log_probs_tc[None]  # (1, T, C)
    return -_ctc_nll_single(lp, input_length[None], word_ids[None], word_len[None], blank)[0]


def _ctc_nll_single(log_probs, input_lengths, labels, label_lengths, blank,
                    align: int = LATTICE_ALIGN):
    """Per-sample CTC NLL (B,) — THE lattice setup/readout, shared by the
    batched loss (ctc_loss) and the dictionary scorers (ctc_word_logprob,
    ctc_word_logprobs_batch). Any change to the transition rule or the
    final-state readout happens here exactly once — a second copy would let
    the training loss and the dictionary sweep silently diverge."""
    ext = _extend_labels(labels, blank)  # (B, S)
    S = ext.shape[-1]
    s_idx = jnp.arange(S)[None, :]
    prev2 = _shift2(ext, blank)
    # a label position may skip the preceding blank iff its char differs from
    # the previous char (standard CTC transition rule)
    allow_skip = (s_idx >= 2) & (ext != blank) & (ext != prev2)
    # forbid lattice states beyond each sample's true extended length
    s_valid = s_idx < (2 * label_lengths[:, None] + 1)
    alpha = _ctc_alphas(log_probs, input_lengths, ext, allow_skip, align)
    alpha = jnp.where(s_valid, alpha, NEG_INF)
    end = 2 * label_lengths  # index of final blank in ext
    a_last = jnp.take_along_axis(alpha, end[:, None], axis=-1)[:, 0]
    a_prev = jnp.take_along_axis(
        alpha, jnp.maximum(end - 1, 0)[:, None], axis=-1
    )[:, 0]
    # an empty target's only path is the final blank
    a_prev = jnp.where(label_lengths > 0, a_prev, NEG_INF)
    return -jnp.logaddexp(a_last, a_prev)


@partial(jax.jit, static_argnames=("blank",))
def ctc_word_logprobs_batch(
    log_probs_tc: jnp.ndarray,
    dict_ids: jnp.ndarray,
    dict_lens: jnp.ndarray,
    input_length: jnp.ndarray,
    blank: int = 0,
) -> jnp.ndarray:
    """Score every dictionary word against one clip at once.

    log_probs_tc: (T, C); dict_ids: (N, L_max) padded char ids; dict_lens:
    (N,). Returns (N,) log-probabilities. Replaces the reference's per-word
    Python loop (inactive/train_model.py:242-251) with a single vmapped
    lattice sweep — the whole dictionary runs in one XLA program.
    """

    def score_one(ids, ln):
        return ctc_word_logprob(log_probs_tc, ids, ln, input_length, blank)

    return jax.vmap(score_one)(dict_ids, dict_lens)


def length_prior_penalty(
    scores: jnp.ndarray,
    dict_lens: jnp.ndarray,
    input_length: jnp.ndarray,
    len_lambda: float,
    len_per_char: int = 5,
) -> jnp.ndarray:
    """Length-prior penalty applied to dictionary scores
    (inactive/train_model.py:245-248): score -= lambda * |T - len(word)*5|."""
    expect = dict_lens.astype(jnp.float32) * float(len_per_char)
    return scores - len_lambda * jnp.abs(input_length.astype(jnp.float32) - expect)
