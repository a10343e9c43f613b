"""CTC dictionary decoding — the open-vocabulary inference path.

Reference flow (inactive/facial_landmark_detection.py:285-394): on clip end,
trim silence by the openness channel, run the CTC model, then score every
dictionary word with the CTC forward algorithm plus a length prior and pick
the argmax. The reference's per-word Python double loop (O(T*S) each) becomes
one vmapped lattice sweep over the whole padded dictionary.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import ctc_model
from ..ops.ctc import (ctc_word_logprobs_batch, lattice_pad,
                       length_prior_penalty)


def trim_silence(
    X: np.ndarray,
    R: Optional[np.ndarray],
    *,
    open_idx: int = -3,
    thresh: float = 0.05,
    pad: int = 2,
):
    """Trim leading/trailing frames whose openness channel is below thresh
    (inactive/train_model.py:48-57). open_idx=-3 addresses the
    mouth_open_px scalar in the official 180-D layout."""
    if len(X) == 0:
        return X, R
    o = X[:, open_idx]
    active = np.where(o > thresh)[0]
    if len(active) == 0:
        return X, R
    s = max(0, active[0] - pad)
    e = min(len(X), active[-1] + pad + 1)
    return X[s:e], None if R is None else R[s:e]


@dataclasses.dataclass
class Dictionary:
    """A padded id-encoded word list for batch scoring."""

    words: list[str]
    ids: np.ndarray  # (N, L_max) int32
    lens: np.ndarray  # (N,) int32

    @classmethod
    def from_words(cls, words: list[str]) -> "Dictionary":
        texts = [ctc_model.normalize_label(w) for w in words]
        encoded = [ctc_model.encode_text(t) for t in texts]
        L = max(len(e) for e in encoded)
        ids = np.zeros((len(words), L), np.int32)
        lens = np.zeros(len(words), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            lens[i] = len(e)
        return cls(words=list(words), ids=ids, lens=lens)


# share of the device's memory the dictionary sweep's lattice may take, and
# the bound where the device reports no limit (the CPU)
LATTICE_MEMORY_SHARE = 0.05
LATTICE_DEFAULT_BYTES = 1 << 30


def lattice_budget_bytes(device=None) -> int:
    """Bytes the batched lattice sweep may allocate on ``device`` (default:
    the first device): a share of its ``memory_stats()['bytes_limit']``
    where it reports one, else LATTICE_DEFAULT_BYTES."""
    device = device or jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return LATTICE_DEFAULT_BYTES
    return int(limit * LATTICE_MEMORY_SHARE)


class CTCDecoder:
    """Dictionary-constrained decoder over a BiGRU-CTC model."""

    def __init__(
        self,
        params: dict,
        dictionary: Dictionary,
        *,
        max_t: int = 80,
        len_lambda: float = 0.02,
        len_per_char: int = 5,
        trim_open_idx: int = -3,
        trim_thresh: float = 0.05,
        trim_pad: int = 2,
        chunk_words: int = 0,
        compute_dtype: str = "float32",
        matmul_precision=ctc_model.SERVING_PRECISION,
    ):
        """``chunk_words``: score the dictionary in fixed-size chunks instead
        of one vmapped sweep — the lattice allocation drops from
        (N, T, S_pad) f32 to (chunk, T, S_pad), bounding device memory for
        open-vocabulary (10k+) dictionaries. 0 = one-shot (fastest at small
        N). Chunked scores are identical to the one-shot sweep
        (tests/test_ctc.py).

        The serving knobs mirror infer.Predictor: ``matmul_precision``
        defaults to the serving precision (models/bigru.SERVING_PRECISION)."""
        self.params = params
        self.dict = dictionary
        self.max_t = max_t
        self.len_lambda = len_lambda
        self.len_per_char = len_per_char
        self.chunk_words = int(chunk_words)
        if self.chunk_words < 0:
            raise ValueError(
                f"chunk_words must be >= 0 (0 = one-shot sweep), got "
                f"{self.chunk_words}"
            )
        self.trim_kw = dict(open_idx=trim_open_idx, thresh=trim_thresh, pad=trim_pad)
        self._fwd_kw = dict(compute_dtype=jnp.dtype(compute_dtype),
                            matmul_precision=matmul_precision)
        self._logprobs = self._make_logprobs()

        len_lambda_ = self.len_lambda
        len_per_char_ = self.len_per_char

        @jax.jit
        def _chunk_scores(lp, T, ids, lens):
            # whole batch x one word chunk in one program — the corpus-sweep
            # counterpart of the trainer's vmapped validation
            # (train/ctc_loop.py), chunked so the (B, n, T, S) lattice
            # footprint stays bounded
            def one(lp_i, T_i):
                s = ctc_word_logprobs_batch(lp_i, ids, lens, T_i)
                if len_lambda_ > 0:
                    s = length_prior_penalty(
                        s, lens, T_i, len_lambda_, len_per_char_)
                return s

            return jax.vmap(one)(lp, T)

        self._chunk_scores = _chunk_scores

    def score_clip(self, X: np.ndarray, roi: np.ndarray) -> list[tuple[str, float]]:
        """X: (T, D) f32; roi: (T, H, W) uint8. Returns (word, score) sorted
        best-first, scores including the length prior."""
        X, roi = trim_silence(np.asarray(X, np.float32), np.asarray(roi),
                              **self.trim_kw)
        T = min(len(X), self.max_t)
        if T == 0:
            return []
        Xp = np.zeros((self.max_t, X.shape[1]), np.float32)
        Xp[:T] = X[:T]
        # ship the raw uint8 frames; the forward normalizes (/255) on-device
        # — bitwise the collate division, 4x less transfer
        Rp = np.zeros((self.max_t,) + roi.shape[1:], np.uint8)
        Rp[:T] = roi[:T]
        lp = self._logprobs(
            self.params, jnp.asarray(Xp[None]), jnp.asarray(Rp[None]),
            jnp.asarray(np.asarray([T], np.int32)),
        )[0]
        scores = self._dict_scores(lp, T)
        if self.len_lambda > 0:
            scores = length_prior_penalty(
                scores, jnp.asarray(self.dict.lens), jnp.asarray(np.int32(T)),
                self.len_lambda, self.len_per_char,
            )
        s = np.asarray(scores)
        order = np.argsort(s)[::-1]
        return [(self.dict.words[i], float(s[i])) for i in order]

    def _dict_scores(self, lp, T: int):
        """One-shot or chunked dictionary sweep (identical results)."""
        N = len(self.dict.words)
        cw = self.chunk_words
        Tj = jnp.asarray(np.int32(T))
        if not cw or N <= cw:
            return ctc_word_logprobs_batch(
                lp, jnp.asarray(self.dict.ids), jnp.asarray(self.dict.lens),
                Tj,
            )
        outs = []
        for s0 in range(0, N, cw):
            ids = self.dict.ids[s0:s0 + cw]
            lens = self.dict.lens[s0:s0 + cw]
            n = len(ids)
            if n < cw:
                # pad the ragged tail to the fixed chunk shape so every
                # chunk hits the same jit cache entry
                ids = np.concatenate(
                    [ids, np.zeros((cw - n, ids.shape[1]), np.int32)])
                lens = np.concatenate([lens, np.ones(cw - n, np.int32)])
            sc = ctc_word_logprobs_batch(
                lp, jnp.asarray(ids), jnp.asarray(lens), Tj)
            outs.append(np.asarray(sc)[:n])
        return jnp.asarray(np.concatenate(outs))

    def _make_logprobs(self, batch_sharding=None):
        fwd_kw = self._fwd_kw

        @jax.jit
        def _logprobs(params, X, roi, lengths):
            if batch_sharding is not None:
                X = jax.lax.with_sharding_constraint(X, batch_sharding)
            return ctc_model.forward(params, X, roi, lengths, **fwd_kw)

        return _logprobs

    def predict(self, X: np.ndarray, roi: np.ndarray) -> Optional[str]:
        ranked = self.score_clip(X, roi)
        return ranked[0][0] if ranked else None

    def shard(self, mesh) -> "CTCDecoder":
        """Serve the batched sweep over a device mesh: params replicate,
        batches shard their leading axis (GSPMD inserts the collectives).
        Ragged batches pad to the data-axis multiple and slice back — the
        ``eval-ctc mesh_shape={'data':N}`` path (mirrors Predictor.shard)."""
        import math

        from jax.sharding import NamedSharding

        from ..parallel.mesh import (batch_spec, put_global,
                                     replicated_specs, shard_params)

        self.params = shard_params(
            self.params, mesh, replicated_specs(self.params))
        bspec = batch_spec(mesh)
        logprobs = self._make_logprobs(NamedSharding(mesh, bspec))

        def run(params, X, roi, lengths):
            return logprobs(params, put_global(X, mesh, bspec),
                            put_global(roi, mesh, bspec),
                            put_global(lengths, mesh, bspec))

        n_data = math.prod(
            n for a, n in zip(mesh.axis_names, mesh.devices.shape)
            if a != "model"
        )

        def fwd(params, X, roi, lengths):
            B = X.shape[0]
            pad = (-B) % n_data
            if pad:
                X = jnp.concatenate([X, jnp.zeros((pad,) + X.shape[1:],
                                                  X.dtype)])
                roi = jnp.concatenate(
                    [roi, jnp.zeros((pad,) + roi.shape[1:], roi.dtype)])
                lengths = jnp.concatenate(
                    [lengths, jnp.ones((pad,), lengths.dtype)])
            return run(params, X, roi, lengths)[:B]

        self._logprobs = fwd
        return self

    def score_batch(
        self, X: np.ndarray, roi: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        """Batched dictionary scores for already trimmed+padded clips:
        X (B, max_t, D) f32, roi (B, max_t, H, W) uint8, lengths (B,) i32
        -> (B, n_words) scores including the length prior. One batched
        forward + one vmapped lattice sweep per word chunk (chunk_words
        bounds the lattice memory exactly as in the per-clip path)."""
        lp = self._logprobs(
            self.params, jnp.asarray(X), jnp.asarray(roi),
            jnp.asarray(lengths))
        Tj = jnp.asarray(lengths, jnp.int32)
        N = len(self.dict.words)
        # The lattice hoists emissions to one (clips, words, T, S_pad) f32
        # tensor (ops/ctc._ctc_alphas); batched over clips that grows as
        # B*N. Bound it to a share of the device's memory by auto-chunking
        # the dictionary. A user chunk_words only ever tightens the bound.
        B = len(lp)
        s_pad = lattice_pad(2 * self.dict.ids.shape[1] + 1)
        cw_auto = max(1, int(lattice_budget_bytes()
                             / (B * self.max_t * s_pad * 4)))
        cw = min(self.chunk_words or N, cw_auto)
        outs = []
        for s0 in range(0, N, cw):
            ids = self.dict.ids[s0:s0 + cw]
            lens = self.dict.lens[s0:s0 + cw]
            n = len(ids)
            if n < cw:
                # pad the ragged tail to the fixed chunk shape so every
                # chunk hits the same jit cache entry
                ids = np.concatenate(
                    [ids, np.zeros((cw - n, ids.shape[1]), np.int32)])
                lens = np.concatenate([lens, np.ones(cw - n, np.int32)])
            sc = self._chunk_scores(
                lp, Tj, jnp.asarray(ids), jnp.asarray(lens))
            outs.append(np.asarray(sc)[:, :n])
        return np.concatenate(outs, axis=1)
