"""GRU layers as masked `lax.scan`s — the replacement for the reference's
fused ATen `nn.GRU` + `pack_padded_sequence` machinery
(reference: train_model_official.py:261-267,301-305).

Design notes:

- The input projection for *all* timesteps is hoisted out of the scan into a
  single (B*T, D) @ (D, 3H) matmul — one large matmul instead of T small
  ones. The scan body then only carries the (B, H) @ (H, 3H) recurrent
  matmul, which is the irreducible sequential work of a GRU.
- Variable-length sequences use carry freezing instead of packing: the hidden
  state stops updating at ``lengths[i]`` and padded outputs are written as
  zeros. This reproduces PyTorch's ``pack_padded_sequence(...,
  enforce_sorted=False)`` semantics exactly (verified to <1e-4 in
  tests/test_gru_parity.py) without any host-side sorting or ragged layouts,
  which XLA cannot tile.
- The reverse direction flips each sequence *within its valid length*, runs
  the same forward masked scan, and flips back — equivalent to PyTorch's
  per-sequence backward traversal.

Gate convention matches PyTorch (r, z, n) so checkpoints can be imported by a
pure transpose (see core/torch_import.py):

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax


def flip_padded(x: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Reverse each sequence within its valid length, leaving padding in place.

    x: (B, T, ...) — lengths: (B,) int32.
    """
    B, T = x.shape[0], x.shape[1]
    j = jnp.arange(T, dtype=lengths.dtype)[None, :]  # (1, T)
    L = lengths[:, None]  # (B, 1)
    idx = jnp.where(j < L, L - 1 - j, j)  # (B, T)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return jnp.take_along_axis(x, idx, axis=1)


def gru_cell_step(h, xp_t, wh, bh):
    """One GRU step given the precomputed input projection ``xp_t = x W_i + b_i``.

    h: (B, H); xp_t: (B, 3H); wh: (H, 3H); bh: (3H,). Returns new h.
    """
    hp = jnp.dot(h, wh, preferred_element_type=h.dtype) + bh
    H = h.shape[-1]
    xr, xz, xn = xp_t[..., :H], xp_t[..., H : 2 * H], xp_t[..., 2 * H :]
    hr, hz, hn = hp[..., :H], hp[..., H : 2 * H], hp[..., 2 * H :]
    r = jax.nn.sigmoid(xr + hr)
    z = jax.nn.sigmoid(xz + hz)
    n = jnp.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_layer_single_direction(
    x: jnp.ndarray,
    lengths: jnp.ndarray,
    params: dict,
    *,
    reverse: bool = False,
    h0: Optional[jnp.ndarray] = None,
    unroll: int = 8,
):
    """Run one GRU direction over a padded batch.

    x: (B, T, D); lengths: (B,); params: {'wi': (D,3H), 'wh': (H,3H),
    'bi': (3H,), 'bh': (3H,)}.

    Returns (outputs (B, T, H), h_last (B, H)). Padded output positions are
    zero (matching ``pad_packed_sequence``); ``h_last`` is the hidden state at
    each sequence's true final frame.
    """
    if reverse:
        x = flip_padded(x, lengths)
    B, T, _ = x.shape
    H = params["wh"].shape[0]
    dtype = x.dtype

    # One big matmul for every timestep's input projection.
    xp = jnp.einsum("btd,dh->bth", x, params["wi"].astype(dtype)) + params[
        "bi"].astype(dtype)

    if h0 is None:
        h0 = jnp.zeros((B, H), dtype=dtype)
    wh = params["wh"].astype(dtype)
    bh = params["bh"].astype(dtype)
    tsteps = jnp.arange(T, dtype=lengths.dtype)

    def step(h, inp):
        xp_t, t = inp
        h_new = gru_cell_step(h, xp_t, wh, bh)
        valid = (t < lengths)[:, None]
        h_out = jnp.where(valid, h_new, h)  # freeze carry past the end
        y = jnp.where(valid, h_out, jnp.zeros_like(h_out))
        return h_out, y

    h_last, ys = lax.scan(step, h0, (xp.swapaxes(0, 1), tsteps), unroll=unroll)
    y = ys.swapaxes(0, 1)  # (B, T, H)
    if reverse:
        y = flip_padded(y, lengths)
    return y, h_last


def bigru(
    x: jnp.ndarray,
    lengths: jnp.ndarray,
    layers: list[dict],
    *,
    bidirectional: bool = True,
    dropout_rate: float = 0.0,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    unroll: int = 8,
):
    """Stacked (bi)directional GRU over a padded batch.

    ``layers`` is a list of per-layer param dicts: {'fwd': {...}, 'bwd': {...}}
    (or just {'fwd': ...} when unidirectional). Inter-layer dropout is applied
    to every layer's output except the last, as in ``nn.GRU(dropout=...)``
    (reference: train_model_official.py:261-267).

    Returns (outputs (B, T, H*dirs), h_last (B, layers*dirs*H)).
    """
    out = x
    finals = []
    n_layers = len(layers)
    for li, lp in enumerate(layers):
        y_f, h_f = gru_layer_single_direction(
            out, lengths, lp["fwd"], reverse=False, unroll=unroll,
        )
        if bidirectional:
            y_b, h_b = gru_layer_single_direction(
                out, lengths, lp["bwd"], reverse=True, unroll=unroll,
            )
            out = jnp.concatenate([y_f, y_b], axis=-1)
            finals.extend([h_f, h_b])
        else:
            out = y_f
            finals.append(h_f)
        if train and dropout_rate > 0.0 and li < n_layers - 1:
            if rng is None:
                raise ValueError("rng required for GRU dropout in train mode")
            rng, sub = jax.random.split(rng)
            keep = 1.0 - dropout_rate
            mask = jax.random.bernoulli(sub, keep, out.shape)
            out = jnp.where(mask, out / keep, 0.0).astype(out.dtype)
    return out, jnp.concatenate(finals, axis=-1)


def unidirectional_gru_chunked(
    x: jnp.ndarray,
    lengths: jnp.ndarray,
    layers: list[dict],
    *,
    chunk_size: int,
    unroll: int = 8,
):
    """Arbitrarily long sequences via chunked scans with carry hand-off.

    The idiomatic substitute for sequence parallelism in an RNN pipeline
    (SURVEY.md section 2.4): the GRU carry *is* the context, so a (B, T, D)
    stream is processed in fixed-size chunks — each chunk is one jitted scan,
    and the per-layer hidden states flow between chunks. Produces exactly the
    same outputs as a single full-length scan (tested), but the compiled
    program size and live memory are O(chunk) instead of O(T).

    Returns (outputs (B, T, H_top), final carries [per layer (B, H)]).
    """
    B, T, _ = x.shape
    n_chunks = -(-T // chunk_size)
    carries = [
        jnp.zeros((B, lp["fwd"]["wh"].shape[0]), x.dtype) for lp in layers
    ]
    outs = []
    for ci in range(n_chunks):
        s = ci * chunk_size
        xc = x[:, s : s + chunk_size]
        # lengths relative to this chunk, clamped to [0, chunk]
        lc = jnp.clip(lengths - s, 0, xc.shape[1])
        inp = xc
        new_carries = []
        for lp, h0 in zip(layers, carries):
            inp, h_last = gru_layer_single_direction(
                inp, lc, lp["fwd"], h0=h0, unroll=unroll
            )
            new_carries.append(h_last)
        carries = new_carries
        outs.append(inp)
    return jnp.concatenate(outs, axis=1)[:, :T], carries
