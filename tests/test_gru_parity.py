"""Golden parity: masked-scan GRU vs PyTorch packed nn.GRU.

This is the main parity risk of the rebuild (SURVEY.md section 7.3 item 1):
``pack_padded_sequence(..., enforce_sorted=False)`` excludes padded frames
from the recurrence; our masked scan must freeze the carry at lengths[i] and
zero padded outputs to match bit-for-bit (to fp32 tolerance).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from silent_speech.core.torch_import import import_gru_stack
from silent_speech.ops.gru import bigru, flip_padded, gru_layer_single_direction


def _torch_packed_gru(tgru, x, lengths):
    packed = nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x), torch.from_numpy(lengths.astype(np.int64)),
        batch_first=True, enforce_sorted=False,
    )
    out_packed, h_n = tgru(packed)
    out, _ = nn.utils.rnn.pad_packed_sequence(
        out_packed, batch_first=True, total_length=x.shape[1]
    )
    return out.detach().numpy(), h_n.detach().numpy()


@pytest.mark.parametrize("bidirectional", [False, True])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_gru_matches_torch_packed(bidirectional, num_layers, rng):
    B, T, D, H = 5, 17, 12, 24
    torch.manual_seed(0)
    tgru = nn.GRU(D, H, num_layers=num_layers, batch_first=True,
                  bidirectional=bidirectional, dropout=0.0)
    tgru.eval()

    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([17, 3, 9, 1, 13], dtype=np.int32)

    t_out, _ = _torch_packed_gru(tgru, x, lengths)

    sd = {f"gru.{k}": v for k, v in tgru.state_dict().items()}
    layers = import_gru_stack(sd, "gru", num_layers, bidirectional)

    j_out, _ = bigru(
        jnp.asarray(x), jnp.asarray(lengths), layers,
        bidirectional=bidirectional, train=False,
    )
    np.testing.assert_allclose(np.asarray(j_out), t_out, atol=2e-5, rtol=1e-4)


def test_single_direction_final_state(rng):
    """h_last must be the hidden state at each sequence's true last frame."""
    B, T, D, H = 4, 11, 6, 8
    torch.manual_seed(1)
    tgru = nn.GRU(D, H, num_layers=1, batch_first=True)
    tgru.eval()
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([11, 4, 7, 2], dtype=np.int32)
    _, h_n = _torch_packed_gru(tgru, x, lengths)  # (1, B, H)

    sd = {f"gru.{k}": v for k, v in tgru.state_dict().items()}
    params = import_gru_stack(sd, "gru", 1, bidirectional=False)[0]["fwd"]
    _, h_last = gru_layer_single_direction(jnp.asarray(x), jnp.asarray(lengths), params)
    np.testing.assert_allclose(np.asarray(h_last), h_n[0], atol=2e-5, rtol=1e-4)


def test_flip_padded_roundtrip(rng):
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    lengths = np.array([10, 5, 1], dtype=np.int32)
    y = flip_padded(jnp.asarray(x), jnp.asarray(lengths))
    z = flip_padded(y, jnp.asarray(lengths))
    np.testing.assert_allclose(np.asarray(z), x)
    # row 1: first 5 reversed, tail untouched
    np.testing.assert_allclose(np.asarray(y)[1, :5], x[1, :5][::-1])
    np.testing.assert_allclose(np.asarray(y)[1, 5:], x[1, 5:])


def test_padded_outputs_are_zero(rng):
    B, T, D, H = 2, 8, 5, 7
    torch.manual_seed(2)
    tgru = nn.GRU(D, H, num_layers=1, batch_first=True, bidirectional=True)
    sd = {f"gru.{k}": v for k, v in tgru.state_dict().items()}
    layers = import_gru_stack(sd, "gru", 1, bidirectional=True)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([8, 3], dtype=np.int32)
    out, _ = bigru(jnp.asarray(x), jnp.asarray(lengths), layers)
    np.testing.assert_allclose(np.asarray(out)[1, 3:], 0.0)


def test_chunked_equals_full_scan(rng):
    """Chunked carry hand-off == one full-length scan (long-context path)."""
    from silent_speech.ops.gru import unidirectional_gru_chunked
    from silent_speech.ops.nn import gru_dir_init
    import jax

    B, T, D, H = 3, 50, 8, 16
    layers = [
        {"fwd": gru_dir_init(jax.random.PRNGKey(0), D, H)},
        {"fwd": gru_dir_init(jax.random.PRNGKey(1), H, H)},
    ]
    x = jnp.asarray(rng.standard_normal((B, T, D)).astype(np.float32))
    lengths = jnp.asarray(np.array([50, 23, 7], np.int32))

    full, _ = bigru(x, lengths, layers, bidirectional=False)
    for chunk in (7, 16, 50, 64):
        got, carries = unidirectional_gru_chunked(
            x, lengths, layers, chunk_size=chunk)
        np.testing.assert_allclose(np.asarray(got), np.asarray(full),
                                   atol=1e-5, err_msg=f"chunk={chunk}")
        assert len(carries) == 2


def test_gru_parity_random_config_sweep(rng):
    """Randomized shape sweep: masked-scan GRU vs torch across 8 random
    (layers, hidden, D, B, T, bidirectional) configurations."""
    import torch

    from silent_speech.core.torch_import import import_gru_stack

    r = np.random.default_rng(123)
    for _ in range(8):
        L = int(r.integers(1, 4))
        H = int(r.integers(3, 40))
        D = int(r.integers(2, 50))
        B = int(r.integers(1, 7))
        T = int(r.integers(2, 20))
        bidir = bool(r.integers(0, 2))
        torch.manual_seed(int(r.integers(0, 10_000)))
        tg = torch.nn.GRU(D, H, num_layers=L, batch_first=True,
                          bidirectional=bidir)
        sd = {f"gru.{k}": v for k, v in tg.state_dict().items()}
        params = import_gru_stack(sd, "gru", L, bidir)
        X = r.standard_normal((B, T, D)).astype(np.float32)
        lengths = r.integers(1, T + 1, B).astype(np.int32)
        lengths[0] = T

        packed = torch.nn.utils.rnn.pack_padded_sequence(
            torch.from_numpy(X), torch.from_numpy(lengths.astype(np.int64)),
            batch_first=True, enforce_sorted=False)
        out_p, _ = tg(packed)
        ref, _ = torch.nn.utils.rnn.pad_packed_sequence(
            out_p, batch_first=True, total_length=T)

        ours, _ = bigru(jnp.asarray(X), jnp.asarray(lengths), params,
                        bidirectional=bidir)
        np.testing.assert_allclose(np.asarray(ours), ref.detach().numpy(),
                                   atol=2e-4, rtol=1e-4)
