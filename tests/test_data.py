"""Data layer: npz round-trip, schema tolerance, splits, sampling, augmentation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from silent_speech.core.schema import (
    Clip, clip_filename, fix_dim, load_clip,
    parse_filename_label, pad_trim_time, save_clip,
)
from silent_speech.data import (
    OFFICIAL_AUGMENT, augment_batch, build_device_dataset, build_label_maps,
    epoch_batches, filter_modal_dim, inverse_frequency_weights, scan_corpus,
    split_by_label, top_confusions,
)
from silent_speech.data.augment import AugmentConfig, drop_frames, mixup, time_warp
from silent_speech.data.synthetic import generate_corpus


def test_npz_roundtrip(tmp_path, rng):
    X = rng.standard_normal((20, 180)).astype(np.float32)
    roi = rng.integers(0, 256, (18, 48, 96), dtype=np.uint8)  # shorter than X
    clip = Clip(X=X, ts=np.arange(20) * 33, label="yes", speaker="me",
                idxs=np.arange(88, dtype=np.int32), roi=roi)
    p = str(tmp_path / clip_filename("me", "yes", 123, 0))
    save_clip(clip, p)
    back = load_clip(p)
    # writer aligns X/roi to the min length (record_landmarks_official.py:245-248)
    assert back.T == 18 and back.roi.shape[0] == 18
    np.testing.assert_allclose(back.X, X[:18])
    assert back.label == "yes" and back.speaker == "me"
    assert parse_filename_label(p) == "yes"


def test_load_tolerates_missing_optional_keys(tmp_path, rng):
    X = rng.standard_normal((10, 83)).astype(np.float32)
    p = str(tmp_path / "me_no_1_0001.npz")
    np.savez_compressed(p, X=X, label="no")
    c = load_clip(p)
    assert c.roi is None and c.idxs is None and c.T == 10
    # label can come from the filename when absent entirely
    p2 = str(tmp_path / "me_hello_1_0002.npz")
    np.savez_compressed(p2, X=X)
    assert load_clip(p2).label == "hello"


def test_save_rejects_too_short(tmp_path, rng):
    X = rng.standard_normal((4, 180)).astype(np.float32)
    clip = Clip(X=X, ts=np.arange(4), label="yes", speaker="s")
    with pytest.raises(ValueError):
        save_clip(clip, str(tmp_path / "x.npz"))


def test_pad_trim_and_fix_dim(rng):
    X = rng.standard_normal((100, 180)).astype(np.float32)
    Xt, L = pad_trim_time(X, 90)
    assert Xt.shape == (90, 180) and L == 90
    Xp, L2 = pad_trim_time(X[:30], 90)
    assert Xp.shape == (90, 180) and L2 == 30 and (Xp[30:] == 0).all()
    assert fix_dim(X, 200).shape == (100, 200)
    assert fix_dim(X, 100).shape == (100, 100)


def test_scan_filter_split_semantics(tmp_path):
    generate_corpus(str(tmp_path), clips_per_word=8, with_roi=True, seed=1)
    # add two odd-dim clips that the modal filter must remove
    for i in range(2):
        np.savez_compressed(
            str(tmp_path / f"me_yes_9_{900+i:04d}.npz"),
            X=np.zeros((12, 83), np.float32), label="yes")
    idx = scan_corpus(str(tmp_path), verbose=False)
    assert len(idx.files) == 82
    filtered, x_dim = filter_modal_dim(idx, verbose=False)
    assert x_dim == 180 and len(filtered.files) == 80

    tr, va = split_by_label(filtered.files, filtered.labels, 0.15, seed=42,
                            verbose=False)
    assert len(tr) + len(va) == 80
    # per label: 8 clips -> n_val = max(1, round(1.2)) = 1
    assert len(va) == 10
    tr2, va2 = split_by_label(filtered.files, filtered.labels, 0.15, seed=42,
                              verbose=False)
    assert tr == tr2 and va == va2  # pinned-seed determinism


def test_weighted_sampling_balances(rng):
    labels = ["a"] * 90 + ["b"] * 10
    w = inverse_frequency_weights(labels)
    counts = {"a": 0, "b": 0}
    for idx in epoch_batches(100, 20, rng, weights=w):
        for i in idx:
            counts[labels[i]] += 1
    # inverse-frequency sampling should roughly equalize classes
    assert 0.5 < counts["a"] / max(counts["b"], 1) < 2.0


def test_device_dataset_and_batching(tmp_path):
    generate_corpus(str(tmp_path), clips_per_word=3, seed=2)
    idx = scan_corpus(str(tmp_path), verbose=False)
    l2i, i2l = build_label_maps(idx.labels)
    ds = build_device_dataset(idx.files, l2i, max_t=90, use_roi=True)
    assert ds.X.shape == (30, 90, 180) and ds.roi.shape == (30, 90, 48, 96)
    X, L, R, y = ds.gather(jnp.asarray(np.arange(4)))
    assert X.shape == (4, 90, 180) and int(L.max()) <= 90

    batches = list(epoch_batches(30, 8, np.random.default_rng(0)))
    assert all(len(b) == 8 for b in batches)  # final batch padded by wrapping
    assert len(batches) == 4


def test_augment_official_invariants(rng):
    key = jax.random.PRNGKey(0)
    B, T, D = 8, 40, 12
    X = np.zeros((B, T, D), np.float32)
    lengths = np.asarray([40, 30, 25, 20, 16, 13, 12, 8], np.int32)
    for b in range(B):
        X[b, : lengths[b]] = rng.standard_normal((lengths[b], D))
    Xa, La = augment_batch(key, jnp.asarray(X), jnp.asarray(lengths), OFFICIAL_AUGMENT)
    Xa, La = np.asarray(Xa), np.asarray(La)
    # lengths never grow; drop at most drop_max; short clips untouched
    assert (La <= lengths).all() and (lengths - La <= 2).all()
    assert (La[lengths <= 12] == lengths[lengths <= 12]).all()
    # padding stays zero
    for b in range(B):
        if La[b] < T:
            assert np.abs(Xa[b, La[b]:]).max() == 0.0


def test_drop_frames_keeps_boundary_frames(rng):
    """Reference drops only interior frames (np.arange(1, T-1))."""
    key = jax.random.PRNGKey(3)
    T = 20
    X = np.arange(T, dtype=np.float32)[None, :, None].repeat(4, axis=0)
    lengths = np.full((4,), T, np.int32)
    cfg = AugmentConfig(drop_prob=1.0, drop_max=2, drop_min_t=12, noise_prob=0)
    Xd, Ld = drop_frames(key, jnp.asarray(X), jnp.asarray(lengths), cfg)
    Xd, Ld = np.asarray(Xd), np.asarray(Ld)
    for b in range(4):
        assert Xd[b, 0, 0] == 0.0  # frame 0 kept (value 0)
        assert Xd[b, Ld[b] - 1, 0] == T - 1  # last frame kept
        vals = Xd[b, : Ld[b], 0]
        assert (np.diff(vals) > 0).all()  # order preserved


def test_drop_frames_clamps_to_eligible(rng):
    """A config whose drop_max approaches drop_min_t (legal on the public
    AugmentConfig surface) must never drop ineligible/padding frames or
    drive new_len to 0/negative — k clamps to the eligible count."""
    key = jax.random.PRNGKey(7)
    T = 16
    X = np.arange(T, dtype=np.float32)[None, :, None].repeat(8, 0) + 1.0
    lengths = np.asarray([4, 5, 6, 4, 5, 6, 4, 5], np.int32)
    cfg = AugmentConfig(drop_prob=1.0, drop_max=4, drop_min_t=3, noise_prob=0)
    Xd, Ld = drop_frames(key, jnp.asarray(X), jnp.asarray(lengths), cfg)
    Xd, Ld = np.asarray(Xd), np.asarray(Ld)
    assert (Ld >= 2).all()  # interior-only keeps both endpoints
    for b in range(8):
        assert Xd[b, 0, 0] == 1.0  # first frame kept
        assert Xd[b, Ld[b] - 1, 0] == float(lengths[b])  # last frame kept
        assert not Xd[b, Ld[b]:].any()  # padding stays zero


def test_time_warp_and_mixup(rng):
    key = jax.random.PRNGKey(4)
    B, T, D = 4, 50, 6
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.asarray([50, 40, 30, 20], np.int32)
    cfg = AugmentConfig(time_warp_prob=1.0)
    Xw, Lw = time_warp(key, jnp.asarray(X), jnp.asarray(lengths), cfg)
    Lw = np.asarray(Lw)
    assert (Lw >= 5).all() and (Lw <= T).all()

    y = jax.nn.one_hot(jnp.asarray([0, 1, 2, 3]), 4)
    Xm, ym = mixup(key, jnp.asarray(X), y, alpha=0.2)
    np.testing.assert_allclose(np.asarray(ym).sum(-1), 1.0, atol=1e-5)


def test_top_confusions_format():
    out = top_confusions([0, 0, 1, 2], [1, 1, 1, 0], {0: "a", 1: "b", 2: "c"})
    assert out[0] == "a→b(2)" and "c→a(1)" in out


def test_time_warp_slowdown_stretches_then_truncates(rng):
    """scale > 1 on a full-length clip must reproduce the reference's
    stretch-then-truncate (linspace to int(T*scale) samples, keep the first
    max_t) — not degenerate to the identity (round-2 review fix)."""
    key = jax.random.PRNGKey(5)
    B, T, D = 2, 60, 3
    X = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.full((B,), T, np.int32)
    cfg = AugmentConfig(time_warp_prob=1.0, time_warp_lo=1.2, time_warp_hi=1.2)
    Xw, Lw = time_warp(key, jnp.asarray(X), jnp.asarray(lengths), cfg)
    Xw, Lw = np.asarray(Xw), np.asarray(Lw)
    assert (Lw == T).all()
    # reference mapping: warp_len = int(60*1.2) = 72; element j of the
    # warped stream = X[int(j*(60-1)/(72-1))]; we keep the first 60
    warp_len = int(T * 1.2)
    src = (np.arange(T) * (T - 1) / (warp_len - 1)).astype(np.int32)
    for b in range(B):
        np.testing.assert_allclose(Xw[b], X[b][src], atol=1e-6)
    assert not np.allclose(Xw[0], X[0])  # genuinely warped


def test_drop_frames_all_positions_for_reduced(rng):
    """REDUCED_AUGMENT samples drops from every position (incl. endpoints),
    as random.sample(range(T)) in train_reduced.py:112-114."""
    from silent_speech.data.augment import REDUCED_AUGMENT
    import dataclasses as _dc

    T = 20
    X = np.arange(T, dtype=np.float32)[None, :, None].repeat(64, axis=0)
    lengths = np.full((64,), T, np.int32)
    cfg = _dc.replace(REDUCED_AUGMENT, drop_prob=1.0, drop_max=3)
    Xd, Ld = drop_frames(jax.random.PRNGKey(7), jnp.asarray(X),
                         jnp.asarray(lengths), cfg)
    Xd, Ld = np.asarray(Xd), np.asarray(Ld)
    first_dropped = sum(Xd[b, 0, 0] != 0.0 for b in range(64))
    last_dropped = sum(Xd[b, Ld[b] - 1, 0] != T - 1 for b in range(64))
    assert first_dropped > 0 and last_dropped > 0  # endpoints do get dropped


def test_mixup_alpha_zero_is_identity(rng):
    from silent_speech.data.augment import mixup as _mixup

    X = jnp.asarray(rng.standard_normal((4, 10, 6)).astype(np.float32))
    y = jax.nn.one_hot(jnp.asarray([0, 1, 2, 3]), 4)
    Xm, ym = _mixup(jax.random.PRNGKey(0), X, y, alpha=0.0)
    np.testing.assert_array_equal(np.asarray(Xm), np.asarray(X))
    np.testing.assert_array_equal(np.asarray(ym), np.asarray(y))
