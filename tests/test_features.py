"""Batched feature extraction vs the sequential per-frame reference semantics."""

import numpy as np

import jax.numpy as jnp

from silent_speech.core.landmarks import FEATURE_DIM, LIP_ORDER
from silent_speech.ops.features import (
    extract_features_batched,
    extract_features_frame,
    lip83_features_batched,
    mouth_width,
)


def _random_landmarks(rng, B, T):
    # normalized coords roughly in face-ish range
    return (0.2 + 0.6 * rng.random((B, T, 468, 3))).astype(np.float32)


def test_batched_matches_frame_loop(rng):
    """The batched kernel must reproduce the sequential host loop exactly,
    including vel[0] = 0."""
    B, T, W, H = 2, 9, 640, 480
    lms = _random_landmarks(rng, B, T)
    feats, centers, mw = extract_features_batched(jnp.asarray(lms), W, H)
    assert feats.shape == (B, T, FEATURE_DIM)

    for b in range(B):
        prev = None
        for t in range(T):
            ref, prev, c_ref, mw_ref = extract_features_frame(lms[b, t], W, H, prev)
            np.testing.assert_allclose(np.asarray(feats)[b, t], ref, atol=2e-4, rtol=1e-4)
            np.testing.assert_allclose(np.asarray(centers)[b, t], c_ref, atol=1e-2)
            np.testing.assert_allclose(np.asarray(mw)[b, t], mw_ref, atol=1e-2)


def test_velocity_resets_at_gate_breaks(rng):
    """vel must be 0 on the first frame and whenever the previous frame was
    out of the distance band (record_landmarks_official.py:85-88,199-201)."""
    B, T, W, H = 1, 8, 640, 480
    lms = _random_landmarks(rng, B, T)
    valid = np.array([[True, True, False, True, True, True, False, False]])
    feats, _, _ = extract_features_batched(jnp.asarray(lms), W, H, jnp.asarray(valid))
    vel = np.asarray(feats)[0, :, 2 * 88]  # first scalar after the 176 coords
    assert vel[0] == 0.0
    assert vel[2] == 0.0  # frame invalid
    assert vel[3] == 0.0  # previous frame invalid -> reset
    assert vel[4] > 0.0 and vel[5] > 0.0
    assert vel[6] == 0.0 and vel[7] == 0.0


def test_mouth_width_matches_norm(rng):
    lms = _random_landmarks(rng, 1, 1)[..., :2] * np.asarray([640.0, 480.0])
    mw = mouth_width(jnp.asarray(lms))
    ref = np.linalg.norm(lms[0, 0, 61] - lms[0, 0, 291])
    np.testing.assert_allclose(np.asarray(mw)[0, 0], ref, rtol=1e-5)


def test_lip83_matches_reference_formula(rng):
    """83-D streaming features (inactive/live_feed.py:57-86), normalized coords."""
    lms = _random_landmarks(rng, 1, 3)
    feats, openness = lip83_features_batched(jnp.asarray(lms))
    assert feats.shape == (1, 3, 83)

    xy = lms[0, 0, :, :2]
    pts = xy[np.asarray(LIP_ORDER)]
    center = pts.mean(0, keepdims=True)
    mw = np.linalg.norm(xy[291] - xy[61]) + 1e-6
    feat80 = ((pts - center) / mw).reshape(-1)
    open_ref = np.linalg.norm(xy[13] - xy[14]) / mw
    height = np.linalg.norm(xy[0] - xy[17]) / mw
    corner = np.linalg.norm(xy[61] - xy[291]) / mw - 1.0
    ref = np.concatenate([feat80, [open_ref, height, corner]])
    np.testing.assert_allclose(np.asarray(feats)[0, 0], ref, atol=1e-5)
    np.testing.assert_allclose(np.asarray(openness)[0, 0], open_ref, atol=1e-6)


def test_lip83_host_frame_matches_batched(rng):
    """The producer-thread host path (lip83_features_frame_host) must equal
    the batched device kernel to f32 rounding (host numpy keeps f64
    intermediates, the kernel is pure f32 — measured divergence ~4e-7
    relative) — this is what lets the capture loop avoid a per-frame jitted
    dispatch without changing the streaming engine's input."""
    from silent_speech.ops.features import lip83_features_frame_host

    lms = _random_landmarks(rng, 2, 4)
    feats, openness = lip83_features_batched(jnp.asarray(lms))
    for b in range(2):
        for t in range(4):
            f, o = lip83_features_frame_host(lms[b, t])
            np.testing.assert_allclose(
                f, np.asarray(feats)[b, t], rtol=1e-5, atol=2e-6)
            np.testing.assert_allclose(o, np.asarray(openness)[b, t],
                                       rtol=1e-5, atol=2e-6)
