"""Landmark-stream -> feature-vector extraction, batched for the device.

The reference computes these per frame in Python inside the capture loop
(reference: record_landmarks_official.py:62-100 `extract_feature`,
live_infer_official.py:146-169, inactive/live_feed.py:57-86). Here the whole
(B, T) window is one fused XLA computation: a gather of the 88 fixed points,
center/scale normalization, a shifted-difference velocity with gate-aware
resets, and the 4 speech scalars.

Velocity semantics (must match the sequential reference exactly,
SURVEY.md section 2.5 item 8): the reference resets ``prev_xy = None`` on the
first frame and whenever the mouth-width distance band is exited
(record_landmarks_official.py:85-88,199-201). Batched equivalent:
``vel[t] = mean_k ||xy_n[t,k] - xy_n[t-1,k]||`` when frames t and t-1 are both
valid (in-range) and t > 0, else 0. No scan is needed because xy_n has no
temporal dependency — velocity is a masked one-step difference.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.landmarks import (
    FIXED_IDXS,
    LEFT_CORNER,
    RIGHT_CORNER,
    UPPER_INNER,
    LOWER_INNER,
    LIP_ORDER,
)

_FIXED = np.asarray(FIXED_IDXS, dtype=np.int32)
_LIP = np.asarray(LIP_ORDER, dtype=np.int32)
_EPS = 1e-6


def mouth_width(lm_px: jnp.ndarray) -> jnp.ndarray:
    """Mouth width in pixels from pixel-space landmarks (..., 468, 2).

    Reference: record_landmarks_official.py:52-59.
    """
    L = lm_px[..., LEFT_CORNER, :]
    R = lm_px[..., RIGHT_CORNER, :]
    return jnp.linalg.norm(L - R, axis=-1)


def _frame_geometry(lm_px: jnp.ndarray, idxs: jnp.ndarray):
    """Shared per-frame geometry. lm_px: (..., 468, 2) pixel coords.

    Returns (xy_n (..., K, 2), center (..., 2), mouth_w (...,),
    mouth_open (...,), aspect (...,)).
    """
    xy = jnp.take(lm_px, idxs, axis=-2)  # (..., K, 2)
    center = jnp.mean(xy, axis=-2)  # (..., 2)
    mw = mouth_width(lm_px)
    scale = mw + _EPS
    xy_n = (xy - center[..., None, :]) / scale[..., None, None]
    upper = lm_px[..., UPPER_INNER, :]
    lower = lm_px[..., LOWER_INNER, :]
    mouth_open = jnp.linalg.norm(upper - lower, axis=-1)
    aspect = mouth_open / (mw + _EPS)
    return xy_n, center, mw, mouth_open, aspect


def _masked_step_velocity(xy_n: jnp.ndarray,
                          valid: Optional[jnp.ndarray]) -> jnp.ndarray:
    """Gate-aware one-step mean landmark velocity -> (B, T).

    THE semantics-bearing construct every recorder generation shares
    (vel[0] = 0; a frame pair spanning an out-of-range/face-lost gap
    contributes 0 — must match the sequential reference exactly). One
    definition so the reset rule cannot drift between feature families."""
    d = xy_n[:, 1:] - xy_n[:, :-1]  # (B, T-1, K, 2)
    vel = jnp.pad(jnp.mean(jnp.linalg.norm(d, axis=-1), axis=-1),
                  ((0, 0), (1, 0)))  # vel[0] = 0
    if valid is not None:
        pair_ok = jnp.pad(valid[:, 1:] & valid[:, :-1], ((0, 0), (1, 0)))
        vel = jnp.where(pair_ok, vel, 0.0)
    return vel


@partial(jax.jit, static_argnames=("frame_w", "frame_h"))
def extract_features_batched(
    landmarks: jnp.ndarray,
    frame_w: int,
    frame_h: int,
    valid: Optional[jnp.ndarray] = None,
):
    """Batched official 180-D feature extraction.

    landmarks: (B, T, 468, 2+) normalized MediaPipe coordinates (only x, y
    used). ``valid``: optional (B, T) bool in-range gate; velocity resets at
    gate breaks.

    Returns (feats (B, T, 180) f32, centers (B, T, 2) px, mouth_w (B, T) px).
    Padded/gated frames still get feature rows (with vel handled by the mask);
    callers compact or mask them downstream.
    """
    lm_px = landmarks[..., :2] * jnp.asarray([frame_w, frame_h], landmarks.dtype)
    xy_n, center, mw, mouth_open, aspect = _frame_geometry(lm_px, jnp.asarray(_FIXED))

    vel = _masked_step_velocity(xy_n, valid)

    B, T = xy_n.shape[:2]
    flat = xy_n.reshape(B, T, -1)  # (B, T, 176)
    scalars = jnp.stack([vel, mouth_open, mw, aspect], axis=-1)  # (B, T, 4)
    feats = jnp.concatenate([flat, scalars], axis=-1).astype(jnp.float32)
    return feats, center, mw


def extract_features_frame(
    landmarks: np.ndarray,
    frame_w: int,
    frame_h: int,
    prev_xy: Optional[np.ndarray],
):
    """Single-frame host-side extraction for live capture loops.

    Mirrors the reference signature (record_landmarks_official.py:62-100):
    returns (feat (180,) f32, xy_n (88, 2), center px, mouth_w px).
    """
    lm = np.asarray(landmarks, dtype=np.float32)[..., :2] * np.asarray(
        [frame_w, frame_h], np.float32
    )
    xy = lm[_FIXED]
    center = xy.mean(0)
    mw = float(np.linalg.norm(lm[LEFT_CORNER] - lm[RIGHT_CORNER]))
    scale = mw + _EPS
    xy_n = (xy - center) / scale
    if prev_xy is None:
        vel = 0.0
    else:
        vel = float(np.mean(np.linalg.norm(xy_n - prev_xy, axis=1)))
    mouth_open = float(np.linalg.norm(lm[UPPER_INNER] - lm[LOWER_INNER]))
    aspect = mouth_open / (mw + _EPS)
    feat = np.concatenate(
        [xy_n.reshape(-1), np.asarray([vel, mouth_open, mw, aspect], np.float32)]
    ).astype(np.float32)
    return feat, xy_n, center, mw


def lip83_features_frame_host(face) -> tuple[np.ndarray, float]:
    """Single-frame HOST mirror of lip83_features_batched — the
    capture/producer-thread path. A per-frame jitted dispatch here would
    stall the capture loop for the whole first compile and add two
    device->host transfers per frame; the 83-D math
    is ~100 FLOPs. Equality with the batched kernel is pinned in
    tests/test_features.py. Returns (feat (83,) f32, openness)."""
    xy = np.asarray(face, np.float32)[:, :2]
    pts = xy[_LIP]  # (40, 2)
    center = pts.mean(axis=0, keepdims=True)
    mw = float(np.linalg.norm(xy[RIGHT_CORNER] - xy[LEFT_CORNER])) + _EPS
    pts_n = (pts - center) / np.float32(mw)
    openness = float(np.linalg.norm(xy[13] - xy[14])) / mw
    height = float(np.linalg.norm(xy[0] - xy[17])) / mw
    corner = float(np.linalg.norm(xy[61] - xy[291])) / mw - 1.0
    feat = np.concatenate(
        [pts_n.reshape(-1),
         np.asarray([openness, height, corner], np.float32)]
    ).astype(np.float32)
    return feat, openness


@jax.jit
def lip83_features_batched(landmarks: jnp.ndarray):
    """Batched 83-D streaming features (inactive/live_feed.py:57-86).

    landmarks: (B, T, 468, 2+) *normalized* coords (this family never scales
    to pixels). Returns (feats (B, T, 83), openness (B, T)).
    Layout: 40 ordered lip points x 2, then [openness, height, corner].
    """
    xy = landmarks[..., :2]
    pts = jnp.take(xy, jnp.asarray(_LIP), axis=-2)  # (B, T, 40, 2)
    center = jnp.mean(pts, axis=-2, keepdims=True)
    mw = jnp.linalg.norm(xy[..., RIGHT_CORNER, :] - xy[..., LEFT_CORNER, :], axis=-1) + _EPS
    pts_n = (pts - center) / mw[..., None, None]
    B, T = pts_n.shape[:2]
    feat80 = pts_n.reshape(B, T, -1)
    openness = jnp.linalg.norm(xy[..., 13, :] - xy[..., 14, :], axis=-1) / mw
    height = jnp.linalg.norm(xy[..., 0, :] - xy[..., 17, :], axis=-1) / mw
    corner = jnp.linalg.norm(xy[..., 61, :] - xy[..., 291, :], axis=-1) / mw - 1.0
    feats = jnp.concatenate(
        [feat80, openness[..., None], height[..., None], corner[..., None]], axis=-1
    ).astype(jnp.float32)
    return feats, openness


def polygon_area(pts: jnp.ndarray) -> jnp.ndarray:
    """Shoelace area over the last-two dims (..., K, 2)
    (inactive/record_landmarks.py:76-79)."""
    x, y = pts[..., 0], pts[..., 1]
    xr = jnp.roll(x, -1, axis=-1)
    yr = jnp.roll(y, -1, axis=-1)
    return 0.5 * jnp.abs(jnp.sum(x * yr - y * xr, axis=-1))


@partial(jax.jit, static_argnames=("frame_w", "frame_h"))
def mouth83_features_batched(
    landmarks: jnp.ndarray,
    frame_w: int,
    frame_h: int,
    valid: Optional[jnp.ndarray] = None,
):
    """Recorder-v1 mouth-only 83-D features
    (inactive/record_landmarks.py:82-116):
    40 lip points x 2 (centered, mouth-width normalized) + [openness,
    normalized lip-loop shoelace area, velocity]. landmarks: (B, T, 468, 2+)
    normalized coords. Returns (B, T, 83) f32.
    """
    from ..core.landmarks import MOUTH_LOWER, MOUTH_UPPER

    mouth_set = np.asarray(sorted(set(MOUTH_UPPER + MOUTH_LOWER)), np.int32)
    loop_idx = np.asarray(MOUTH_UPPER + MOUTH_LOWER[::-1], np.int32)

    lm_px = landmarks[..., :2] * jnp.asarray([frame_w, frame_h], landmarks.dtype)
    xy = jnp.take(lm_px, jnp.asarray(mouth_set), axis=-2)  # (B, T, 40, 2)
    center = jnp.mean(xy, axis=-2)
    width = mouth_width(lm_px) + _EPS
    xy_n = (xy - center[..., None, :]) / width[..., None, None]

    openness = (
        jnp.linalg.norm(
            lm_px[..., UPPER_INNER, :] - lm_px[..., LOWER_INNER, :], axis=-1
        )
        / width
    )
    loop = jnp.take(lm_px, jnp.asarray(loop_idx), axis=-2)
    loop_n = (loop - center[..., None, :]) / width[..., None, None]
    area = polygon_area(loop_n)

    vel = _masked_step_velocity(xy_n, valid)

    B, T = xy_n.shape[:2]
    return jnp.concatenate(
        [xy_n.reshape(B, T, -1), openness[..., None], area[..., None],
         vel[..., None]], axis=-1,
    ).astype(jnp.float32)


def span_norm_features_batched(
    landmarks: jnp.ndarray,
    idxs: jnp.ndarray,
    frame_w: int,
    frame_h: int,
    valid: Optional[jnp.ndarray] = None,
):
    """Subset-span-normalized features over an arbitrary landmark selection:
    the shared formula of recorder v3 (fixed 88 points,
    inactive/record_landmarks_v3.py:56-68) and the dynamic lower-face
    recorders (per-clip selections, inactive/lower_face_record.py:86-108):
    centered xy / x-span + one velocity scalar. Returns (B, T, 2K+1)."""
    lm_px = landmarks[..., :2] * jnp.asarray([frame_w, frame_h], landmarks.dtype)
    xy = jnp.take(lm_px, jnp.asarray(idxs), axis=-2)
    center = jnp.mean(xy, axis=-2)
    span = (
        jnp.max(xy[..., 0], axis=-1) - jnp.min(xy[..., 0], axis=-1) + _EPS
    )
    xy_n = (xy - center[..., None, :]) / span[..., None, None]

    vel = _masked_step_velocity(xy_n, valid)

    B, T = xy_n.shape[:2]
    return jnp.concatenate(
        [xy_n.reshape(B, T, -1), vel[..., None]], axis=-1
    ).astype(jnp.float32)


@partial(jax.jit, static_argnames=("frame_w", "frame_h"))
def v3_features_batched(
    landmarks: jnp.ndarray,
    frame_w: int,
    frame_h: int,
    valid: Optional[jnp.ndarray] = None,
):
    """Recorder-v3 177-D features: the 88 fixed points through the span-norm
    formula. Returns (B, T, 177)."""
    return span_norm_features_batched(
        landmarks, jnp.asarray(_FIXED), frame_w, frame_h, valid
    )


def span_norm_feature_frame(
    landmarks: np.ndarray,
    frame_w: int,
    frame_h: int,
    idxs: np.ndarray,
    prev_xy: Optional[np.ndarray],
):
    """Single-frame host-side span-norm extraction (the dynamic recorders'
    per-frame path, inactive/lower_face_record.py:86-108). Returns
    (feat (2K+1,), xy_n, center px, span px)."""
    lm = np.asarray(landmarks, np.float32)[..., :2] * np.asarray(
        [frame_w, frame_h], np.float32
    )
    xy = lm[np.asarray(idxs)]
    center = xy.mean(0)
    span = float(xy[:, 0].max() - xy[:, 0].min()) + _EPS
    xy_n = (xy - center) / span
    if prev_xy is None:
        vel = 0.0
    else:
        vel = float(np.mean(np.linalg.norm(xy_n - prev_xy, axis=1)))
    feat = np.concatenate(
        [xy_n.reshape(-1), np.asarray([vel], np.float32)]
    ).astype(np.float32)
    return feat, xy_n, center, span
