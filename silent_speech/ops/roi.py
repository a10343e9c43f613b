"""Mouth-ROI pipeline: crop + grayscale + resample, batched on device.

Replaces the reference's per-frame OpenCV calls
(record_landmarks_official.py:102-118 ``crop_roi`` with default INTER_LINEAR;
live_infer_official.py:171-187 ``crop_roi_gray`` with INTER_AREA) with a
single fused XLA computation over (B, T) frame windows.

Key design choice: dynamic crop rectangles under static shapes. The crop box
depends on runtime landmark positions, so a literal slice would be a dynamic
shape — illegal under jit. Instead the crop+resize is expressed as two small
per-frame matrix multiplies

    roi = round( Wy(y1, y2) @ gray @ Wx(x1, x2)^T )

where ``Wy: (out_h, frame_h)`` and ``Wx: (out_w, frame_w)`` are banded weight
matrices computed on the fly from the (runtime) crop bounds. Rows hold the
resampling weights of cv2's INTER_AREA (exact fractional-coverage area
average, valid since mouth crops always shrink: crop >= 120 px vs 96x48 out)
or INTER_LINEAR (half-pixel-center bilinear with edge clamping). Everything is
dense matmuls — no gathers, no dynamic shapes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

# BT.601 luma, same coefficients as cv2.COLOR_BGR2GRAY / RGB2GRAY.
# Kept as numpy so importing this module never dispatches device work — an
# eager jnp.asarray here would initialize whatever backend is default.
_LUMA_RGB = np.asarray([0.299, 0.587, 0.114], np.float32)


def make_resize_matrix(
    out_size: int,
    a: jnp.ndarray,
    b: jnp.ndarray,
    in_size: int,
    mode: str = "area",
) -> jnp.ndarray:
    """Weight matrix mapping source axis pixels [a, b) -> ``out_size`` pixels.

    a, b: scalar int32 crop bounds (traced values are fine).
    Returns (out_size, in_size) float32; rows sum to 1.
    """
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    scale = (b - a) / float(out_size)  # source pixels per output pixel
    i = jnp.arange(out_size, dtype=jnp.float32)[:, None]  # (out, 1)
    s = jnp.arange(in_size, dtype=jnp.float32)[None, :]  # (1, in)

    if mode == "area":
        lo = a + i * scale
        hi = a + (i + 1.0) * scale
        overlap = jnp.clip(jnp.minimum(s + 1.0, hi) - jnp.maximum(s, lo), 0.0, 1.0)
        return overlap / scale
    elif mode == "linear":
        src = a + (i + 0.5) * scale - 0.5  # half-pixel-center convention
        f = jnp.floor(src)
        frac = src - f
        # replicate-border clamping inside the crop window
        f0 = jnp.clip(f, a, b - 1.0)
        f1 = jnp.clip(f + 1.0, a, b - 1.0)
        w = (1.0 - frac) * (s == f0) + frac * (s == f1)
        # where f0 == f1 (edges) the weights already sum to 1
        return w
    else:
        raise ValueError(f"unknown resize mode {mode!r}")


def _make_resize_matrix_np(out_size, a, b, in_size, mode):
    """Numpy mirror of make_resize_matrix for the host capture path."""
    a = float(a)
    b = float(b)
    scale = (b - a) / float(out_size)
    i = np.arange(out_size, dtype=np.float32)[:, None]
    s = np.arange(in_size, dtype=np.float32)[None, :]
    if mode == "area":
        lo = a + i * scale
        hi = a + (i + 1.0) * scale
        overlap = np.clip(np.minimum(s + 1.0, hi) - np.maximum(s, lo), 0.0, 1.0)
        return (overlap / scale).astype(np.float32)
    elif mode == "linear":
        src = a + (i + 0.5) * scale - 0.5
        f = np.floor(src)
        frac = src - f
        f0 = np.clip(f, a, b - 1.0)
        f1 = np.clip(f + 1.0, a, b - 1.0)
        return ((1.0 - frac) * (s == f0) + frac * (s == f1)).astype(np.float32)
    raise ValueError(f"unknown resize mode {mode!r}")


def crop_resize_gray_frame_host(
    frame: np.ndarray,
    center,
    scale: float,
    *,
    out_h: int = 48,
    out_w: int = 96,
    mode: str = "area",
    input_layout: str = "bgr",
    half_w_mul: float = 1.2,
    half_h_mul: float = 1.0,
    min_side: int = 2,
):
    """Single-frame gray+crop+resize in pure numpy — the capture-loop path.

    Same math as crop_resize_gray_batched (identical matrices, rounding and
    degenerate-box handling; pinned equal by tests/test_roi.py) but with zero
    device involvement: a live recorder must not pay a first jit compile
    (or any per-frame dispatch) for a ~30 MFLOP crop. Returns (out_h, out_w) uint8, or None when the crop degenerates
    (the reference's skip condition, live_infer_official.py:181-182).
    """
    H, W = frame.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    hw = half_w_mul * float(scale)
    hh = half_h_mul * float(scale)
    x1 = int(max(0.0, cx - hw))
    x2 = int(min(float(W), cx + hw))
    y1 = int(max(0.0, cy - hh))
    y2 = int(min(float(H), cy + hh))
    if not (x2 > x1 + min_side and y2 > y1 + min_side):
        return None
    lum = _LUMA_RGB if input_layout == "rgb" else _LUMA_RGB[::-1]
    gray = frame.astype(np.float32) @ lum  # (H, W)
    Wy = _make_resize_matrix_np(out_h, y1, y2, H, mode)
    Wx = _make_resize_matrix_np(out_w, x1, x2, W, mode)
    r = Wy @ gray @ Wx.T
    return np.clip(np.round(r), 0.0, 255.0).astype(np.uint8)


def resize_matrices(out_hw, y1, y2, x1, x2, in_hw, mode):
    oh, ow = out_hw
    ih, iw = in_hw
    Wy = make_resize_matrix(oh, y1, y2, ih, mode)
    Wx = make_resize_matrix(ow, x1, x2, iw, mode)
    return Wy, Wx


def _crop_bounds(center, scale, frame_w, frame_h, half_w_mul, half_h_mul):
    """Crop box ints, truncation + clamping as in the reference
    (record_landmarks_official.py:109-113: int() truncation of clamped floats)."""
    cx, cy = center[..., 0], center[..., 1]
    hw = half_w_mul * scale
    hh = half_h_mul * scale
    x1 = jnp.maximum(0.0, cx - hw).astype(jnp.int32)
    x2 = jnp.minimum(jnp.float32(frame_w), cx + hw).astype(jnp.int32)
    y1 = jnp.maximum(0.0, cy - hh).astype(jnp.int32)
    y2 = jnp.minimum(jnp.float32(frame_h), cy + hh).astype(jnp.int32)
    return x1, x2, y1, y2


@partial(
    jax.jit,
    static_argnames=("out_h", "out_w", "mode", "input_layout", "min_side"),
)
def crop_resize_gray_batched(
    frames: jnp.ndarray,
    centers: jnp.ndarray,
    scales: jnp.ndarray,
    *,
    out_h: int = 48,
    out_w: int = 96,
    mode: str = "area",
    input_layout: str = "rgb",
    half_w_mul: float = 1.2,
    half_h_mul: float = 1.0,
    min_side: int = 2,
):
    """Fused gray+crop+resize for a batch of frames.

    frames:  (B, T, H, W, 3) uint8
    centers: (B, T, 2) pixel crop centers (cx, cy)
    scales:  (B, T) pixel mouth widths

    Returns (roi (B, T, out_h, out_w) uint8, ok (B, T) bool). ``ok`` is False
    where the crop box degenerated (x2 <= x1 + min_side etc., the reference's
    skip condition, live_infer_official.py:181-182); those ROI frames are
    zeroed, matching the live zero-ROI substitution
    (live_infer_official.py:288-293).
    """
    B, T, H, W, _ = frames.shape
    x1, x2, y1, y2 = _crop_bounds(centers, scales, W, H, half_w_mul, half_h_mul)
    ok = (x2 > x1 + min_side) & (y2 > y1 + min_side)

    lum = jnp.asarray(
        _LUMA_RGB if input_layout == "rgb" else _LUMA_RGB[::-1], jnp.float32
    )
    gray = jnp.einsum(
        "bthwc,c->bthw", frames.astype(jnp.float32), lum
    )  # (B, T, H, W)

    def one_frame(g, xx1, xx2, yy1, yy2, okk):
        # guard degenerate boxes so the weight matrices stay finite
        xx2 = jnp.maximum(xx2, xx1 + 1)
        yy2 = jnp.maximum(yy2, yy1 + 1)
        Wy = make_resize_matrix(out_h, yy1, yy2, H, mode)  # (oh, H)
        Wx = make_resize_matrix(out_w, xx1, xx2, W, mode)  # (ow, W)
        r = Wy @ g @ Wx.T  # (oh, ow)
        r = jnp.clip(jnp.round(r), 0.0, 255.0)
        return jnp.where(okk, r, 0.0)

    roi = jax.vmap(jax.vmap(one_frame))(gray, x1, x2, y1, y2, ok)
    return roi.astype(jnp.uint8), ok


def gray_from_uint8(frames: jnp.ndarray, input_layout: str = "rgb") -> jnp.ndarray:
    """(..., H, W, 3) uint8 -> (..., H, W) float32 luma (BT.601)."""
    lum = _LUMA_RGB if input_layout == "rgb" else _LUMA_RGB[::-1]
    return jnp.einsum("...c,c->...", frames.astype(jnp.float32), lum)
