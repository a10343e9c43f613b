"""ROI crop+gray+resize vs independent numpy references.

cv2 itself is not available in this environment, so INTER_AREA parity is
checked against a from-spec numpy implementation of fractional-coverage area
averaging (rows/cols overlap weighting — the documented INTER_AREA algorithm
for shrinking) and, for integer factors, against exact block means.
INTER_LINEAR is cross-checked against torch bilinear (same half-pixel-center
convention as cv2).
"""

import numpy as np
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from silent_speech.ops.roi import (
    crop_resize_gray_batched,
    make_resize_matrix,
)


def _area_resize_1d_ref(vals, a, b, out):
    """Reference fractional area average along one axis."""
    scale = (b - a) / out
    res = np.zeros(out)
    for i in range(out):
        lo, hi = a + i * scale, a + (i + 1) * scale
        acc = 0.0
        for s in range(int(np.floor(lo)), int(np.ceil(hi))):
            ov = min(s + 1, hi) - max(s, lo)
            if ov > 0:
                acc += ov * vals[s]
        res[i] = acc / scale
    return res


def test_area_matrix_matches_reference(rng):
    vals = rng.random(200).astype(np.float64)
    for a, b, out in [(0, 200, 50), (13, 187, 96), (5, 101, 48)]:
        M = np.asarray(make_resize_matrix(out, jnp.int32(a), jnp.int32(b), 200, "area"))
        got = M @ vals
        ref = _area_resize_1d_ref(vals, a, b, out)
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(M.sum(1), 1.0, atol=1e-5)


def test_area_integer_factor_is_block_mean(rng):
    img = rng.random((64, 128)).astype(np.float32)
    My = np.asarray(make_resize_matrix(32, jnp.int32(0), jnp.int32(64), 64, "area"))
    Mx = np.asarray(make_resize_matrix(64, jnp.int32(0), jnp.int32(128), 128, "area"))
    got = My @ img @ Mx.T
    ref = img.reshape(32, 2, 64, 2).mean(axis=(1, 3))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_linear_matrix_matches_torch_bilinear(rng):
    """Full-window bilinear shrink vs torch (align_corners=False — cv2's
    convention)."""
    img = rng.random((60, 90)).astype(np.float32)
    out_h, out_w = 24, 48
    My = np.asarray(make_resize_matrix(out_h, jnp.int32(0), jnp.int32(60), 60, "linear"))
    Mx = np.asarray(make_resize_matrix(out_w, jnp.int32(0), jnp.int32(90), 90, "linear"))
    got = My @ img @ Mx.T
    ref = F.interpolate(
        torch.from_numpy(img)[None, None], size=(out_h, out_w),
        mode="bilinear", align_corners=False,
    )[0, 0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_crop_resize_gray_batched_shapes_and_gray(rng):
    B, T, H, W = 2, 3, 240, 320
    frames = rng.integers(0, 256, size=(B, T, H, W, 3), dtype=np.uint8)
    centers = np.tile(np.asarray([[160.0, 120.0]], np.float32), (B, T, 1)).reshape(B, T, 2)
    scales = np.full((B, T), 80.0, np.float32)
    roi, ok = crop_resize_gray_batched(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales),
        mode="area", input_layout="bgr",
    )
    assert roi.shape == (B, T, 48, 96) and roi.dtype == jnp.uint8
    assert bool(np.asarray(ok).all())

    # independent reference for one frame: BT.601 gray then fractional area avg
    f = frames[0, 0].astype(np.float64)
    gray = 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]  # BGR layout
    cx, cy, s = 160.0, 120.0, 80.0
    x1, x2 = int(max(0, cx - 1.2 * s)), int(min(W, cx + 1.2 * s))
    y1, y2 = int(max(0, cy - 1.0 * s)), int(min(H, cy + 1.0 * s))
    rows = np.stack([_area_resize_1d_ref(gray[y], x1, x2, 96) for y in range(H)])
    ref = np.stack([_area_resize_1d_ref(rows[:, x], y1, y2, 48) for x in range(96)], axis=1)
    assert np.abs(np.asarray(roi)[0, 0].astype(np.float64) - ref).max() <= 1.0


def test_degenerate_crop_yields_zero_roi(rng):
    B, T, H, W = 1, 2, 100, 100
    frames = rng.integers(0, 256, size=(B, T, H, W, 3), dtype=np.uint8)
    centers = np.asarray([[[2.0, 2.0], [50.0, 50.0]]], np.float32)  # box clipped to nothing
    scales = np.asarray([[1.0, 30.0]], np.float32)
    roi, ok = crop_resize_gray_batched(
        jnp.asarray(frames), jnp.asarray(centers), jnp.asarray(scales))
    ok = np.asarray(ok)
    assert not ok[0, 0] and ok[0, 1]
    assert np.asarray(roi)[0, 0].max() == 0


def test_host_frame_path_equals_device_kernel(rng):
    """crop_resize_gray_frame_host (the capture-loop path, pure numpy) must
    equal crop_resize_gray_batched bit-for-bit, including the degenerate-box
    convention."""
    from silent_speech.ops.roi import (
        crop_resize_gray_batched,
        crop_resize_gray_frame_host,
    )

    frame = rng.integers(0, 256, (240, 320, 3), np.uint8)
    for center, scale, mode in [((150.0, 120.0), 55.0, "area"),
                                ((150.0, 120.0), 55.0, "linear"),
                                ((10.0, 10.0), 40.0, "area"),   # clipped box
                                ((300.0, 5.0), 30.0, "linear"),
                                ((160.0, 120.0), 0.5, "area")]:  # degenerate
        dev, ok = crop_resize_gray_batched(
            jnp.asarray(frame)[None, None],
            jnp.asarray(np.asarray(center, np.float32))[None, None],
            jnp.asarray(np.asarray(scale, np.float32))[None, None],
            mode=mode, input_layout="bgr",
        )
        host = crop_resize_gray_frame_host(frame, center, scale, mode=mode,
                                           input_layout="bgr")
        if not bool(np.asarray(ok)[0, 0]):
            assert host is None
            continue
        np.testing.assert_array_equal(np.asarray(dev)[0, 0], host)
