"""ROI resampling vs REAL OpenCV (skipped where cv2 is absent).

Round-1 parity for ops/roi.py was established against from-spec references
and a torch bilinear cross-check because cv2 was unavailable; this file
closes the loop against cv2 itself: the matmul-formulated crop+resize must
match cv2.resize INTER_AREA / INTER_LINEAR on the reference's exact crop
semantics (gray crop -> (96, 48) resize), and the grayscale luma must match
cvtColor within fixed-point rounding.
"""

import numpy as np
import pytest

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from silent_speech.ops.roi import (  # noqa: E402
    crop_resize_gray_batched,
    make_resize_matrix,
)


@pytest.mark.parametrize("mode,interp", [
    ("area", cv2.INTER_AREA),
    ("linear", cv2.INTER_LINEAR),
])
def test_resize_matrix_matches_real_cv2(rng, mode, interp):
    H, W = 120, 160
    gray = rng.integers(0, 256, (H, W), np.uint8)
    for y1, y2, x1, x2 in [(10, 90, 20, 150), (0, 120, 0, 160),
                           (33, 77, 41, 139), (5, 17, 7, 31)]:
        crop = gray[y1:y2, x1:x2]
        ref = cv2.resize(crop, (96, 48), interpolation=interp).astype(np.float32)

        Wy = np.asarray(make_resize_matrix(
            48, jnp.asarray(y1), jnp.asarray(y2), H, mode))
        Wx = np.asarray(make_resize_matrix(
            96, jnp.asarray(x1), jnp.asarray(x2), W, mode))
        got = Wy @ gray.astype(np.float32) @ Wx.T

        # cv2 uses fixed-point arithmetic internally; allow 1 gray level
        assert np.max(np.abs(got - ref)) <= 1.0 + 1e-3, (
            f"{mode} crop ({y1},{y2},{x1},{x2}): "
            f"max err {np.max(np.abs(got - ref))}")


def test_gray_crop_pipeline_matches_cv2_end_to_end(rng):
    """Full fused path (gray + crop + INTER_AREA resize + uint8 round) vs the
    reference sequence cvtColor -> slice -> cv2.resize."""
    H, W = 240, 320
    frame_rgb = rng.integers(0, 256, (H, W, 3), np.uint8)
    center = np.array([150.0, 120.0], np.float32)
    scale = np.float32(60.0)

    roi, ok = crop_resize_gray_batched(
        jnp.asarray(frame_rgb)[None, None],
        jnp.asarray(center)[None, None],
        jnp.asarray(scale)[None, None],
        mode="area",
    )
    assert bool(np.asarray(ok)[0, 0])
    got = np.asarray(roi)[0, 0].astype(np.float32)

    # reference: BGR frame -> cvtColor BGR2GRAY -> crop box -> INTER_AREA
    frame_bgr = frame_rgb[..., ::-1]
    gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    x1 = int(max(0.0, center[0] - 1.2 * scale))
    x2 = int(min(float(W), center[0] + 1.2 * scale))
    y1 = int(max(0.0, center[1] - 1.0 * scale))
    y2 = int(min(float(H), center[1] + 1.0 * scale))
    ref = cv2.resize(gray[y1:y2, x1:x2], (96, 48),
                     interpolation=cv2.INTER_AREA).astype(np.float32)

    # two fixed-point stages (luma + resize) -> allow 2 gray levels
    err = np.abs(got - ref)
    assert np.max(err) <= 2.0, f"max err {np.max(err)}"
    assert np.mean(err) < 0.6


def test_record_timed_mp4_parameters_encode_with_real_cv2(tmp_path, rng):
    """The exact VideoWriter invocation record_timed uses (mp4v fourcc,
    30 fps, frame-size order (w, h) — apps/record_timed.py:103-109) produces
    a decodable mp4 with real OpenCV."""
    frames = [rng.integers(0, 256, (480, 640, 3), np.uint8) for _ in range(12)]
    path = str(tmp_path / "sim_yes_1700000000_0001.mp4")
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    assert vw.isOpened()
    for f in frames:
        vw.write(f)
    vw.release()

    cap = cv2.VideoCapture(path)
    n = 0
    while True:
        ok, fr = cap.read()
        if not ok:
            break
        assert fr.shape == (480, 640, 3)
        n += 1
    cap.release()
    assert n == len(frames)


def test_camera_probe_with_real_cv2_fails_cleanly():
    """CameraSource's index-fallback probing executes against real OpenCV
    (no camera device in this env) and raises the clean RuntimeError rather
    than crashing inside cv2."""
    from silent_speech.runtime.capture import CameraSource

    with pytest.raises(RuntimeError, match="Could not open camera"):
        CameraSource(37, fallbacks=(38, 39))
