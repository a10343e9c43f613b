"""Native runtime: ring buffer semantics + parallel npz loader parity,
including an SPSC stress test across threads."""

import glob
import threading

import numpy as np
import pytest

from silent_speech.core.schema import fix_dim, load_clip
from silent_speech.data.native_loader import load_corpus_arrays
from silent_speech.data.synthetic import generate_corpus
from silent_speech.runtime import native
from silent_speech.runtime.ringbuf import FrameRing


def test_ringbuf_fifo_and_drop():
    r = FrameRing(capacity=4, slot_bytes=16)
    for i in range(r.capacity):
        assert r.push(np.full(4, i, np.float32), stamp=i)
    # full now: push must fail and count the drop
    assert not r.push(np.zeros(4, np.float32))
    assert r.dropped == 1
    for i in range(r.capacity):
        out, stamp = r.pop()
        assert stamp == i
        np.testing.assert_array_equal(out.view(np.float32), np.full(4, i))
    assert r.pop() is None


def test_ringbuf_batch_drain():
    r = FrameRing(capacity=16, slot_bytes=8)
    for i in range(10):
        r.push(np.asarray([i, i], np.float32), stamp=i)
    payloads, stamps = r.pop_batch(6)
    assert payloads.shape == (6, 8)
    np.testing.assert_array_equal(stamps, np.arange(6))
    payloads, stamps = r.pop_batch(100)
    assert len(payloads) == 4
    assert len(r) == 0


def test_ringbuf_spsc_stress():
    """Producer and consumer on separate threads: every payload arrives
    exactly once, in order."""
    r = FrameRing(capacity=64, slot_bytes=8)
    N = 20000
    got = []

    def producer():
        i = 0
        while i < N:
            if r.push(np.asarray([i, i], np.int32), stamp=i):
                i += 1

    def consumer():
        while len(got) < N:
            item = r.pop()
            if item is not None:
                got.append(int(item[0].view(np.int32)[0]))

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(); tc.start()
    tp.join(timeout=30); tc.join(timeout=30)
    assert got == list(range(N))


def test_landmarker_asset_resolution(tmp_path, monkeypatch):
    """resolve_landmarker_asset order: explicit path -> $SILENT_SPEECH_LANDMARKER
    -> repo-root relative; missing -> FileNotFoundError with download
    instructions (runtime/capture.py:30-50 — the first code path a real
    camera user hits, reference record_landmarks_official.py:150-154)."""
    import os

    from silent_speech.runtime.capture import (
        LANDMARKER_ENV,
        LANDMARKER_URL,
        resolve_landmarker_asset,
    )

    # 1. explicit existing path wins
    asset = tmp_path / "face_landmarker.task"
    asset.write_bytes(b"fake-tflite-bundle")
    monkeypatch.delenv(LANDMARKER_ENV, raising=False)
    assert resolve_landmarker_asset(str(asset)) == str(asset)

    # 2. env var fallback when the explicit path is missing
    monkeypatch.setenv(LANDMARKER_ENV, str(asset))
    assert resolve_landmarker_asset("models/no_such_bundle.task") == str(asset)

    # 3. repo-root-relative fallback (the reference's hardcoded layout)
    monkeypatch.delenv(LANDMARKER_ENV, raising=False)
    import silent_speech.runtime.capture as capture_mod
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(capture_mod.__file__))))
    rel = "models/_test_landmarker_asset.task"
    root_asset = os.path.join(repo_root, rel)
    os.makedirs(os.path.dirname(root_asset), exist_ok=True)
    try:
        with open(root_asset, "wb") as f:
            f.write(b"fake")
        monkeypatch.chdir(tmp_path)  # rel must NOT resolve via cwd
        assert resolve_landmarker_asset(rel) == root_asset
    finally:
        os.remove(root_asset)

    # 4. missing everywhere -> actionable error with the download command
    with pytest.raises(FileNotFoundError) as ei:
        resolve_landmarker_asset("models/no_such_bundle.task")
    msg = str(ei.value)
    assert LANDMARKER_URL in msg and LANDMARKER_ENV in msg and "curl" in msg


def test_landmarker_session_smoke():
    """L1 smoke: lights up automatically the moment the env gains mediapipe
    (+ the .task asset). Opens a real FaceLandmarkerSession and runs detect on
    a synthetic faceless image — must return None, not crash
    (reference record_landmarks_official.py:150-154,163,172-174)."""
    pytest.importorskip("mediapipe")
    pytest.importorskip("cv2")
    from silent_speech.runtime.capture import (
        FaceLandmarkerSession,
        resolve_landmarker_asset,
    )

    try:
        resolve_landmarker_asset("models/face_landmarker.task")
    except FileNotFoundError:
        pytest.skip("face_landmarker.task asset not present")

    for video_mode in (True, False):
        sess = FaceLandmarkerSession(video_mode=video_mode)
        frame = np.full((240, 320, 3), 127, np.uint8)  # no face
        out = sess.detect(frame, ts_ms=33)
        assert out is None or out.shape == (468, 3)
        sess.close()


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_matches_numpy(tmp_path):
    generate_corpus(str(tmp_path), clips_per_word=3, seed=11)
    files = sorted(glob.glob(str(tmp_path / "*.npz")))
    X, roi, lengths, has_roi = load_corpus_arrays(files, 90, 180, True)
    assert has_roi.all()
    for i, f in enumerate(files):
        c = load_clip(f).aligned()
        T = min(c.T, 90)
        assert lengths[i] == T
        np.testing.assert_array_equal(X[i, :T], fix_dim(c.X, 180)[:T])
        np.testing.assert_array_equal(roi[i, :T], c.roi[:T])
        assert np.abs(X[i, T:]).max() == 0


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_loader_dim_tolerance(tmp_path):
    """fix_dim semantics: narrower clips zero-pad, wider clips truncate."""
    X = np.arange(60, dtype=np.float32).reshape(6, 10)
    np.savez_compressed(str(tmp_path / "me_yes_1_0000.npz"), X=X, label="yes")
    Xo, _, L, _ = load_corpus_arrays(
        [str(tmp_path / "me_yes_1_0000.npz")], 8, 12, False)
    assert L[0] == 6
    np.testing.assert_array_equal(Xo[0, :6, :10], X)
    assert np.abs(Xo[0, :, 10:]).max() == 0
    Xo2, _, _, _ = load_corpus_arrays(
        [str(tmp_path / "me_yes_1_0000.npz")], 8, 7, False)
    np.testing.assert_array_equal(Xo2[0, :6], X[:, :7])


def test_play_audio_spawns_player_on_real_asset(monkeypatch):
    """The easter-egg assets exist (audios/fahhhh.mp3, vine-boom.mp3 --
    live_infer_official.py:59-65) and play_audio launches a player on them.
    No player binary ships in CI, so the spawn is captured via monkeypatch;
    the files themselves are checked for a valid MP3 sync header."""
    import os

    from silent_speech.apps.live import BOOM_PATH, FAH_PATH
    from silent_speech.runtime import capture

    spawned = []

    class _FakeProc:
        pass

    monkeypatch.setattr(capture.shutil, "which",
                        lambda name: name == "afplay" or None)
    monkeypatch.setattr(capture.subprocess, "Popen",
                        lambda cmd: (spawned.append(cmd), _FakeProc())[1])
    # the paths live.py actually passes must exist regardless of cwd
    for path in (FAH_PATH, BOOM_PATH):
        assert os.path.isabs(path), path
        assert os.path.isfile(path), path
        with open(path, "rb") as f:
            head = f.read(2)
        assert head[0] == 0xFF and (head[1] & 0xE0) == 0xE0, "not an MP3 frame"
        proc = capture.play_audio(path)
        assert proc is not None
    assert [c[0] for c in spawned] == ["afplay", "afplay"]
    assert spawned[0][-1].endswith("fahhhh.mp3")
