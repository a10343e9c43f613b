"""Headless end-to-end drives of every camera app loop.

The fakes in runtime/fakes.py replace cv2 / CameraSource /
FaceLandmarkerSession; these tests exercise the exact loop bodies the
reference could only eyeball-test: keyboard state machines, distance gating,
the too-short-clip branch, the zero-ROI fallback, the audio easter eggs, the
mp4 writer, and the countdown recorder state machine.
"""

import os

import numpy as np
import pytest

import jax

from silent_speech.apps import cli, important_landmarks, landmarks_view
from silent_speech.apps import live, record, record_timed
from silent_speech.core import RecorderConfig
from silent_speech.core.config import InferConfig, StreamConfig
from silent_speech.core.landmarks import WORDS
from silent_speech.core.schema import load_clip
from silent_speech.infer.predictor import Predictor
from silent_speech.models import bigru as model
from silent_speech.runtime.fakes import (
    NO_KEY,
    FakeCamera,
    face_track,
    make_face,
    sim_session,
)
from silent_speech.train.checkpoint import reference_meta, save_checkpoint

LABELS = sorted(WORDS)


def _save_ckpt(tmp_path, bias_word=None, name="m.ckpt"):
    cfg = model.BiGRUConfig(x_dim=180, num_classes=10, use_roi=True)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    params = jax.tree.map(np.asarray, params)
    if bias_word is not None:
        b = np.array(params["head"]["fc2"]["b"])
        b[LABELS.index(bias_word)] = 50.0
        params["head"]["fc2"]["b"] = b
    l2i = {lab: i for i, lab in enumerate(LABELS)}
    meta = reference_meta(
        x_dim=180, max_t=90, use_roi=True, roi_w=96, roi_h=48,
        labels=LABELS, label_to_id=l2i,
        id_to_label={i: lab for lab, i in l2i.items()}, seed=42,
    )
    path = str(tmp_path / name)
    save_checkpoint(path, params, meta)
    return path


def _keys(n, **at):
    """Key script: _keys(30, r=(2, 20)) presses 'r' on frames 2 and 20."""
    ks = [NO_KEY] * n
    for ch, frames in at.items():
        code = ord(" ") if ch == "space" else ord(ch)
        for f in (frames if isinstance(frames, tuple) else (frames,)):
            ks[f] = code
    return ks


@pytest.fixture
def predict_spy(monkeypatch):
    calls = []
    orig = Predictor.predict_arrays

    def spy(self, feats, roi, k=3):
        out = orig(self, feats, roi, k)
        calls.append(dict(feats=np.asarray(feats),
                          roi=None if roi is None else np.asarray(roi),
                          top=out))
        return out

    monkeypatch.setattr(Predictor, "predict_arrays", spy)
    return calls


def test_infer_live_record_toggle_predicts(tmp_path, predict_spy, capsys):
    ckpt = _save_ckpt(tmp_path)
    n = 30
    with sim_session(keys=_keys(n, r=(2, 20)), n_frames=n,
                     faces=face_track(n)) as (cv2f, cam, lm):
        live.infer_live(InferConfig(ckpt_path=ckpt))
    assert len(predict_spy) == 1
    # frames 3..19 recorded (key consumed on frame 2 starts rec from next)
    assert 10 <= len(predict_spy[0]["feats"]) <= 20
    assert predict_spy[0]["roi"].shape[1:] == (48, 96)
    assert "Top3:" in capsys.readouterr().out
    assert cam.released and lm.closed and cv2f.destroyed
    assert any(w == "Live Infer" for w in cv2f.windows)


def test_infer_live_serving_knobs(tmp_path, predict_spy, capsys):
    """compute_dtype/matmul_precision flow from InferConfig into the
    Predictor and the loop still predicts; a removed kernel's setting is
    refused."""
    ckpt = _save_ckpt(tmp_path)
    n = 30
    with sim_session(keys=_keys(n, r=(2, 20)), n_frames=n,
                     faces=face_track(n)) as (cv2f, cam, lm):
        live.infer_live(InferConfig(ckpt_path=ckpt,
                                    compute_dtype="bfloat16",
                                    matmul_precision="highest"))
    assert len(predict_spy) == 1
    assert "Top3:" in capsys.readouterr().out
    with pytest.raises(TypeError, match="roi_impl"):
        Predictor.from_checkpoint(ckpt, roi_impl="fused")


def test_infer_live_predict_async(tmp_path, predict_spy, capsys):
    """predict_async=true: the clip predict runs off-thread (camera keeps
    rolling, the reference freezes) and the result is published — during the
    run or by the exit drain."""
    ckpt = _save_ckpt(tmp_path)
    n = 40
    with sim_session(keys=_keys(n, r=(2, 20)), n_frames=n,
                     faces=face_track(n)) as (cv2f, cam, lm):
        live.infer_live(InferConfig(ckpt_path=ckpt, predict_async=True))
    assert len(predict_spy) == 1
    assert "Top3:" in capsys.readouterr().out
    assert cam.released and lm.closed and cv2f.destroyed


def test_async_clip_predictor_semantics():
    """_AsyncClipPredictor: newest submission supersedes an unread older
    result; invalidate() discards an in-flight result; worker errors
    re-raise on poll; shutdown() lands every live dispatch."""
    import threading
    import time

    gate1 = threading.Event()

    def slow_then_fast(tag):
        if tag == "a":
            gate1.wait(10)
        return tag

    ap = live._AsyncClipPredictor(slow_then_fast)
    ap.submit("a")          # blocks on gate1
    ap.submit("b")          # finishes first
    deadline = time.monotonic() + 10
    while ap.poll() != "b":
        assert time.monotonic() < deadline
    # the exit-safety hazard window: the newest result landed (not pending)
    # but the superseded submission's thread still holds its dispatch (busy)
    assert not ap.pending and ap.busy
    gate1.set()             # 'a' (gen 1) finishes late; must NOT supersede
    res = ap.drain(timeout=10)
    assert res is None and not ap.pending
    ap.join()
    assert not ap.busy

    # invalidate: an in-flight submission's result is discarded (new
    # recording started), and shutdown still lands the thread
    gate2 = threading.Event()
    ap3 = live._AsyncClipPredictor(lambda: gate2.wait(10) or "stale")
    ap3.submit()
    ap3.invalidate()
    assert not ap3.pending and ap3.busy
    gate2.set()
    assert ap3.shutdown("test") is None
    assert not ap3.busy

    def boom():
        raise RuntimeError("predict exploded")

    ap2 = live._AsyncClipPredictor(boom)
    ap2.submit()
    with pytest.raises(RuntimeError, match="predict exploded"):
        deadline = time.monotonic() + 10
        while True:
            ap2.poll()
            assert time.monotonic() < deadline


def test_infer_live_too_short_clip_rejected(tmp_path, predict_spy, capsys):
    ckpt = _save_ckpt(tmp_path)
    n = 16
    with sim_session(keys=_keys(n, r=(2, 5)), n_frames=n,
                     faces=face_track(n)):
        live.infer_live(InferConfig(ckpt_path=ckpt))
    assert predict_spy == []
    assert "Too short." in capsys.readouterr().out


def test_infer_live_out_of_range_frames_not_recorded(tmp_path, predict_spy):
    """Distance gating: frames with mouth width outside [60, 150] px are
    dropped and the velocity chain resets (apps/live.py elif branch)."""
    ckpt = _save_ckpt(tmp_path)
    n = 40
    faces = [make_face(mouth_w_px=90 if 10 <= i < 25 else 30, seed=i)
             for i in range(n)]
    with sim_session(keys=_keys(n, r=(2, 30)), n_frames=n, faces=faces):
        live.infer_live(InferConfig(ckpt_path=ckpt))
    assert len(predict_spy) == 1
    # only the in-range frames were buffered
    assert len(predict_spy[0]["feats"]) <= 15


def test_infer_live_zero_roi_fallback(tmp_path, predict_spy):
    """When the crop box degenerates (sub-pixel mouth passing a widened
    distance gate), the app substitutes zero ROIs
    (live_infer_official.py:288-293 semantics) and the prediction still
    runs. With the default gate this can't happen — the [60,150]px band
    guarantees a valid crop — so the gate is widened to reach the branch."""
    ckpt = _save_ckpt(tmp_path)
    n = 24
    faces = [make_face(mouth_w_px=0.5, seed=i) for i in range(n)]
    with sim_session(keys=_keys(n, r=(2, 18)), n_frames=n, faces=faces):
        live.infer_live(InferConfig(ckpt_path=ckpt, mouth_w_min_px=0.0))
    assert len(predict_spy) == 1
    roi = predict_spy[0]["roi"]
    assert roi is not None and np.all(roi == 0)


def test_infer_live_fahhh_easter_egg(tmp_path, predict_spy, monkeypatch):
    played = []
    monkeypatch.setattr(live, "play_audio", lambda p: played.append(p))
    ckpt = _save_ckpt(tmp_path, bias_word="fahhh")
    n = 30
    with sim_session(keys=_keys(n, r=(2, 18)), n_frames=n,
                     faces=face_track(n)):
        live.infer_live(InferConfig(ckpt_path=ckpt))
    assert predict_spy[0]["top"][0][0] == "fahhh"
    assert played == [live.FAH_PATH]  # fires once, not per frame


def test_infer_gated_auto_clip(tmp_path, predict_spy, capsys):
    """Openness hysteresis segments a speaking burst into a clip and
    predicts without any keypress."""
    ckpt = _save_ckpt(tmp_path)
    n = 50
    # closed (aspect .067) -> 15-frame burst (aspect .222 > .15) -> closed
    open_seq = [6.0] * 8 + [20.0] * 15 + [6.0] * (n - 23)
    with sim_session(keys=[], n_frames=n,
                     faces=face_track(n, open_seq=open_seq)):
        live.infer_gated(InferConfig(ckpt_path=ckpt), StreamConfig())
    assert len(predict_spy) == 1
    assert len(predict_spy[0]["feats"]) >= 6
    assert "Top3:" in capsys.readouterr().out


def test_infer_gated_threaded_pipeline(tmp_path, predict_spy, capsys):
    """pipeline=threaded on the gated app: the same burst segments and
    predicts through producer -> ring (feat+ROI payloads, face-lost flag) ->
    dispatch; every frame arrives exactly once."""
    ckpt = _save_ckpt(tmp_path)
    n = 50
    open_seq = [6.0] * 8 + [20.0] * 15 + [6.0] * (n - 23)
    faces = face_track(n, open_seq=open_seq)
    faces[30] = None  # face-lost frame travels the ring and resets the gate
    with sim_session(keys=[], n_frames=n, faces=faces):
        live.infer_gated(InferConfig(ckpt_path=ckpt),
                         StreamConfig(pipeline="threaded"))
    assert len(predict_spy) == 1
    assert len(predict_spy[0]["feats"]) >= 6
    out = capsys.readouterr().out
    assert "Top3:" in out
    assert f"produced={n} consumed={n} dropped=0" in out


def test_threaded_gated_bitwise_equals_sequential(tmp_path, predict_spy):
    """The threaded gated pipeline segments the SAME clips with the SAME
    feature/ROI payloads as the sequential loop — gate state is driven in
    ring FIFO order, and the packer round-trips feat f32 / ROI u8 exactly."""
    ckpt = _save_ckpt(tmp_path)
    n = 60
    open_seq = ([6.0] * 8 + [20.0] * 15 + [6.0] * 10 + [20.0] * 12
                + [6.0] * (n - 45))
    faces = face_track(n, open_seq=open_seq)
    # face loss in the idle gap AFTER burst 1's end_n countdown (clip closes
    # at frame 26 = burst end 22 + end_n 4) — a loss inside the countdown
    # would discard the clip via gate.reset in both modes
    faces[30] = None

    def run(pipeline):
        predict_spy.clear()
        with sim_session(keys=[], n_frames=n, faces=faces):
            live.infer_gated(InferConfig(ckpt_path=ckpt),
                             StreamConfig(pipeline=pipeline))
        return [(c["feats"], c["roi"]) for c in predict_spy]

    seq = run("sequential")
    thr = run("threaded")
    assert len(seq) == len(thr) == 2  # both bursts segmented in both modes
    for (fa, ra), (fb, rb) in zip(seq, thr):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(ra, rb)


def test_infer_gated_reference_overlay(tmp_path, predict_spy):
    """The gated app draws the reference demo's overlay stack
    (live_lower_half.py:231-308): open= readout, the PRED: banner while the
    hold counter runs, SPEAKING/IDLE, 'q to quit', the reference window
    name, and NO FACE with a display reset on face loss."""
    ckpt = _save_ckpt(tmp_path, bias_word="hello")
    n = 50
    open_seq = [6.0] * 8 + [20.0] * 15 + [6.0] * (n - 23)
    faces = face_track(n, open_seq=open_seq)
    faces[40] = None
    with sim_session(keys=[], n_frames=n, faces=faces) as (cv2f, _, _):
        live.infer_gated(InferConfig(ckpt_path=ckpt), StreamConfig())
    assert "Live + Word Prediction (Clip Gated)" in cv2f.windows
    assert any(t.startswith("open=") for t in cv2f.texts)
    assert any(t.startswith("PRED: hello (") for t in cv2f.texts)
    assert "SPEAKING" in cv2f.texts and "IDLE" in cv2f.texts
    assert "q to quit" in cv2f.texts and "NO FACE" in cv2f.texts


def test_infer_gated_predict_async(tmp_path, predict_spy, capsys):
    """predict_async=true on the gated app (sequential): the clip predict
    runs off the camera loop — the InferConfig knob must be honored here,
    not silently swallowed — and the result is published during the run or
    by the exit drain."""
    ckpt = _save_ckpt(tmp_path)
    n = 50
    open_seq = [6.0] * 8 + [20.0] * 15 + [6.0] * (n - 23)
    with sim_session(keys=[], n_frames=n,
                     faces=face_track(n, open_seq=open_seq)):
        live.infer_gated(InferConfig(ckpt_path=ckpt, predict_async=True),
                         StreamConfig())
    assert len(predict_spy) == 1
    assert "Top3:" in capsys.readouterr().out


def test_infer_gated_threaded_predict_async(tmp_path, predict_spy, capsys):
    """predict_async on top of pipeline=threaded: the clip predict moves off
    the dispatch thread too (gating keeps pace through a slow predict); the
    same burst segments and the result still publishes."""
    ckpt = _save_ckpt(tmp_path)
    n = 50
    open_seq = [6.0] * 8 + [20.0] * 15 + [6.0] * (n - 23)
    with sim_session(keys=[], n_frames=n,
                     faces=face_track(n, open_seq=open_seq)):
        live.infer_gated(InferConfig(ckpt_path=ckpt, predict_async=True),
                         StreamConfig(pipeline="threaded"))
    assert len(predict_spy) == 1
    assert "Top3:" in capsys.readouterr().out


def test_infer_stream_rejects_missing_label_map(tmp_path):
    """A streaming checkpoint with no id_to_label/id_to_word map fails
    loudly at LOAD time — not mid-session with a KeyError at the first
    prediction after the camera is already open."""
    from silent_speech.models.variants import init_gru_word_classifier

    params = jax.tree.map(
        np.asarray, init_gru_word_classifier(jax.random.PRNGKey(0), 83, 5))
    ckpt = str(tmp_path / "nolabels.ckpt")
    save_checkpoint(ckpt, params, dict(input_dim=83, max_t=40))
    with pytest.raises(ValueError, match="id_to_label"):
        live.infer_stream(ckpt, StreamConfig())


def test_infer_stream_sliding_window(tmp_path):
    from silent_speech.models.variants import init_gru_word_classifier

    params = jax.tree.map(
        np.asarray, init_gru_word_classifier(jax.random.PRNGKey(0), 83, 5))
    meta = dict(input_dim=83, max_t=40,
                id_to_label={i: w for i, w in enumerate(LABELS[:5])})
    ckpt = str(tmp_path / "s.ckpt")
    save_checkpoint(ckpt, params, meta)
    n = 30
    with sim_session(keys=[], n_frames=n, faces=face_track(n)) as (cv2f, _, _):
        live.infer_stream(ckpt, StreamConfig(max_t=20, warmup_min=4))
    # the overlay ran with a real prediction at least once
    assert any("(" in t and ")" in t for t in cv2f.texts)


def _save_window_ckpt(tmp_path):
    from silent_speech.models.variants import init_gru_word_classifier

    params = jax.tree.map(
        np.asarray, init_gru_word_classifier(jax.random.PRNGKey(0), 83, 5))
    meta = dict(input_dim=83, max_t=40,
                id_to_label={i: w for i, w in enumerate(LABELS[:5])})
    ckpt = str(tmp_path / "s.ckpt")
    save_checkpoint(ckpt, params, meta)
    return ckpt


def _save_unigru_ckpt(tmp_path):
    from silent_speech.models.variants import init_unigru_classifier

    params = jax.tree.map(
        np.asarray, init_unigru_classifier(jax.random.PRNGKey(1), 360, 5))
    # the real train-unigru meta contract: label map key is 'id_to_word'
    # (train/legacy_loops.py:296-303) — keep this fixture honest so the CLI
    # round-trip (train-unigru -> infer-stream engine=carry) stays covered
    meta = dict(model="unigru", d_in=360, t_target=32, d_target=180,
                use_deltas=True, trim=dict(margin=2, q=0.6, min_keep=6),
                id_to_word={str(i): w for i, w in enumerate(LABELS[:5])})
    ckpt = str(tmp_path / "u.ckpt")
    save_checkpoint(ckpt, params, meta)
    return ckpt


def test_infer_stream_threaded_pipeline(tmp_path, capsys):
    """pipeline=threaded: camera+landmarker producer -> C++ SPSC ring ->
    dispatch thread (runtime/pipeline.LivePipeline) with the drop counter
    surfaced — every sim frame must arrive exactly once at the engine."""
    ckpt = _save_window_ckpt(tmp_path)
    n = 30
    with sim_session(keys=[], n_frames=n, faces=face_track(n)):
        live.infer_stream(
            ckpt, StreamConfig(max_t=20, warmup_min=4, pipeline="threaded"))
    out = capsys.readouterr().out
    assert f"produced={n} consumed={n} dropped=0" in out


def test_infer_stream_carry_engine(tmp_path):
    """engine=carry: O(1)-per-frame incremental GRU on a uni-GRU checkpoint
    (the incremental streaming upgrade; causal delta/standardization
    frontend)."""
    ckpt = _save_unigru_ckpt(tmp_path)
    n = 24
    with sim_session(keys=[], n_frames=n, faces=face_track(n)) as (cv2f, _, _):
        live.infer_stream(ckpt, StreamConfig(engine="carry", pred_every=2))
    # the overlay ran with a real prediction at least once
    assert any("(" in t and ")" in t for t in cv2f.texts)


def test_infer_stream_carry_threaded(tmp_path, capsys):
    ckpt = _save_unigru_ckpt(tmp_path)
    n = 20
    with sim_session(keys=[], n_frames=n, faces=face_track(n)):
        live.infer_stream(ckpt, StreamConfig(engine="carry",
                                             pipeline="threaded"))
    assert f"produced={n} consumed={n} dropped=0" in capsys.readouterr().out


def test_infer_stream_threaded_face_loss(tmp_path, capsys):
    """Face-lost frames travel through the ring as flagged sentinels (never
    silently skipped), resetting the carry engine in order; the run stays
    clean across the gaps."""
    ckpt = _save_unigru_ckpt(tmp_path)
    n = 24
    faces = face_track(n)
    for i in (8, 9, 10, 16):  # two face-lost gaps mid-stream
        faces[i] = None
    with sim_session(keys=[], n_frames=n, faces=faces):
        live.infer_stream(ckpt, StreamConfig(engine="carry",
                                             pipeline="threaded"))
    assert f"produced={n} consumed={n} dropped=0" in capsys.readouterr().out


def test_flagged_source_resets_frontend_producer_side():
    """_flagged_source must call front_lost_fn on its own (producer) thread
    IN ORDER with the produce() calls around the gap — resetting frontend
    state from the dispatch thread instead would let the first post-gap
    frame splice a delta against seconds-old state (the bug this split
    fixes)."""
    import threading

    events = []
    frames = [(np.zeros((4, 4, 3), np.uint8), i * 33) for i in range(5)]
    faces = [object(), object(), None, object(), None]

    class Cam:
        def frames(self):
            return iter(frames)

    class Lm:
        def __init__(self):
            self.i = -1

        def detect(self, frame):
            self.i += 1
            return faces[self.i]

    def produce(face, frame, w, h, prev_xy):
        events.append(("produce", threading.get_ident()))
        return np.ones(3, np.float32), 0.5, None, None

    def front_lost():
        events.append(("lost", threading.get_ident()))

    ui = {"frame": None, "seq": 0, "open": 0.0}
    out = list(live._flagged_source(
        Cam(), Lm(), threading.Event(), threading.Lock(), ui, produce,
        front_lost, feat_dim=4))

    kinds = [k for k, _ in events]
    assert kinds == ["produce", "produce", "lost", "produce", "lost"]
    # every callback ran on the consuming (producer) thread
    assert {t for _, t in events} == {threading.get_ident()}
    # all 5 frames travel the ring; lost ones carry flag 0; the first valid
    # frame AFTER a gap re-announces it with flag 2 (latched: a full ring
    # can drop the 0 sentinel itself, and the reset must survive that)
    assert [int(p[0][0]) for p in out] == [1, 1, 0, 2, 0]
    assert ui["seq"] == 5


def test_flagged_source_latch_survives_dropped_sentinel():
    """The causal-reset latch clears only when a flagged frame is ACCEPTED
    by the ring (LivePipeline feeds push's result back via generator send):
    a full ring that drops the 0.0 sentinel — and even the first flag-2.0
    frame — must see the gap re-announced until one flagged frame lands."""
    import threading

    frames = [(np.zeros((4, 4, 3), np.uint8), i * 33) for i in range(6)]
    faces = [object(), None, object(), object(), object(), object()]

    class Cam:
        def frames(self):
            return iter(frames)

    class Lm:
        def __init__(self):
            self.i = -1

        def detect(self, frame):
            self.i += 1
            return faces[self.i]

    def produce(face, frame, w, h, prev_xy):
        return np.ones(3, np.float32), 0.5, None, None

    ui = {"frame": None, "seq": 0, "open": 0.0}
    gen = live._flagged_source(Cam(), Lm(), threading.Event(),
                               threading.Lock(), ui, produce, lambda: None,
                               feat_dim=4)
    flags = [int(next(gen)[0][0])]
    # per-frame ring verdicts: frame0 accepted; the sentinel dropped; the
    # first flag-2 frame dropped too; then accepted
    for accepted in (True, False, False, True, True):
        flags.append(int(gen.send(accepted)[0][0]))
    assert flags == [1, 0, 2, 2, 1, 1]


def test_threaded_carry_stream_bitwise_equals_sequential(tmp_path,
                                                         monkeypatch):
    """pipeline=threaded must preserve the sequential loop's semantics
    EXACTLY: same engine pushes in the same order with bitwise-identical
    logits — including across face-loss gaps, where the causal resets are
    split across two threads (the ring's FIFO order is the proof)."""
    import silent_speech.infer.streaming as S

    ckpt = _save_unigru_ckpt(tmp_path)
    records = []
    orig = S.CarryStreamingGRU.push

    def spy(self, feat):
        out = orig(self, feat)
        records.append(np.asarray(out).copy())
        return out

    monkeypatch.setattr(S.CarryStreamingGRU, "push", spy)

    def run(pipeline):
        n = 24
        faces = face_track(n)
        for i in (8, 9, 16):
            faces[i] = None
        records.clear()
        with sim_session(keys=[], n_frames=n, faces=faces):
            live.infer_stream(ckpt, StreamConfig(engine="carry",
                                                 pipeline=pipeline))
        return list(records)

    seq = run("sequential")
    thr = run("threaded")
    assert len(seq) == len(thr) and len(seq) == 24 - 3
    for a, b in zip(seq, thr):
        np.testing.assert_array_equal(a, b)


def test_threaded_window_stream_equals_sequential(tmp_path, monkeypatch):
    """Same equivalence for the sliding-window family: identical
    (pred, conf) event sequence through the ring as through the
    single-thread loop."""
    import silent_speech.infer.streaming as S

    ckpt = _save_window_ckpt(tmp_path)
    events = []
    orig = S.SlidingWindowEngine.push

    def spy(self, feat):
        out = orig(self, feat)
        if out is not None:
            events.append((out[0], float(out[1])))
        return out

    monkeypatch.setattr(S.SlidingWindowEngine, "push", spy)

    def run(pipeline):
        n = 30
        events.clear()
        with sim_session(keys=[], n_frames=n, faces=face_track(n)):
            live.infer_stream(ckpt, StreamConfig(max_t=20, warmup_min=4,
                                                 pipeline=pipeline))
        return list(events)

    seq = run("sequential")
    thr = run("threaded")
    assert seq and seq == thr


def test_infer_stream_engine_guards(tmp_path):
    """engine=carry on a non-unigru checkpoint and unknown engine/pipeline
    values fail loudly before any camera opens."""
    ckpt = _save_window_ckpt(tmp_path)
    with pytest.raises(ValueError, match="uni-GRU"):
        live.infer_stream(ckpt, StreamConfig(engine="carry"))
    with pytest.raises(ValueError, match="unknown engine"):
        live.infer_stream(ckpt, StreamConfig(engine="bogus"))
    with pytest.raises(ValueError, match="unknown pipeline"):
        live.infer_stream(ckpt, StreamConfig(pipeline="bogus"))


def test_threaded_host_advisory(monkeypatch, capsys):
    """pipeline=threaded prints the 1-core advisory exactly when
    os.cpu_count() == 1."""
    import os

    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    live._advise_threaded_host()
    assert "single-CPU-core host" in capsys.readouterr().out
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    live._advise_threaded_host()
    assert capsys.readouterr().out == ""


def test_infer_ctc_loop(tmp_path, capsys):
    from silent_speech.models import ctc_model

    params = jax.tree.map(np.asarray, ctc_model.init_params(
        jax.random.PRNGKey(0), 180, hidden=16, gru_layers=2, roi_emb=4))
    meta = dict(max_t=40, uniq_labels=["yes", "no", "hello"],
                len_lambda=0.02, exp_len=5)
    ckpt = str(tmp_path / "ctc.ckpt")
    save_checkpoint(ckpt, params, meta)
    n = 26
    with sim_session(keys=_keys(n, r=(2, 20)), n_frames=n,
                     faces=face_track(n)):
        live.infer_ctc(ckpt)
    out = capsys.readouterr().out
    # reference console contract (facial_landmark_detection.py:290,371-391)
    assert "Loaded ROI+CTC model. max_t =" in out
    assert "Recording stopped. frames=" in out
    assert "raw T" in out and "trimmed T" in out
    assert "Prediction:" in out and "Top3:" in out

    # async scoring: camera keeps rolling during the dictionary sweep; the
    # result lands during the run or via the exit drain
    with sim_session(keys=_keys(n, r=(2, 20)), n_frames=n,
                     faces=face_track(n)):
        live.infer_ctc(ckpt, predict_async=True)
    assert "Prediction:" in capsys.readouterr().out


def test_record_saves_reference_schema_clip(tmp_path, capsys):
    out = tmp_path / "clips"
    cfg = RecorderConfig(out_dir=str(out), speaker="sim", min_frames=5)
    n = 30
    # '2' selects WORDS[1]='no', then record frames 5..24
    keys = _keys(n, r=(5, 24))
    keys[1] = ord("2")
    with sim_session(keys=keys, n_frames=n, faces=face_track(n)):
        record.main(cfg)
    files = sorted(os.listdir(out))
    assert len(files) == 1 and files[0].startswith("sim_no_")
    clip = load_clip(str(out / files[0]))
    assert clip.X.shape[1] == 180 and clip.label == "no"
    assert clip.roi is not None and clip.roi.shape[1:] == (48, 96)
    assert "saved" in capsys.readouterr().out


def test_record_dynamic_mode_locks_selection(tmp_path):
    out = tmp_path / "dyn"
    cfg = RecorderConfig(out_dir=str(out), speaker="sim", min_frames=5,
                         idxs_mode="dynamic", save_roi=False)
    n = 30
    with sim_session(keys=_keys(n, r=(3, 25)), n_frames=n,
                     faces=face_track(n)):
        record.main(cfg)
    files = os.listdir(out)
    assert len(files) == 1
    clip = load_clip(str(out / files[0]))
    # dynamic selection: idxs stored per clip, span-norm feature dim = 2K+1
    # (xy pairs + velocity, inactive/lower_face_record.py semantics)
    assert clip.X.shape[1] == 2 * len(clip.idxs) + 1


def test_record_v2_ema_settles_before_recording(tmp_path):
    """roi_ema mode (recorder v2): the center/scale EMA updates on EVERY
    detected frame so it settles BEFORE recording starts, resets on face
    loss (record_landmarks_v2.py:231-232,245-247), and the saved clip's ROI
    uses the stabilized values."""
    from silent_speech.core.landmark_select import EMA

    out = tmp_path / "clips"
    cfg = RecorderConfig(out_dir=str(out), speaker="sim", min_frames=5,
                         roi_ema_alpha=0.3)
    n = 30
    updates = []
    orig = EMA.update

    def spy(self, value):
        updates.append(np.asarray(value, np.float64))
        return orig(self, value)

    faces = face_track(n)
    faces[1] = None  # face loss before recording: stabilizer resets
    with sim_session(keys=_keys(n, r=(10, 25)), n_frames=n, faces=faces):
        import unittest.mock as mock

        with mock.patch.object(EMA, "update", spy):
            record.main(cfg)
    # EMA updated on (nearly) every detected frame, not only the ~14
    # recorded ones: 28 detected frames after the face-loss reset
    assert len(updates) >= n - 5
    assert len(os.listdir(out)) == 1


def test_record_timed_countdown_saves_npz_and_mp4(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(record_timed, "COUNTDOWN_S", 0.02)
    monkeypatch.setattr(record_timed, "RECORD_S", 0.25)
    out = tmp_path / "timed"
    vids = tmp_path / "videos"
    cfg = RecorderConfig(out_dir=str(out), videos_dir=str(vids),
                         speaker="sim", min_frames=5)
    n = 200
    keys = _keys(n, space=2)
    with sim_session(keys=keys, n_frames=n,
                     faces=face_track(n)) as (cv2f, cam, _):
        cam.frame_delay = 0.004  # pace the wall-clock state machine
        record_timed.main(cfg)
    npz = [f for f in os.listdir(out) if f.endswith(".npz")]
    assert len(npz) == 1
    assert len(cv2f.writers) == 1
    vw = cv2f.writers[0]
    # the labeled video goes to the SEPARATE videos_dir under the
    # reference's {word}_{id:03d}.mp4 convention (record_training_data.py)
    assert vw.path == str(vids / "yes_001.mp4")
    assert vw.frames_written >= 5 and vw.released
    outtext = capsys.readouterr().out
    assert "Saved: yes_001" in outtext
    assert "VIDEO COLLECTION PROGRESS" in outtext
    assert "LIP READING TRAINING DATA RECORDER" in outtext


def test_progress_summary_counts_videos_with_npz_fallback(tmp_path, capsys):
    """The dashboard counts VIDEOS (the reference's rule); with no videos it
    falls back to npz-label counts so `status` stays useful for corpora from
    the non-timed recorder."""
    vids = tmp_path / "videos"
    clips = tmp_path / "clips"
    clips.mkdir()
    from silent_speech.core.schema import Clip, clip_filename, save_clip

    X = np.zeros((10, 4), np.float32)
    for i in range(3):
        c = Clip(X=X, ts=np.arange(10), label="yes", speaker="s")
        save_clip(c, str(clips / clip_filename("s", "yes", 0, i)))
    record_timed.print_progress_summary(str(vids),
                                        npz_fallback_dir=str(clips))
    out = capsys.readouterr().out
    assert "  yes      [" in out and "  3/100" in out

    # a video present -> videos are authoritative, fallback ignored
    vids.mkdir()
    (vids / "no_001.mp4").write_bytes(b"")
    record_timed.print_progress_summary(str(vids),
                                        npz_fallback_dir=str(clips))
    out = capsys.readouterr().out
    assert "  no       [" in out and "  1/100" in out
    assert "yes      [░░░░░░░░░░░░░░░░░░░░]   0/100" in out


def test_viewer_apps_run(capsys):
    n = 10
    with sim_session(keys=[], n_frames=n, faces=face_track(n)) as (cv2f, _, _):
        landmarks_view.main()
    assert "Face Dots Only" in cv2f.windows  # reference WINDOW_NAME
    assert "FACE DETECTED" in cv2f.texts
    with sim_session(keys=[], n_frames=n, faces=face_track(n)) as (cv2f, _, _):
        important_landmarks.main()
    assert "Live Demonstration" in cv2f.windows  # reference WINDOW_NAME
    assert any("selected=" in t for t in cv2f.texts)
    assert any(t.startswith("MOUTH:") for t in cv2f.texts)
    assert any("LOWER FACE + CHEEK PREDICTION" == t for t in cv2f.texts)


def test_landmarks_view_branches():
    """all_landmarks.py contract: every index labeled (label_every thins
    them), NO FACE branch on face loss, 'q' quits early, handles released."""
    n = 6
    faces = face_track(n)
    faces[2] = None  # one face-lost frame
    with sim_session(keys=[], n_frames=n, faces=faces) as (cv2f, cam, lm):
        landmarks_view.main(label_every=100)
    assert "NO FACE" in cv2f.texts and "FACE DETECTED" in cv2f.texts
    assert "q to quit" in cv2f.texts
    # label_every=100 -> only indices 0, 100, 200, 300, 400 get labels
    idx_labels = [t for t in cv2f.texts if t.isdigit()]
    assert set(idx_labels) == {"0", "100", "200", "300", "400"}
    assert cam.released and lm.closed and cv2f.destroyed

    with sim_session(keys=_keys(4, q=1), n_frames=4,
                     faces=face_track(4)) as (cv2f, cam, lm):
        landmarks_view.main()
    assert len(cv2f.windows) == 2  # frames 0 and 1 shown, then quit
    assert cam.released and lm.closed and cv2f.destroyed
    # default label_every=1 labels every mesh index
    assert sum(t.isdigit() for t in cv2f.texts) == 2 * 468


def test_important_landmarks_staged_prediction_keys():
    """Number keys stage the demo prediction overlay with a random 0.6-0.9
    confidence and a 2 s expiry (important_landmarks.py:188-242); ESC does
    NOT trigger a staged word (the reference's `key in (27, 'N')` latent bug
    is consciously not copied)."""
    n = 12
    keys = [-1] * n
    keys[3] = ord("8")  # -> FAHHH
    with sim_session(keys=keys, n_frames=n, faces=face_track(n)) as (cv2f, _, _):
        important_landmarks.main()
    preds = [t for t in cv2f.texts if t.startswith("PREDICTION:")]
    assert any("FAHHH" in t for t in preds)
    confs = [float(t.split()[-1]) for t in cv2f.texts if t.startswith("CONF:")]
    assert any(0.6 <= c <= 0.9 for c in confs)
    # before the key press the overlay shows the un-staged state
    assert preds[0] == "PREDICTION: None"


def test_cli_sim_mode(tmp_path, capsys):
    """`python -m silent_speech infer-live ckpt_path=... sim=N` drives the
    full app headlessly; same for the recorder."""
    ckpt = _save_ckpt(tmp_path)
    rc = cli.main(["infer-live", f"ckpt_path={ckpt}", "sim=30"])
    assert rc == 0
    assert "Top3:" in capsys.readouterr().out

    out = tmp_path / "cli_clips"
    rc = cli.main(["record", f"out_dir={out}", "speaker=sim", "sim=30"])
    assert rc == 0
    assert len(os.listdir(out)) == 1


def test_doctor_reports_wedged_backend(monkeypatch, capsys):
    """A backend that fails to initialize yields a FAIL line naming the
    error, and the checks that need no device still run."""
    import jax

    from silent_speech.apps import doctor

    def broken(*a, **k):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", broken)
    rc = doctor.run_doctor()
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL" in out and "Unable to initialize backend" in out
    # non-jax checks still ran
    assert "native npz loader" in out


def test_doctor_healthy_backend(capsys):
    """With a live (CPU) backend the doctor passes end-to-end."""
    from silent_speech.apps import doctor

    rc = doctor.run_doctor()
    out = capsys.readouterr().out
    assert "jit smoke" in out and "mesh" in out
    assert rc == 0 or "FAILURE" in out


def test_cli_predict_single_clip(tmp_path, capsys):
    """`predict ckpt_path=... clip=<npz|glob>` runs the live predict block
    on already-recorded clips — the offline counterpart of infer-live's
    clip predict, routed through load_predictor so every checkpoint family
    works."""
    ckpt = _save_ckpt(tmp_path, bias_word="hello")
    out = tmp_path / "clips"
    rc = cli.main(["record", f"out_dir={out}", "speaker=sim", "sim=30"])
    assert rc == 0
    clip = os.path.join(str(out), os.listdir(out)[0])

    rc = cli.main(["predict", f"ckpt_path={ckpt}", f"clip={clip}", "k=2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(clip + ":") and "hello" in line

    # glob form sweeps every match
    rc = cli.main(["predict", f"ckpt_path={ckpt}",
                   f"clip={out}/*.npz"])
    assert rc == 0
    assert clip in capsys.readouterr().out

    # missing args -> usage, not a traceback
    assert cli.main(["predict", f"ckpt_path={ckpt}"]) == 2


def test_cli_predict_routes_ctc_checkpoint(tmp_path, capsys):
    """`predict` on a CTC checkpoint runs the dictionary-scored route on the
    clip (the offline counterpart of infer-ctc) instead of erroring like
    load_predictor's official/variant routing would."""
    from silent_speech.models import ctc_model

    params = jax.tree.map(np.asarray, ctc_model.init_params(
        jax.random.PRNGKey(0), 180, hidden=16, gru_layers=2, roi_emb=4))
    meta = dict(max_t=40, vocab=ctc_model.VOCAB,
                uniq_labels=["yes", "no", "hello"],
                len_lambda=0.02, exp_len=5)
    ckpt = str(tmp_path / "ctc.ckpt")
    save_checkpoint(ckpt, params, meta)
    out = tmp_path / "clips"
    rc = cli.main(["record", f"out_dir={out}", "speaker=sim", "sim=30"])
    assert rc == 0
    clip = os.path.join(str(out), os.listdir(out)[0])
    rc = cli.main(["predict", f"ckpt_path={ckpt}", f"clip={clip}", "k=2"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    # two (word, score) pairs from the 3-word dictionary
    assert line.startswith(clip + ": [(") and line.count("(") == 2


def test_cli_train_exposes_function_kwargs(monkeypatch, capsys):
    """`train resume_from=... metrics_path=...` reaches train() as function
    kwargs (they are not TrainConfig fields) — without the plumbing the
    resume path exists but no user surface can invoke it. The resume
    semantics themselves are pinned by test_metrics_resume."""
    import silent_speech.train as train_pkg

    seen = {}

    def fake_train(cfg, **kw):
        seen.update(kw, clip_dir=cfg.clip_dir)
        return {}

    monkeypatch.setattr(train_pkg, "train", fake_train)
    rc = cli.main(["train", "clip_dir=somewhere",
                   "resume_from=old.ckpt", "metrics_path=m.jsonl"])
    assert rc == 0
    assert seen == dict(resume_from="old.ckpt", metrics_path="m.jsonl",
                        clip_dir="somewhere")

    # a non-train command still rejects these keys as unknown options
    rc = cli.main(["eval-dataset", "ckpt_path=x", "resume_from=old.ckpt"])
    assert rc != 0
    assert "resume_from" in capsys.readouterr().err
