"""Live pipeline: producer/ring/consumer integration with a synthetic source
feeding a real streaming engine end to end."""

import numpy as np

import jax

from silent_speech.core.config import StreamConfig
from silent_speech.infer import SlidingWindowEngine
from silent_speech.models.variants import (
    gru_word_classifier_forward,
    init_gru_word_classifier,
)
from silent_speech.runtime.pipeline import FramePacker, LivePipeline


def test_packer_roundtrip(rng):
    p = FramePacker(feat_dim=180, roi_hw=(48, 96))
    feat = rng.standard_normal(180).astype(np.float32)
    roi = rng.integers(0, 256, (48, 96), dtype=np.uint8)
    payload = p.pack(feat, roi)
    assert payload.nbytes == p.slot_bytes
    f2, r2 = p.unpack(payload)
    np.testing.assert_array_equal(f2, feat)
    np.testing.assert_array_equal(r2, roi)

    p2 = FramePacker(feat_dim=83)
    f3, r3 = p2.unpack(p2.pack(feat[:83], None))
    np.testing.assert_array_equal(f3, feat[:83])
    assert r3 is None


def test_pipeline_streams_through_engine(rng):
    """Synthetic 200-frame stream through the ring into a jitted
    sliding-window predictor — every frame consumed, predictions fire."""
    params = init_gru_word_classifier(jax.random.PRNGKey(0), 83, 5, hidden=16,
                                      num_layers=1)

    @jax.jit
    def fwd(X):
        return gru_word_classifier_forward(params, X)

    engine = SlidingWindowEngine(
        fwd, 83, StreamConfig(max_t=20, pred_every=2, warmup_min=10))
    preds = []

    def sink(feat, roi, ts):
        out = engine.push(feat)
        if out is not None:
            preds.append((ts, out[0], out[1]))

    N = 200
    def source():
        for i in range(N):
            yield rng.standard_normal(83).astype(np.float32), None, i * 33

    pipe = LivePipeline(source(), sink, FramePacker(feat_dim=83), capacity=64)
    stats = pipe.run(timeout=60)

    assert stats["produced"] == N
    # unpaced producer: the ring may drop under backpressure (by design),
    # but every frame is either consumed or counted as dropped
    assert stats["consumed"] + stats["dropped"] == N
    assert stats["consumed"] >= 30
    assert len(preds) > 5
    # timestamps preserved through the ring
    assert all(ts % 33 == 0 for ts, _, _ in preds)
    assert "sink" in stats["stages"] and stats["stages"]["sink"]["n"] > 0


def test_pipeline_drains_on_worker_death(rng):
    """A sink that dies mid-run must flip ``drained`` (the apps' UI-loop exit
    condition) even though items remain in the ring — otherwise a headless
    run spins forever hiding the error — and finish() re-raises it."""
    import time

    import pytest

    def sink(feat, roi, ts):
        raise RuntimeError("predictor exploded")

    def source():
        for i in range(50):
            yield rng.standard_normal(8).astype(np.float32), None, i

    pipe = LivePipeline(source(), sink, FramePacker(feat_dim=8), capacity=16)
    pipe.start()
    deadline = time.monotonic() + 10
    while not pipe.drained:
        assert time.monotonic() < deadline, "drained never became True"
        time.sleep(0.001)
    with pytest.raises(RuntimeError, match="pipeline worker failed"):
        pipe.finish(timeout=10)


def test_pipeline_state_before_start(rng):
    """A constructed-but-not-started pipeline answers state queries sanely
    instead of raising AttributeError."""
    pipe = LivePipeline(iter(()), lambda f, r, t: None,
                        FramePacker(feat_dim=4))
    assert pipe.running is False
    assert pipe.drained is False
    assert pipe.stats()["hung"] == []
    assert pipe.finish(timeout=0)["produced"] == 0


def test_pipeline_stop_discards_backlog(rng):
    """stop() (user quit) must not keep launching sink dispatches for the
    ring backlog: only the in-flight sink call lands; the rest is discarded
    (counted) so the app can exit promptly — while a natural end-of-source
    (test_pipeline_streams_through_engine) still drains everything."""
    import threading
    import time

    release = threading.Event()
    sunk = []

    def sink(feat, roi, ts):
        sunk.append(ts)
        release.wait(20)  # the slow predict the backlog accumulates behind
        release.clear()

    N = 40
    def source():
        for i in range(N):
            yield rng.standard_normal(4).astype(np.float32), None, i

    pipe = LivePipeline(source(), sink, FramePacker(feat_dim=4), capacity=64)
    pipe.start()
    deadline = time.monotonic() + 10
    while not sunk and time.monotonic() < deadline:
        time.sleep(0.001)  # consumer is now inside the slow sink call
    while pipe._tp.is_alive() and time.monotonic() < deadline:
        time.sleep(0.001)  # producer has queued the whole backlog
    pipe.stop()
    release.set()  # land the in-flight dispatch
    stats = pipe.finish(timeout=10)
    assert stats["produced"] == N
    assert len(sunk) == stats["consumed"] == 1  # nothing dispatched post-quit
    assert stats["discarded"] == N - 1 - stats["dropped"]
    assert stats["consumed"] + stats["dropped"] + stats["discarded"] == N


def test_pipeline_finish_reports_hung_worker(rng):
    """finish(timeout) must not shape a still-running worker as a clean
    drain: the stats carry the hung worker's name (e.g. a dispatch thread
    stuck inside a first device compile when the user quits)."""
    import threading

    release = threading.Event()
    entered = threading.Event()

    def sink(feat, roi, ts):
        entered.set()
        release.wait(20)  # simulates a long device dispatch

    def source():
        yield rng.standard_normal(4).astype(np.float32), None, 0

    pipe = LivePipeline(source(), sink, FramePacker(feat_dim=4), capacity=4)
    pipe.start()
    try:
        # the scenario is a dispatch IN FLIGHT when the user quits — wait for
        # the sink to be entered first (stop() before that would discard the
        # frame instead, by design)
        assert entered.wait(5)
        pipe.stop()
        stats = pipe.finish(timeout=0.2)
        assert stats["hung"] == ["consumer"]
        assert stats["produced"] == 1
    finally:
        release.set()  # let the daemon thread exit promptly
