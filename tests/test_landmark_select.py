"""Dynamic landmark selection, EMA smoothing, hysteresis, legacy features."""

import numpy as np

import jax.numpy as jnp

from silent_speech.core.landmark_select import (
    EMA,
    Hysteresis,
    NOSE_SET,
    compute_selected_indices,
    expand_by_index_neighbors,
)
from silent_speech.ops.features import (
    mouth83_features_batched,
    polygon_area,
    v3_features_batched,
)


def test_expand_by_index_neighbors():
    out = expand_by_index_neighbors({100}, 1)
    assert out == {98, 99, 100, 101, 102}
    # clamped at mesh bounds
    low = expand_by_index_neighbors({0}, 1)
    assert low == {0, 1, 2}
    assert expand_by_index_neighbors({5}, 0) == {5}


def test_compute_selected_indices(rng):
    """Pins the exact reference rule (lower_face_record.py:36,48-62):
    cutoff = max-y over the nose-BOTTOM anchors + 0.003, cheek set = the
    dynamic scripts' own outline, nose set = the 47-entry fat set."""
    from silent_speech.core.landmark_select import (
        CHEEK_SET,
        CUT_MARGIN,
        NOSE_BOTTOM_FOR_CUTOFF,
    )

    lm = rng.random((468, 2)).astype(np.float32)
    sel = compute_selected_indices(lm)
    sel_set = set(sel.tolist())
    assert not (sel_set & NOSE_SET)
    assert len(NOSE_SET) == 48
    cut_y = max(lm[i, 1] for i in NOSE_BOTTOM_FOR_CUTOFF) + CUT_MARGIN
    below = {i for i in range(468) if lm[i, 1] > cut_y}
    assert sel_set == (below | CHEEK_SET) - NOSE_SET
    assert sel.dtype == np.int32 and (np.diff(sel) > 0).all()


def test_ema_and_hysteresis():
    e = EMA(alpha=0.5)
    np.testing.assert_allclose(e.update([2.0, 4.0]), [2.0, 4.0])
    np.testing.assert_allclose(e.update([4.0, 8.0]), [3.0, 6.0])
    e.reset()
    np.testing.assert_allclose(e.update([1.0, 1.0]), [1.0, 1.0])

    h = Hysteresis(low=0.2, high=0.5)
    assert not h.update(0.4)   # below high: stays closed
    assert h.update(0.6)       # opens
    assert h.update(0.3)       # above low: stays open
    assert not h.update(0.1)   # closes


def test_legacy_feature_dims(rng):
    lms = (0.2 + 0.6 * rng.random((2, 6, 468, 3))).astype(np.float32)
    f83 = mouth83_features_batched(jnp.asarray(lms), 640, 480)
    assert f83.shape == (2, 6, 83)
    f177 = v3_features_batched(jnp.asarray(lms), 640, 480)
    assert f177.shape == (2, 6, 177)
    # vel[0] must be zero in both
    assert float(np.abs(np.asarray(f83)[:, 0, -1]).max()) == 0.0
    assert float(np.abs(np.asarray(f177)[:, 0, -1]).max()) == 0.0

    sq = jnp.asarray([[0, 0], [2, 0], [2, 3], [0, 3]], jnp.float32)
    assert float(polygon_area(sq)) == 6.0


def test_span_norm_dynamic_selection(rng):
    """Dynamic-selection features: batched == single-frame host path, and
    variable dims per selection (the source of mixed-dim corpora)."""
    import jax.numpy as jnp

    from silent_speech.ops.features import (
        span_norm_feature_frame,
        span_norm_features_batched,
    )

    lms = (0.2 + 0.6 * rng.random((468, 3))).astype(np.float32)
    lms[2, 1] = 0.45
    sel = compute_selected_indices(lms[:, :2])
    feat, xy_n, center, span = span_norm_feature_frame(lms, 640, 480, sel, None)
    assert feat.shape == (2 * len(sel) + 1,)
    assert feat[-1] == 0.0  # first frame: vel = 0

    fb = span_norm_features_batched(
        jnp.asarray(lms[None, None]), jnp.asarray(sel), 640, 480)
    np.testing.assert_allclose(np.asarray(fb)[0, 0], feat, atol=2e-4)

    # a different cutoff -> different selection -> different feature dim
    lms2 = lms.copy()
    lms2[2, 1] = 0.8
    sel2 = compute_selected_indices(lms2[:, :2])
    assert len(sel2) != len(sel)
