"""chip_smoke.py's pure helpers, and its refusal to run without a GPU."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("delta,flip,ok", [
    (0.0, False, True),
    (9e-4, False, True),
    (2e-3, False, False),
    (1e-6, True, False),
    (np.nan, False, False),
])
def test_compare_logits(delta, flip, ok):
    ref = np.array([[0.0, 1.0, 0.5], [2.0, -1.0, 0.0]], np.float32)
    got = ref + delta
    if flip:
        got[0] = [1.0, 0.0, 0.5]
    res = cs.compare_logits(got, ref)
    assert res["ok"] is ok
    assert res["finite"] is bool(np.isfinite(delta))
    if not np.isfinite(delta):
        return
    assert res["argmax_equal"] is (not flip)
    if not flip:
        assert res["max_abs"] == pytest.approx(abs(delta), abs=1e-7)


def test_compare_logits_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="shape"):
        cs.compare_logits(np.zeros((2, 3)), np.zeros((3, 3)))


@pytest.mark.parametrize("losses,falls", [
    ([2.3, 2.1], True),
    ([2.3, 2.4, 2.0], True),
    ([2.3, 2.3], False),
    ([2.3, float("nan"), 1.0], False),
    ([2.3], False),
])
def test_loss_falls(losses, falls):
    assert cs.loss_falls(losses) is falls


def test_last_line_is_the_contract():
    line = cs.last_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": np.int64(1), "extra": "ignored"})
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_alternate_medians_runs_in_turns():
    order = []
    a, b = cs.alternate_medians(lambda: order.append("a"),
                                lambda: order.append("b"), calls=2)
    assert order == list("aabbbbaa")
    assert a >= 0 and b >= 0


@pytest.mark.parametrize("delta,want", [
    (0.0, 0.0),
    (1e-5, 1e-5 / 4.0),
    (-2e-3, 2e-3 / 4.0),
])
def test_grad_drift_is_relative_to_the_update(delta, want):
    """SGD(lr=1) updates recovered from parameters, compared per leaf
    against that leaf's largest update; a leaf that did not move is
    skipped rather than divided by zero."""
    before = {"w": np.array([1.0, 2.0, 3.0]), "frozen": np.ones(2)}
    a = {"w": before["w"] - np.array([4.0, -1.0, 0.5]),
         "frozen": np.ones(2)}
    b = {"w": a["w"] + np.array([0.0, delta, 0.0]), "frozen": np.ones(2)}
    assert cs.grad_drift(before, a, b) == pytest.approx(want, rel=1e-9,
                                                        abs=1e-15)


def test_fmt_memory():
    ma = types.SimpleNamespace(argument_size_in_bytes=2 ** 20,
                               temp_size_in_bytes=3 * 2 ** 20)
    out = cs.fmt_memory(ma)
    assert "argument=1.00MiB" in out and "temp=3.00MiB" in out
    assert "output=0.00MiB" in out


def test_check_raises():
    cs.check(True, "fine")
    with pytest.raises(AssertionError, match="broken"):
        cs.check(False, "broken")


def test_exits_nonzero_without_gpu():
    """On the CPU the script prints no result and exits non-zero."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "no GPU" in proc.stderr
