"""Streaming inference engines — BASELINE config #4.

Three reference streaming behaviors, rebuilt around persistent device state:

- ``SlidingWindowEngine``: rolling feature buffer, re-scored every Nth frame
  after a warmup (inactive/live_feed.py:154-227). The window forward is one
  jitted program with a fixed (1, max_t, D) shape, so every prediction after
  the first hits the jit cache; the host keeps only a bounded deque.
- ``OpennessGate``: the hysteresis auto-clip segmentation state machine
  (inactive/live_lower_half.py:143-151 + its main loop): speaking starts
  after ``start_n`` consecutive frames above ``open_thresh``, the clip ends
  after ``end_n`` frames below (or at ``max_clip``), and the finished clip is
  emitted for prediction.
- ``CarryStreamingGRU``: the upgrade the reference couldn't do —
  for unidirectional GRU models the hidden carry *is* the context, so each
  frame is a single jitted incremental step with cached carry instead of
  re-running the whole window (O(1) per frame, exact equality with the full
  scan is tested).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import StreamConfig
from ..ops.gru import gru_cell_step


def stream_probs(logits: np.ndarray) -> np.ndarray:
    """Stable softmax for the streaming engines' per-frame logits.

    Single definition for every streaming consumer (SlidingWindowEngine and
    the apps' carry push path). Deliberately NOT shared with
    infer.predictor.topk_from_logits, which pins the reference's exact
    formatted-output math (float64, no epsilon,
    live_infer_official.py:223-226)."""
    logits = np.asarray(logits)
    p = np.exp(logits - logits.max())
    p /= p.sum() + 1e-9
    return p


class SlidingWindowEngine:
    """Rolling-buffer word scorer.

    ``forward(X_padded (1, max_t, D)) -> logits (1, C)`` is any jitted window
    model (e.g. the 83-D GRUWordClassifier). Feed frames with
    ``push(feat) -> Optional[(label_id, conf, probs)]``.
    """

    def __init__(
        self,
        forward: Callable,
        input_dim: int,
        cfg: StreamConfig = StreamConfig(),
    ):
        self.forward = forward
        self.input_dim = input_dim
        self.cfg = cfg
        self.buf: deque = deque(maxlen=cfg.max_t)
        self.frame_idx = 0
        self.warmup = min(cfg.warmup_min, cfg.max_t)

    def reset(self):
        self.buf.clear()
        self.frame_idx = 0

    def push(self, feat: np.ndarray):
        self.buf.append(np.asarray(feat, np.float32))
        self.frame_idx += 1
        if len(self.buf) < self.warmup or self.frame_idx % self.cfg.pred_every:
            return None
        X = np.zeros((self.cfg.max_t, self.input_dim), np.float32)
        seq = np.stack(self.buf)
        t = min(len(seq), self.cfg.max_t)
        X[:t] = seq[:t]
        logits = np.asarray(self.forward(jnp.asarray(X[None])))[0]
        p = stream_probs(logits)
        pred = int(p.argmax())
        return pred, float(p[pred]), p


@dataclasses.dataclass
class ClipEvent:
    """Emitted by OpennessGate when a gated clip completes."""

    frames: np.ndarray  # (T, D) features collected during the clip
    rois: Optional[np.ndarray]  # (T, H, W) or None


class OpennessGate:
    """Hysteresis-counter speech gating (VAD-like clip segmentation)."""

    def __init__(self, cfg: StreamConfig = StreamConfig()):
        self.cfg = cfg
        self.speaking = False
        self.above = 0
        self.below = 0
        self.bufX: list[np.ndarray] = []
        self.bufR: list[np.ndarray] = []

    def reset(self):
        self.speaking = False
        self.above = self.below = 0
        self.bufX, self.bufR = [], []

    def push(
        self, openness: float, feat: np.ndarray, roi: Optional[np.ndarray] = None
    ) -> Optional[ClipEvent]:
        """Feed one frame; returns a ClipEvent when a clip just ended."""
        cfg = self.cfg
        if not self.speaking:
            if openness > cfg.open_thresh:
                self.above += 1
                if self.above >= cfg.start_n:
                    self.speaking = True
                    self.below = 0
                    self.bufX, self.bufR = [], []
            else:
                self.above = 0
            return None
        # speaking: collect
        self.bufX.append(np.asarray(feat, np.float32))
        if roi is not None:
            self.bufR.append(np.asarray(roi))
        if openness <= cfg.open_thresh:
            self.below += 1
        else:
            self.below = 0
        if self.below >= cfg.end_n or len(self.bufX) >= cfg.max_clip:
            ev = ClipEvent(
                frames=np.stack(self.bufX),
                rois=np.stack(self.bufR) if self.bufR else None,
            )
            self.reset()
            return ev
        return None


class CarryStreamingGRU:
    """Incremental per-frame inference for stacked *unidirectional* GRUs.

    ``layers``: the 'gru' param list ({'fwd': {...}} per layer). The carry is
    a tuple of per-layer hidden states; each ``step`` call advances all layers
    one frame in a single fused jitted program.
    """

    def __init__(self, layers: list[dict], head: Callable):
        self.layers = layers
        self.head = head  # (top_hidden (1, H)) -> logits
        hidden_sizes = [lp["fwd"]["wh"].shape[0] for lp in layers]
        self._h0 = tuple(
            jnp.zeros((1, h), jnp.float32) for h in hidden_sizes
        )

        @jax.jit
        def _step(carry, x):
            new_carry = []
            inp = x
            for lp, h in zip(layers, carry):
                p = lp["fwd"]
                xp = jnp.dot(inp, p["wi"]) + p["bi"]
                h_new = gru_cell_step(h, xp, p["wh"], p["bh"])
                new_carry.append(h_new)
                inp = h_new
            return tuple(new_carry), inp

        self._step = _step
        self.carry = self._h0

    def reset(self):
        self.carry = self._h0

    def push(self, feat: np.ndarray):
        """feat: (D,) -> logits (C,) after this frame."""
        x = jnp.asarray(feat, jnp.float32)[None]
        self.carry, top = self._step(self.carry, x)
        return np.asarray(self.head(top))[0]
