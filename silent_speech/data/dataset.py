"""Device-resident dataset.

The reference re-opens every `.npz` on every __getitem__ with a single-worker
DataLoader (train_model_official.py:391-400) — pure host-side overhead. This
design loads the corpus once into padded host arrays, ships them to the
device a single time, and serves batches as on-device gathers; augmentation
happens inside the jitted train step. For corpora too large for device
memory, the gather falls back to host memory with async device_put.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.schema import batch_clips, fix_dim, parse_filename_label
from .corpus import load_clips


@dataclasses.dataclass
class DeviceDataset:
    """Padded, stacked corpus arrays. ``device=True`` keeps them in device
    memory."""

    X: jax.Array  # (N, max_t, D) float32
    lengths: jax.Array  # (N,) int32
    y: jax.Array  # (N,) int32
    roi: Optional[jax.Array]  # (N, max_t, H, W) uint8
    labels: list[str]

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def x_dim(self) -> int:
        return int(self.X.shape[-1])

    @property
    def max_t(self) -> int:
        return int(self.X.shape[1])

    def gather(self, idx):
        """Batch gather: on device for device-resident arrays; for a
        host-resident corpus the index happens in numpy so only the batch
        crosses to the device."""
        if isinstance(self.X, np.ndarray):
            i = np.asarray(idx)
            roi = None if self.roi is None else jnp.asarray(self.roi[i])
            return (
                jnp.asarray(self.X[i]),
                jnp.asarray(self.lengths[i]),
                roi,
                jnp.asarray(self.y[i]),
            )
        roi = None if self.roi is None else jnp.take(self.roi, idx, axis=0)
        return (
            jnp.take(self.X, idx, axis=0),
            jnp.take(self.lengths, idx, axis=0),
            roi,
            jnp.take(self.y, idx, axis=0),
        )


def build_device_dataset(
    files: list[str],
    label_to_id: dict[str, int],
    max_t: int,
    use_roi: bool,
    x_dim: Optional[int] = None,
    roi_hw: tuple[int, int] = (48, 96),
    device: bool = True,
    prefer_native: bool = True,
    labels: Optional[list[str]] = None,
) -> DeviceDataset:
    """Load, pad and stack a clip list. Uses the native parallel npz loader
    (csrc/npz_loader.cpp) for the array payloads when available.

    ``labels`` (parallel to ``files``) lets a caller that already scanned the
    corpus (CorpusIndex.labels via scan_corpus) skip the per-file label
    re-read — otherwise the native path would re-open every archive's
    central directory a second time just for the 'label' entry. Honored on
    BOTH load paths (native and numpy fallback) so the label authority —
    and therefore label_to_id coverage — cannot depend on whether the
    native library happened to build on this host."""
    if labels is not None and len(labels) != len(files):
        raise ValueError(
            f"labels has {len(labels)} entries for {len(files)} files")
    put = jnp.asarray if device else np.asarray
    if prefer_native and x_dim is not None:
        from ..runtime import native
        if native.available():
            from .native_loader import load_corpus_arrays

            X, roi, lengths, _ = load_corpus_arrays(
                files, max_t, x_dim, use_roi, roi_hw
            )
            if labels is None:
                # labels: the npz 'label' entry is authoritative (the
                # reference's NPZWordDataset reads it; a filename-first rule
                # would silently mislabel clips whose speaker id contains an
                # underscore); reading one tiny zip member per file is cheap
                # — no array decompression happens
                labels = []
                for f in files:
                    with np.load(f, allow_pickle=False) as d:
                        lab = str(d["label"]) if "label" in d.files else None
                    if lab is None:
                        lab = parse_filename_label(f)
                    labels.append(lab)
            return DeviceDataset(
                X=put(X),
                lengths=put(lengths),
                y=put(np.asarray([label_to_id[l] for l in labels], np.int32)),
                roi=None if roi is None else put(roi),
                labels=labels,
            )
    clips = load_clips(files)
    if labels is not None:
        # same authority as the native path (the caller's scan), not each
        # clip's own missing-label fallback
        for c, lab in zip(clips, labels):
            c.label = lab
    if x_dim is not None:
        for c in clips:
            c.X = fix_dim(c.X, x_dim)
    batch = batch_clips(clips, label_to_id, max_t, use_roi, roi_hw)
    return DeviceDataset(
        X=put(batch.X),
        lengths=put(batch.lengths),
        y=put(batch.y),
        roi=None if batch.roi is None else put(batch.roi),
        labels=[c.label for c in clips],
    )


def epoch_batches(
    n: int,
    batch_size: int,
    rng: np.random.Generator,
    *,
    weights: Optional[np.ndarray] = None,
    shuffle: bool = True,
    drop_last: bool = False,
    pad: bool = True,
) -> Iterator[np.ndarray]:
    """Yield index arrays for one epoch.

    With ``weights``, samples n indices with replacement (the reference's
    WeightedRandomSampler); otherwise a shuffled (or sequential) permutation.
    With ``pad`` (default), the final short batch is padded by wrapping so
    jit sees one batch shape — fine for weighted training, but evaluation
    must use ``pad=False`` (a wrapped sample would be double-counted in the
    metrics); the short final batch then costs one extra compile.
    """
    if weights is not None:
        p = weights / weights.sum()
        order = rng.choice(n, size=n, replace=True, p=p)
    elif shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    for s in range(0, n, batch_size):
        chunk = order[s : s + batch_size]
        if len(chunk) < batch_size:
            if drop_last:
                return
            if pad:
                padding = order[: batch_size - len(chunk)]
                if len(padding) < batch_size - len(chunk):  # tiny corpus
                    reps = -(-(batch_size - len(chunk)) // max(1, len(order)))
                    padding = np.tile(order, reps)[: batch_size - len(chunk)]
                chunk = np.concatenate([chunk, padding])
        yield chunk.astype(np.int32)
