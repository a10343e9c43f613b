"""Native parallel corpus loading (csrc/npz_loader.cpp) with numpy fallback.

Loads a clip list directly into the padded (N, max_t, D) float32 /
(N, max_t, H, W) uint8 arrays the device dataset wants, inflating npz entries
on all cores. Falls back to the pure-Python path when the native library is
unavailable.
"""

from __future__ import annotations

import ctypes
import numpy as np

from ..runtime import native

# mirror of the error-code table in csrc/npz_loader.cpp npz_load_clip
NATIVE_ERROR_NAMES = {
    -1: "unreadable file",
    -2: "corrupt zip container",
    -3: "missing or corrupt X.npy entry",
    -4: "X.npy has wrong rank (expected (T, D))",
    -5: "roi.npy corrupt or shape/dtype mismatch",
    -6: "zip64 archive (unsupported by the native loader)",
    -7: "valid npy member the native loader declines",
}

# codes that mean "a valid file the native parser declines" — loaded through
# the numpy path per-file instead of raised (zip64 containers; members with
# dtypes outside the native set {f4,f8,i4,i8,u1}, big-endian or fortran
# order, or exotic compression)
_NATIVE_FALLBACK_CODES = (-6, -7)


class NativeLoaderError(IOError):
    """Raised when the native corpus loader fails on one or more clips.

    ``failures`` is a list of (path, code, reason) — every bad file is named
    with its decoded error, not just counted."""

    def __init__(self, failures: list[tuple[str, int, str]]):
        self.failures = failures
        lines = "\n".join(
            f"  {p}: {reason} (code {c})" for p, c, reason in failures[:20]
        )
        more = "" if len(failures) <= 20 else f"\n  ... and {len(failures) - 20} more"
        super().__init__(
            f"native loader failed on {len(failures)} clip(s):\n{lines}{more}"
        )


def load_corpus_arrays(
    files: list[str],
    max_t: int,
    x_dim: int,
    use_roi: bool,
    roi_hw: tuple[int, int] = (48, 96),
    n_threads: int = 0,
):
    """Returns (X (N,max_t,x_dim) f32, roi (N,max_t,H,W) u8 | None,
    lengths (N,) i32, has_roi (N,) bool). Raises on unreadable files."""
    lib = native.load()
    N = len(files)
    H, W = roi_hw
    X = np.zeros((N, max_t, x_dim), np.float32)
    roi = np.zeros((N, max_t, H, W), np.uint8) if use_roi else None
    lengths = np.zeros(N, np.int32)
    has_roi = np.zeros(N, np.int32)

    def _py_load_one(i: int, f: str) -> None:
        # array-only read (mirrors the native loader: no label needed,
        # allow_pickle stays False — see core.schema.load_clip docstring)
        from ..core.schema import fix_dim

        with np.load(f, allow_pickle=False) as z:
            Xi = np.asarray(z["X"], np.float32)
            if Xi.ndim != 2:
                raise ValueError(f"{f}: X must be (T, D), got {Xi.shape}")
            Ri = (np.asarray(z["roi"], np.uint8)
                  if use_roi and "roi" in z.files else None)
        if Ri is not None:
            if Ri.ndim != 3 or Ri.shape[1:] != (H, W):
                raise ValueError(f"{f}: roi shape {Ri.shape} != (T,{H},{W})")
            m = min(len(Xi), len(Ri))  # conservative X/roi alignment
            Xi, Ri = Xi[:m], Ri[:m]
        Xi = fix_dim(Xi, x_dim)
        T = min(len(Xi), max_t)
        X[i, :T] = Xi[:T]
        lengths[i] = T
        if Ri is not None:
            roi[i, :T] = Ri[:T]
            has_roi[i] = 1
        else:
            has_roi[i] = 0

    if lib is None:
        for i, f in enumerate(files):
            _py_load_one(i, f)
        return X, roi, lengths, has_roi.astype(bool)

    paths = (ctypes.c_char_p * N)(*[f.encode() for f in files])
    roi_ptr = (
        roi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if use_roi
        else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    )
    failed = lib.npz_corpus_load(
        paths,
        N,
        max_t,
        x_dim,
        X.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H,
        W,
        roi_ptr,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        has_roi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if failed:
        # zip64 archives (-6) and out-of-set dtypes (-7) are valid npz files
        # the native parser declines; honor the documented contract by
        # loading those through numpy per-file. Everything else is a real
        # corpus error — raise with every bad file named.
        failures = []
        for i in range(N):
            code = int(lengths[i])
            if code >= 0:
                continue
            if code in _NATIVE_FALLBACK_CODES:
                try:
                    _py_load_one(i, files[i])
                except Exception as e:  # keep the per-file named contract
                    failures.append(
                        (files[i], code,
                         f"numpy fallback failed: {type(e).__name__}: {e}")
                    )
            else:
                failures.append(
                    (files[i], code,
                     NATIVE_ERROR_NAMES.get(code, "unknown error"))
                )
        if failures:
            raise NativeLoaderError(failures)
    return X, roi, lengths, has_roi.astype(bool)
