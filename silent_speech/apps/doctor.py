"""Environment diagnosis: everything the pipeline needs, checked in one go.

The reference's closest artifact is debug.py (dataset-dir typo diagnosis);
a production deployment needs the whole stack checked: JAX backend/devices,
the native C++ components (npz loader, ring buffer), the host capture deps
(cv2/mediapipe/landmarker asset), checkpoint backends, and a tiny end-to-end
jit smoke. Each line is PASS/WARN/FAIL with an actionable message; exit code
is 1 only on FAILs (WARNs cover optional host-capture extras).
"""

from __future__ import annotations

import importlib


def _line(status: str, name: str, detail: str) -> None:
    print(f"  [{status:^4s}] {name:<22s} {detail}")


def run_doctor() -> int:
    fails = 0
    jax = None

    # --- jax / backend ---------------------------------------------------
    try:
        import jax

        backend = jax.default_backend()
        devs = jax.devices()
        _line("PASS", "jax", f"{jax.__version__} backend={backend} "
                             f"devices={len(devs)} ({devs[0].device_kind})")
        if backend not in ("gpu", "cpu"):
            _line("WARN", "backend", f"unexpected backend {backend!r}")
        elif backend == "cpu":
            _line("WARN", "backend", "no GPU: computation runs on the host "
                                     "CPU")
    except Exception as e:  # noqa: BLE001
        jax = None
        _line("FAIL", "jax", f"{type(e).__name__}: {e}")
        fails += 1

    # --- jit smoke (compile + execute one small program) ------------------
    if jax is not None:
        try:
            import jax.numpy as jnp

            out = jax.jit(lambda a: (a @ a.T).sum())(jnp.ones((64, 64)))
            assert float(out) == 64.0 * 64 * 64
            _line("PASS", "jit smoke", "64x64 matmul compiled + executed")
        except Exception as e:  # noqa: BLE001
            _line("FAIL", "jit smoke", f"{type(e).__name__}: {e}")
            fails += 1

    # --- native components -------------------------------------------------
    from ..runtime import native

    try:
        lib = native.load()
        if lib is None:
            _line("WARN", "native npz loader",
                  "unavailable (g++ build failed?) — pure-python fallback "
                  "active, corpus loads will be slower")
        else:
            _line("PASS", "native npz loader", "csrc/npz_loader.cpp loaded")
    except Exception as e:  # noqa: BLE001
        _line("WARN", "native npz loader", f"{type(e).__name__}: {e}")

    try:
        import numpy as np

        from ..runtime.ringbuf import FrameRing

        rb = FrameRing(4, 64)
        rb.push(np.zeros(64, np.uint8))
        assert rb.pop() is not None
        _line("PASS", "native ring buffer", "push/pop ok")
    except Exception as e:  # noqa: BLE001
        _line("WARN", "native ring buffer", f"{type(e).__name__}: {e}")

    # --- checkpoint backends ----------------------------------------------
    try:
        importlib.import_module("orbax.checkpoint")
        _line("PASS", "orbax", "available (checkpoint_format=orbax usable)")
    except Exception:  # noqa: BLE001
        _line("WARN", "orbax", "not importable — npz checkpoints only")

    try:
        importlib.import_module("torch")
        _line("PASS", "torch", "available (.pt import/export usable)")
    except Exception:  # noqa: BLE001
        _line("WARN", "torch", "not importable — .pt interop disabled")

    # --- host capture stack (optional: only live camera apps need these) ---
    for mod, why in (("cv2", "camera apps run sim=N only"),
                     ("mediapipe", "landmark inference unavailable")):
        try:
            importlib.import_module(mod)
            _line("PASS", mod, "importable")
        except Exception:  # noqa: BLE001
            _line("WARN", mod, f"not importable — {why}")

    from ..runtime.capture import LANDMARKER_ENV, resolve_landmarker_asset

    try:
        p = resolve_landmarker_asset("models/face_landmarker.task")
        _line("PASS", "landmarker asset", p)
    except FileNotFoundError:
        _line("WARN", "landmarker asset",
              f"models/face_landmarker.task not found (set {LANDMARKER_ENV} "
              "or pass model_path=; live camera apps will print the download "
              "instruction)")

    # --- mesh / sharding ---------------------------------------------------
    if jax is not None:
        try:
            n = len(jax.devices())
            from ..parallel import make_mesh

            mesh = make_mesh(jax.devices()[: max(1, n)],
                             data=max(1, n), model=1)
            _line("PASS", "mesh",
                  f"{dict(zip(mesh.axis_names, mesh.devices.shape))}")
        except Exception as e:  # noqa: BLE001
            _line("FAIL", "mesh", f"{type(e).__name__}: {e}")
            fails += 1
    else:
        _line("WARN", "mesh", "skipped (no usable jax backend)")

    print(("all checks passed" if fails == 0
           else f"{fails} FAILURE(S) — see above"))
    return 1 if fails else 0
