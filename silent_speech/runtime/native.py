"""Native library build + ctypes bindings.

The C++ sources in csrc/ are compiled on demand (g++ -O3 -march=native,
cached by source mtime) into a single shared library. The library's file name
carries a key of the building host's CPU (machine and instruction-set flags),
so a ``build/`` directory copied to a host with another CPU rebuilds instead
of loading code that host cannot execute. Everything degrades gracefully:
callers check ``available()`` and fall back to pure-Python paths when no
toolchain is present.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO_ROOT, "csrc")
_BUILD = os.path.join(_REPO_ROOT, "build")
_SOURCES = ["ringbuf.cpp", "npz_loader.cpp"]
_LIB_STEM = "libsilent_speech_runtime"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cpu_flags(cpuinfo: str = "/proc/cpuinfo") -> str:
    """The instruction-set flags of the first CPU ('' where unreadable)."""
    try:
        with open(cpuinfo) as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return ""


def host_key(machine: str | None = None, flags: str | None = None) -> str:
    """Short key of what ``-march=native`` compiles for on this host."""
    machine = platform.machine() if machine is None else machine
    flags = _cpu_flags() if flags is None else flags
    return hashlib.sha256(f"{machine}|{flags}".encode()).hexdigest()[:12]


def lib_path() -> str:
    return os.path.join(_BUILD, f"{_LIB_STEM}-{host_key()}.so")


def _needs_build(lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    lib_mtime = os.path.getmtime(lib_path)
    return any(
        os.path.getmtime(os.path.join(_CSRC, s)) > lib_mtime for s in _SOURCES
    )


def _build(lib_path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", lib_path,
    ] + [os.path.join(_CSRC, s) for s in _SOURCES] + ["-lz", "-lpthread"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def load() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load the native runtime library; None on failure."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        try:
            if _needs_build(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _declare(lib: ctypes.CDLL) -> None:
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    p8 = ctypes.POINTER(ctypes.c_uint8)
    pf = ctypes.POINTER(ctypes.c_float)

    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [u64, u64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = u64
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_slot_bytes.restype = u64
    lib.rb_slot_bytes.argtypes = [ctypes.c_void_p]
    lib.rb_size.restype = u64
    lib.rb_size.argtypes = [ctypes.c_void_p]
    lib.rb_dropped.restype = u64
    lib.rb_dropped.argtypes = [ctypes.c_void_p]
    lib.rb_push.restype = ctypes.c_int
    lib.rb_push.argtypes = [ctypes.c_void_p, p8, u64, u64]
    lib.rb_pop.restype = ctypes.c_int
    lib.rb_pop.argtypes = [ctypes.c_void_p, p8, u64, ctypes.POINTER(u64)]
    lib.rb_pop_batch.restype = u64
    lib.rb_pop_batch.argtypes = [ctypes.c_void_p, p8, u64, ctypes.POINTER(u64)]

    lib.npz_load_clip.restype = i64
    lib.npz_load_clip.argtypes = [
        ctypes.c_char_p, i64, i64, pf, i64, i64, p8, ctypes.POINTER(i32),
    ]
    lib.npz_corpus_load.restype = i64
    lib.npz_corpus_load.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, i64, i64, pf, i64, i64, p8,
        ctypes.POINTER(i32), ctypes.POINTER(i32), i64,
    ]
