"""ctypes bindings for the native C++ runtime (cpp/ddp_runtime.cpp).

Builds the shared library on first use (g++, cached) and degrades to pure
Python when no toolchain is available.  Native pieces: chronometer, logging
and failure reporting (≙ src/lib.cpp).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CPPDIR = os.path.join(_REPO, "cpp")
_SO = os.path.join(_CPPDIR, "libddp_runtime.so")

_lib = None
_tried = False


def _build() -> bool:
    src = os.path.join(_CPPDIR, "ddp_runtime.cpp")
    if not os.path.exists(src):
        return False
    try:
        subprocess.run(
            ["make", "-C", _CPPDIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def load():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # always invoke make: a no-op when the .so is current, a rebuild when
    # ddp_runtime.cpp is newer (keeps a stale .so from shipping an older ABI)
    if not _build() and not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
        _bind(lib)
    except (OSError, AttributeError):
        # unloadable or ABI-stale library (missing symbol) → no native path
        return None
    _lib = lib
    return _lib


def _bind(lib):
    lib.ddp_log.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ddp_chrono_start.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.ddp_chrono_start.restype = ctypes.c_int64
    lib.ddp_chrono_stop.argtypes = [ctypes.c_int64]
    lib.ddp_chrono_stop.restype = ctypes.c_double
    lib.ddp_report_failure.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
    ]  # fmt: skip


class NativeChrono:
    """Context manager over the C++ chronometer (≙ chronometer_t)."""

    def __init__(self, message: str, path: str = "/tmp/chrono.log"):
        self.message = message
        self.path = path
        self.handle = None
        self.elapsed = None

    def __enter__(self):
        lib = load()
        if lib is not None:
            self.handle = lib.ddp_chrono_start(self.message.encode(), self.path.encode())
        return self

    def __exit__(self, *exc):
        lib = load()
        if lib is not None and self.handle is not None:
            self.elapsed = lib.ddp_chrono_stop(self.handle)
        return False


def native_log(path: str, msg: str) -> bool:
    lib = load()
    if lib is None:
        return False
    lib.ddp_log(path.encode(), msg.encode())
    return True
