"""ctypes bindings for the native host library (built lazily with g++).

Disable with ZGML_NATIVE=0; everything falls back to the numpy codecs with
identical results (tests assert bit-equality).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from zgml import config

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libzgml_host.so")
_SRC = os.path.join(_HERE, "host.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if not config.native():
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        lib.q8_repack.argtypes = [u8p, i64, i64, i64, i64, i8p, f32p]
        lib.q4_repack.argtypes = [u8p, i64, i64, i64, i64, i8p, f32p]
        lib.quantize_q8_0.argtypes = [f32p, i64, u8p]
        lib.quantize_q4_0.argtypes = [f32p, i64, u8p]
        lib.dequant_q8_0.argtypes = [u8p, i64, f32p]
        lib.dequant_q4_0.argtypes = [u8p, i64, f32p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None
