"""Native (C++) image preprocessing for the host: the port's own copy of
``matryoshka_mm_tpu/native``.

``image_ops.cpp`` is built with ``g++`` at first use into
``build/native/`` at the repository root (git-ignored), under a file name
that carries a hash of the source and the flags, and bound with
``ctypes``.  Where no compiler is found or the build fails, ``get_lib``
returns None and ``image_processing.py`` takes its PIL path, which gives
the same bits.  This is host code, not a device kernel.

:func:`build_library` is the build both libraries of this directory go
through; ``zstd.py`` binds the other one (``zstd.cpp``), which has no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")

_lib = None
_load_failed = False


def library_path(src: Path = SRC, flags=GXX_FLAGS) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_library(src: Path, flags=GXX_FLAGS) -> Path:
    """Compile ``src`` with ``g++`` unless its library is built already.
    The build goes to a temporary file beside the library and is moved
    into place, so processes that build at once never load a partial
    file.  Raises ``RuntimeError`` with the compiler's message."""
    out = library_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        try:
            subprocess.run(["g++", *flags, str(src), "-o", lib],
                           check=True, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {src.name}: {e}")
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"g++ failed to build {src.name}:\n"
                               f"{e.stderr}")
        os.replace(lib, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = build_library(SRC)
    except RuntimeError as e:
        print(f"[native] build failed: {e}")
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.clip_preprocess.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.clip_preprocess.restype = None
        lib.image_resize_bicubic.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ]
        lib.image_resize_bicubic.restype = None
        _lib = lib
    except OSError as e:
        print(f"[native] load failed: {e}")
        _load_failed = True
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _rgb(rgb: np.ndarray) -> np.ndarray:
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {rgb.shape}")
    return rgb


def clip_preprocess_native(rgb: np.ndarray, target_short: int, crop: int,
                           mean, std) -> np.ndarray:
    """(H, W, 3) uint8 -> (3, crop, crop) float32, CLIP semantics."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rgb = _rgb(rgb)
    h, w = rgb.shape[:2]
    out = np.empty((3, crop, crop), np.float32)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    lib.clip_preprocess(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        target_short, crop,
        mean_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def resize_bicubic_native(rgb: np.ndarray, out_h: int,
                          out_w: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rgb = _rgb(rgb)
    h, w = rgb.shape[:2]
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.image_resize_bicubic(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w)
    return out
