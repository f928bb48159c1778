"""Zstandard decoding, CRC-32C and raw-block zstd frames for the host,
through ``zstd.cpp`` (the port's own decoder: the card host has no
``zstandard`` package).

The library is built with ``g++`` at first use into ``build/native/``
(:func:`matryoshka_mm_torch.native.build_library`).  It has no fallback:
where it cannot be built or loaded, the first call raises with the
compiler's message.

Buffers are anything that exposes a C-contiguous buffer (``bytes``,
``bytearray``, ``memoryview``, numpy arrays) or a CPU ``torch.Tensor``;
:func:`decompress_into` writes straight into the caller's buffer, so a
large chunk is never copied twice.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import build_library

SRC = Path(__file__).resolve().parent / "zstd.cpp"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
MAGIC = b"\x28\xb5\x2f\xfd"
_ERRLEN = 256

_lib = None


class ZstdError(ValueError):
    """Malformed, truncated or unsupported zstd input."""


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path = build_library(SRC, FLAGS)
        dll = ctypes.CDLL(str(path))
        u8p, size, cp = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
        dll.m3z_decompress.argtypes = [u8p, size, u8p, size, cp, size]
        dll.m3z_decompress.restype = ctypes.c_int64
        dll.m3z_content_size.argtypes = [u8p, size, cp, size]
        dll.m3z_content_size.restype = ctypes.c_int64
        dll.m3z_raw_frame_size.argtypes = [size]
        dll.m3z_raw_frame_size.restype = ctypes.c_int64
        dll.m3z_raw_frame.argtypes = [u8p, size, u8p]
        dll.m3z_raw_frame.restype = ctypes.c_int64
        dll.m3z_crc32c.argtypes = [u8p, size, ctypes.c_uint32]
        dll.m3z_crc32c.restype = ctypes.c_uint32
        _lib = dll
    return _lib


def _u8(buf, writable: bool = False) -> np.ndarray:
    """A uint8 numpy view of ``buf`` (no copy)."""
    if hasattr(buf, "data_ptr"):            # a torch tensor
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("expected a contiguous CPU tensor")
        import torch

        buf = buf.view(torch.uint8).reshape(-1).numpy()
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    if writable and not a.flags.writeable:
        raise ValueError("output buffer is read-only")
    if not a.flags.c_contiguous:
        raise ValueError("expected a contiguous buffer")
    return a


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def content_size(src) -> int:
    """The decoded size the frames of ``src`` state, or -1 where one does
    not."""
    a = _u8(src)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib().m3z_content_size(_ptr(a), a.size, err, _ERRLEN)
    if n == -2:
        raise ZstdError(err.value.decode())
    return n


def decompress_into(src, dst) -> int:
    """Decode every frame of ``src`` into ``dst``; returns the bytes
    written.  Raises :class:`ZstdError` on malformed input or where the
    frames need more room than ``dst`` has."""
    a, d = _u8(src), _u8(dst, writable=True)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib().m3z_decompress(_ptr(a), a.size, _ptr(d), d.size, err, _ERRLEN)
    if n < 0:
        raise ZstdError(err.value.decode())
    return n


def decompress(src, size: int = None) -> bytes:
    """Decode ``src`` into new bytes.  ``size``, if given, is the exact
    decoded size; else the frames' stated sizes, or a buffer that grows."""
    if size is not None:
        out = bytearray(size)
        n = decompress_into(src, out)
        if n != size:
            raise ZstdError(f"decoded {n} bytes, expected {size}")
        return bytes(out)
    want = content_size(src)
    if want >= 0:
        return decompress(src, want)
    a = _u8(src)
    cap = max(4 * a.size, 1 << 16)
    err = ctypes.create_string_buffer(_ERRLEN)
    while True:
        out = bytearray(cap)
        d = _u8(out, writable=True)
        n = lib().m3z_decompress(_ptr(a), a.size, _ptr(d), cap, err, _ERRLEN)
        if n >= 0:
            return bytes(out[:n])
        if n != -2:
            raise ZstdError(err.value.decode())
        cap *= 2


def raw_frame_size(n: int) -> int:
    return lib().m3z_raw_frame_size(n)


def raw_frame_into(src, dst) -> int:
    """Write ``src`` as one zstd frame of raw blocks into ``dst`` (at
    least :func:`raw_frame_size` bytes); returns the frame's size."""
    a, d = _u8(src), _u8(dst, writable=True)
    if d.size < raw_frame_size(a.size):
        raise ValueError("output buffer too small for the frame")
    return lib().m3z_raw_frame(_ptr(a), a.size, _ptr(d))


def raw_frame(src) -> bytes:
    """``src`` as one valid zstd frame of stored (uncompressed) blocks."""
    a = _u8(src)
    out = bytearray(raw_frame_size(a.size))
    raw_frame_into(a, out)
    return bytes(out)


def crc32c(buf, crc: int = 0) -> int:
    a = _u8(buf)
    return lib().m3z_crc32c(_ptr(a), a.size, crc)
