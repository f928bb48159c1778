"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked into
ONE shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so the build takes seconds.  The library
goes to ``build/kernels/`` at the repository root (git-ignored); its file
name carries a hash of the sources and flags, so an edited source builds a
new library and a stale one is never loaded.

The build runs at the first launch of a kernel, never at import: the CPU
tests import every module on machines without ``nvcc``.  A failed build
raises with nvcc's stderr; nothing falls back to a plain version.

Calling convention of every entry point: pointers (tensor ``data_ptr()``
and the CUDA stream) are ``void*``; the function returns
``cudaGetLastError()`` right after its launch, and :func:`check` raises if
that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C signatures, in the order of the C parameter lists in csrc/
SIGNATURES = {
    # dtype, q, k, v, kv_valid, out, lse, B, H, Hkv, Sq, Sk, Dh,
    # q strides (b, h, s), k strides (b, h, s), v strides (b, h, s),
    # kv_valid batch stride, causal, window, q_offset, scale, stream
    "m3_flash_attention_fwd": [I, P, P, P, P, P, P, I, I, I, I, I, I,
                               LL, LL, LL, LL, LL, LL, LL, LL, LL, LL,
                               I, I, I, F, P],
    # dtype, q, k, v, kv_valid, kv_pos, q_pos, out, B, H, Hkv, S, Dh,
    # q strides (b, h), k strides (b, s, h), v strides (b, s, h),
    # kv_valid batch stride, kv_pos batch stride, window, scale, stream
    "m3_decode_attention": [I, P, P, P, P, P, P, P, I, I, I, I, I,
                            LL, LL, LL, LL, LL, LL, LL, LL, LL, LL,
                            I, F, P],
    # dtype, q, k, v, k_scale, v_scale, kv_valid, kv_pos, q_pos, out,
    # B, H, Hkv, S, Dh, q strides (b, h), k strides (b, s, h),
    # v strides (b, s, h), scale strides (b, s, h), kv_valid batch stride,
    # kv_pos batch stride, window, scale, stream
    "m3_decode_attention_int8": [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                                 LL, LL, LL, LL, LL, LL, LL, LL, LL, LL, LL,
                                 LL, LL, I, F, P],
    # bits, x, w, scale, out, M, N, K, x row stride, out row stride, stream
    "m3_quant_matmul": [I, P, P, P, P, I, I, I, LL, LL, P],
    # bits, x, gateup, gateup scale, down, down scale, h, out, M, D, I,
    # n_out, x row stride, out row stride, stream
    "m3_quant_mlp": [I, P, P, P, P, P, P, P, I, I, I, I, LL, LL, P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu*"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libm3kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    ``nvcc -c`` per source, all running at once, then one link.  Returns
    its path.  ``verbose`` adds ``-Xptxas -v`` (registers, shared memory
    and spills of every kernel) and prints nvcc's output."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs = []
        try:
            for cmd, _, proc in jobs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{err}")
                logs.append(err)
        finally:
            for _, _, proc in jobs:   # none outlives a failed build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        lib = os.path.join(tmp, "lib.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib, out)
    if verbose:
        print(f"nvcc build {time.perf_counter() - t0:.1f}s -> {out}")
        print("".join(logs))
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.m3_error_string.argtypes = [ctypes.c_int]
    lib.m3_error_string.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().m3_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
