"""Build and load the CUDA kernels of ``afft_tpu_torch/csrc``.

``nvcc`` compiles each ``csrc/*.cu`` (one process per source, all started
together) for ``sm_90a`` and links them into
``build/afft_tpu_torch/libafft_kernels.so``, a shared library with a plain C
interface that is loaded with ``ctypes``. The build runs at first use and is
redone when the hash of the sources and flags changes. Importing this module
needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "afft_tpu_torch")
LIB_NAME = "libafft_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
# C entry points and their argument types (pointers and the stream are
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints)
SIGNATURES = {
    "afft_fused_block": [_I] + [_P] * 19 + [_I] * 5 + [_F, _P],
    "afft_gpt2_attn_half": [_I] + [_P] * 11 + [_I] * 4 + [_F, _P],
    "afft_gpt2_mlp_half": [_I] + [_P] * 10 + [_I] * 3 + [_F, _P],
    "afft_fused_attention": [_I] + [_P] * 5 + [_I] * 5 + [_L] * 9 + [_P],
    "afft_fused_seq_block": [_I, _P, _PP] + [_P] * 6 + [_I] * 5 + [_F, _P],
    "afft_fused_decoder_block": [_I, _P, _P, _PP] + [_P] * 7 + [_I] * 5
                                + [_F, _P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def build() -> str:
    """Compile the kernels if the sources changed; return the library path."""
    digest = source_hash()
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp = lib_path + ".hash"
    if os.path.exists(lib_path) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{digest}."
                                      f"{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    objs, failures = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src}:\n{out}")
        objs.append(obj)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    with open(stamp, "w") as f:
        f.write(digest)
    for obj in objs:
        os.remove(obj)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
