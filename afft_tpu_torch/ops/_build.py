"""Build and load the CUDA kernels of ``afft_tpu_torch/csrc``.

``nvcc`` compiles each ``csrc/*.cu`` (one process per source, all started
together) for ``sm_90a`` and links them into
``build/afft_tpu_torch/libafft_kernels.so``, a shared library with a plain C
interface that is loaded with ``ctypes``. The build runs at first use and is
redone when the hash of the sources and flags changes. ``ptxas -v`` reports
each kernel's registers, shared memory and spills; the compiler's output for
a source is kept beside the library (``build_log``). Importing this module
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_IP = ctypes.POINTER(ctypes.c_int)     # host array of ints
_FP = ctypes.POINTER(ctypes.c_float)   # host array of floats
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
    # the training entries' shard argument (_IP after inv) may be null
    "afft_block_train_fwd": [_I, _P, _PP, _P, _IP, _IP, _FP, _IP, _PP]
                            + [_I] * 5 + [_F, _P],
    "afft_block_train_bwd_mlp": [_I, _P, _P, _P, _PP, _PP, _IP, _IP, _FP,
                                 _IP, _PP] + [_I] * 4 + [_F, _P],
    "afft_block_train_bwd_attn": [_I, _P, _P, _P, _PP, _PP, _P, _IP, _IP, _FP,
                                  _IP, _PP] + [_I] * 4 + [_F, _P],
    "afft_draw_masks": [_IP, _IP, _FP, _PP] + [_I] * 4 + [_P],
    "afft_draw_mask_site": [_IP, _I, _F, _L, _L, _L, _P, _L, _P],
    "afft_drop_grad": [_I, _P, _P, _IP, _IP, _FP] + [_I] * 4 + [_P],
    "afft_attention_drop": [_I, _I, _P, _P, _P, _IP, _IP, _FP] + [_I] * 4
                           + [_P],
    "afft_attention_drop_bwd": [_I, _I] + [_P] * 7 + [_IP, _IP, _FP]
                               + [_I] * 4 + [_P],
    "afft_gemm": [_I] * 4 + [_P] * 6 + [_IP, _IP, _FP] + [_I] * 4 + [_P],
    "afft_gemm_tn": [_P] * 4 + [_I] * 4 + [_P],
    "afft_gemm_tn_slices": [_I] * 3,
    "afft_set_pack": [_P, _L],
    "afft_pack_rows": [_P] * 2 + [_I] * 2 + [_P],
}
# the entry points that return another type than int
RESTYPES = {"afft_set_pack": ctypes.c_longlong}
# the GPT-2 layer's training entries take the fuser block's arguments
for _kind in ("fwd", "bwd_mlp", "bwd_attn"):
    SIGNATURES[f"afft_gpt2_train_{_kind}"] = SIGNATURES[
        f"afft_block_train_{_kind}"]
SIGNATURES["afft_draw_masks_gpt2"] = SIGNATURES["afft_draw_masks"]

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


def build_log(source: str) -> str:
    """Path of the compiler's output for ``source`` (a ``csrc`` file name)
    from the last build."""
    return os.path.join(BUILD_DIR, f"{source}.log")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kernels need the CUDA toolkit "
                       "(set CUDA_HOME)")


def build() -> str:
    """Compile the kernels if the sources changed; return the library path.

    Several processes may build at once (the ranks of a data-parallel run,
    each at its first launch): each compiles into objects and a library
    file named by its pid and swaps the library in with ``os.replace``, and
    the hash stamp is written after the swap, so a process sees either a
    whole library of these sources or a stale stamp (and builds again). The
    last swap wins, with the same content."""
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
        with open(build_log(os.path.basename(src)), "w") as f:
            f.write(out)
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
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib
