"""ctypes binding for the native LMDB-format reader.

Port of afft_tpu/data/lmdb_native.py. Presents the tiny subset of the
``lmdb`` Python API the data layer uses (``env.begin()`` -> txn with
``get``; plus full iteration for a packer); the ``lmdb`` package itself is
never imported. The reader is the port's own copy of the C++ source
(``afft_tpu_torch/native/lmdb_reader.cpp``), compiled with ``g++`` at first
use into ``build/afft_tpu_torch/`` beside the CUDA kernels; the library's
name carries the hash of the source and flags, so an edit rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Iterator, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "lmdb_reader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "afft_tpu_torch")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_lock = threading.Lock()
_lib = None


def build() -> str:
    """Compile the reader if its source or flags changed; return the
    library path. The library is written under a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    lib_path = os.path.join(BUILD_DIR,
                            f"libafft_lmdb.{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        lib.afft_lmdb_open.restype = ctypes.c_void_p
        lib.afft_lmdb_open.argtypes = [ctypes.c_char_p]
        lib.afft_lmdb_close.argtypes = [ctypes.c_void_p]
        lib.afft_lmdb_entries.restype = ctypes.c_uint64
        lib.afft_lmdb_entries.argtypes = [ctypes.c_void_p]
        lib.afft_lmdb_get.restype = ctypes.c_int
        lib.afft_lmdb_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.afft_lmdb_cursor_open.restype = ctypes.c_void_p
        lib.afft_lmdb_cursor_open.argtypes = [ctypes.c_void_p]
        lib.afft_lmdb_cursor_next.restype = ctypes.c_int
        lib.afft_lmdb_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
        lib.afft_lmdb_cursor_close.argtypes = [ctypes.c_void_p]
        lib.afft_lmdb_last_error.restype = ctypes.c_char_p
        lib.afft_lmdb_last_error.argtypes = []
        _lib = lib
        return lib


def _last_error(lib) -> str:
    msg = lib.afft_lmdb_last_error()
    return msg.decode("utf-8", "replace") if msg else "unknown error"


class _Txn:
    def __init__(self, env: "NativeLmdb"):
        self._env = env

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def get(self, key: bytes) -> Optional[bytes]:
        return self._env.get(key)


class NativeLmdb:
    """lmdb.Environment-alike over the native reader."""

    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._handle = lib.afft_lmdb_open(str(path).encode())
        if not self._handle:
            raise IOError(f"cannot open LMDB environment at {path}: "
                          f"{_last_error(lib)}")

    def begin(self) -> _Txn:
        return _Txn(self)

    def get(self, key: bytes) -> Optional[bytes]:
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        rc = self._lib.afft_lmdb_get(self._handle, key, len(key),
                                     ctypes.byref(val), ctypes.byref(vlen))
        if rc < 0:
            # -1 is the native reader's corruption code (bad page /
            # unreachable overflow page) — distinct from a plain miss,
            # which must NOT be zero-filled away by the backward search
            raise IOError(f"corrupt LMDB entry for key {key!r}: "
                          f"{_last_error(self._lib)}")
        if rc == 0:
            return None
        return ctypes.string_at(val.value, vlen.value)

    @property
    def entries(self) -> int:
        return int(self._lib.afft_lmdb_entries(self._handle))

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """Full scan in key order (used by the feature packer)."""
        lib = self._lib
        cur = lib.afft_lmdb_cursor_open(self._handle)
        key, klen = ctypes.c_void_p(), ctypes.c_size_t()
        val, vlen = ctypes.c_void_p(), ctypes.c_size_t()
        try:
            while True:
                rc = lib.afft_lmdb_cursor_next(
                    cur, ctypes.byref(key), ctypes.byref(klen),
                    ctypes.byref(val), ctypes.byref(vlen))
                if rc < 0:
                    raise IOError("corrupt LMDB environment during scan: "
                                  f"{_last_error(lib)}")
                if rc == 0:
                    return
                yield (ctypes.string_at(key.value, klen.value),
                       ctypes.string_at(val.value, vlen.value))
        finally:
            lib.afft_lmdb_cursor_close(cur)

    def close(self):
        if self._handle:
            self._lib.afft_lmdb_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
