"""Native (C++) host components, loaded via ctypes with build-on-first-use.

A copy of `llama3np_tpu.native` with its own build directory
(`build/torch_native/` beside the package), so the two packages never share
a compiled library.  Every native component has a Python twin that computes
the same thing (`tokenizer.Tokenizer._encode_py`), so the package works
without a C++ compiler.  This is host code, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_CACHE = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)),
                          "build", "torch_native")


def _build(name: str, src: str) -> Optional[str]:
    """Compile `src` to a cached shared library; returns its path or None."""
    so_path = os.path.join(_LIB_CACHE, f"lib{name}.so")
    src_path = os.path.join(_SRC_DIR, src)
    try:
        os.makedirs(_LIB_CACHE, exist_ok=True)
        if (os.path.exists(so_path)
                and os.path.getmtime(so_path) >= os.path.getmtime(src_path)):
            return so_path
        # Build to a temp file then rename (atomic against concurrent builds).
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_LIB_CACHE)
        os.close(fd)
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src_path],
            check=True, capture_output=True,
        )
        os.replace(tmp, so_path)
        return so_path
    except (OSError, subprocess.CalledProcessError):
        return None


class NativeBPE:
    """ctypes wrapper over the C++ greedy-merge core (bpe.cpp)."""

    _lib = None

    @classmethod
    def load_library(cls):
        if cls._lib is None:
            path = _build("bpe", "bpe.cpp")
            if path is None:
                raise RuntimeError("native BPE unavailable (no g++ or build failed)")
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"native BPE failed to load: {e}") from e
            lib.bpe_create.restype = ctypes.c_void_p
            lib.bpe_create.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ]
            lib.bpe_destroy.argtypes = [ctypes.c_void_p]
            lib.bpe_encode.restype = ctypes.c_int32
            lib.bpe_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
            ]
            cls._lib = lib
        return cls._lib

    def __init__(self, vocab: Sequence[str], scores: Sequence[float]):
        lib = self.load_library()
        encoded = [tok.encode("utf-8") for tok in vocab]
        blob = b"".join(encoded)
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        self._handle = lib.bpe_create(
            blob, offsets, np.int32(len(encoded)),
            np.asarray(scores, np.float64),
        )
        self._lib_ref = lib

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(len(text), 1)
        out = np.empty(cap, np.int32)
        n = self._lib_ref.bpe_encode(self._handle, data, len(data), out, cap)
        if n > cap:  # cannot happen (merges only shrink), but stay safe
            out = np.empty(n, np.int32)
            n = self._lib_ref.bpe_encode(self._handle, data, len(data), out, n)
        return out[:n].tolist()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib_ref.bpe_destroy(handle)
            self._handle = None


def native_available() -> bool:
    try:
        NativeBPE.load_library()
        return True
    except RuntimeError:
        return False
