"""Build and load the hand-written CUDA kernels.

Every `llama3np_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a`
into one shared library with a plain C interface, loaded with `ctypes`
(no PyTorch headers, so a build takes seconds).  The build runs at the first
launch, never on import, into `build/torch_kernels/` beside the package; the
library's name carries a hash of the sources and flags, so a changed source
builds anew and an unchanged one is loaded as it is.  The sources compile in
parallel, one `nvcc` each, and link once.  A failed build raises with the
compiler's output.

The library is linked against the static CUDA runtime.  Streams and device
pointers are driver-level handles, so PyTorch's current stream and tensors
pass across; each C entry takes the device index and selects it first.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> (restype, argtypes).  Every pointer and the stream
# travel as c_void_p; ints as c_int.
_FLASH = (ctypes.c_int, [_P, _P, _P, _P,              # q, k, v, o
                         _I, _I, _I, _I, _I, _I, _P])  # B, L, NH, KVH, HD, device, stream
_DECODE = (ctypes.c_int, [
    _P, _P, _P, _P, _P, _P,            # wqkv, wo, wgu, w_down, norms
    _P, _P, _P, _P,                    # x_in, x_out, k_cache, v_cache
    _P, _P, _P, _P,                    # cos_row, sin_row, scratch, counters
    _I, _I, _I, _I, _I, _I, _I, _I,    # nl, d, nh, kvh, hd, fd, m, pos
    ctypes.c_float, _I, _P,            # eps, device, stream
])
_DECODE_I8 = (ctypes.c_int, [
    _P, _P, _P, _P,                    # wqkv, wo, wgu, w_down (int8)
    _P, _P, _P, _P,                    # their per-column scales
    _P, _P,                            # attn_norm, ffn_norm
    _P, _P, _P, _P,                    # x_in, x_out, k_cache, v_cache
    _P, _P, _P, _P,                    # cos_row, sin_row, scratch, counters
    _I, _I, _I, _I, _I, _I, _I, _I,    # nl, d, nh, kvh, hd, fd, m, pos
    ctypes.c_float, _I, _P,            # eps, device, stream
])
_PAGED = (ctypes.c_int, [
    _P, _P, _P, _P, _P,                # q, k_pools, v_pools, table, pos
    _P, _P, _P, _P,                    # cur_k, cur_v, win_k, win_v
    _P, _P, _P,                        # out, part_ml, part_acc
    _I, _I, _I, _I, _I, _I, _I,        # B, NH, KVH, HD, P, page, maxp
    _I, _I, _I, _I, _I,                # layer, stacked, win_q, win_count, chunk_pages
    _I, _P,                            # device, stream
])
_PAGED_I8 = (ctypes.c_int, [
    _P, _P, _P, _P, _P,                # q, k_pools, v_pools, k/v scale pools
    _P, _P,                            # table, pos
    _P, _P, _P, _P,                    # cur_k, cur_v, cur_ks, cur_vs
    _P, _P, _P, _P,                    # win_k, win_v, win_ks, win_vs
    _P, _P, _P,                        # out, part_ml, part_acc
    _I, _I, _I, _I, _I, _I, _I,        # B, NH, KVH, HD, P, page, maxp
    _I, _I, _I, _I, _I,                # layer, stacked, win_q, win_count, chunk_pages
    _I, _P,                            # device, stream
])
_ARGMAX = (ctypes.c_int, [_P, _P, _P, _P, _P,  # x, w, out, scratch, count
                          _I, _I, _I, _I, _P])  # D, VS, rows, device, stream
_FLASH_F32 = (ctypes.c_int, [_P, _P, _P, _P, _P, _P,      # q, k, v, o, part, count
                             _I, _I, _I, _I, _I,          # B, L, NH, KVH, HD
                             _I, _I, _I, _P])             # BM, KS, device, stream
SIGNATURES = {
    "l3t_flash_prefill_f32": _FLASH_F32,
    "l3t_flash_prefill_bf16": _FLASH,
    "l3t_flash_prefill_f16": _FLASH,
    "l3t_decode_scratch_floats": (ctypes.c_long, [_I, _I, _I, _I, _I]),
    "l3t_decode_counters": (ctypes.c_long, [_I, _I, _I, _I, _I]),
    "l3t_decode_layers_f32": _DECODE,
    "l3t_decode_layers_bf16": _DECODE,
    "l3t_decode_layers_f16": _DECODE,
    "l3t_decode_layers_i8": _DECODE_I8,
    "l3t_decode_layers_i8_bf16": _DECODE_I8,
    "l3t_decode_layers_i8_f16": _DECODE_I8,
    "l3t_paged_attention_i8": _PAGED_I8,
    "l3t_paged_attention_i8_bf16": _PAGED_I8,
    "l3t_paged_attention_i8_f16": _PAGED_I8,
    "l3t_paged_attention_f32": _PAGED,
    "l3t_paged_attention_bf16": _PAGED,
    "l3t_paged_attention_f16": _PAGED,
    "l3t_argmax_head_f32": _ARGMAX,
    "l3t_argmax_head_bf16": _ARGMAX,
    "l3t_argmax_head_f16": _ARGMAX,
}


class KernelLibrary:
    """The loaded kernel library (one per process), with its build record."""

    _lib = None
    build_seconds = 0.0   # wall time of the nvcc build in this process
    build_log = ""        # the compiler's output (ptxas register/spill info)
    path = ""

    @classmethod
    def get(cls):
        if cls._lib is None:
            path = _build()
            lib = ctypes.CDLL(path)
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            cls._lib, cls.path = lib, path
        return cls._lib


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _build() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"libl3t_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_so, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so_path)
    KernelLibrary.build_seconds = time.perf_counter() - t0
    KernelLibrary.build_log = log
    with open(so_path + ".log", "w") as f:
        f.write(log)
    return so_path


_TICKETS: dict = {}


def tickets(kernel: str, device, stream: int, n: int):
    """A kernel's arrival counters for calls on `stream` (int32): zeroed
    once and left zero by every call (the blocks that read them reset
    them), so no call pays for clearing them; a larger need gets a new
    zeroed buffer.  One buffer a kernel, device and stream: calls on one
    stream run in order."""
    import torch

    c = _TICKETS.get((kernel, device, stream))
    if c is None or c.numel() < n:
        c = _TICKETS[(kernel, device, stream)] = torch.zeros(
            max(n, 1), dtype=torch.int32, device=device)
    return c


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index` (the launch planners' input)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(rc: int, what: str):
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
