"""Paged decode attention: batched single-token attention over the page
pool, following each row's block table, as a hand-written CUDA kernel
(`csrc/paged_attention.cu`) beside its plain PyTorch version.

Counterpart of `llama3np_tpu.ops.kernels.paged_attention.paged_attention`,
with the same three modes, over float32, bf16, float16 or int8 pools:

* plain: pools [P, KVH, page, HD], row b attends kv_idx <= pos[b];
* stacked (`layer` given): the whole-model pools [NL, P, KVH, page, HD]
  read at `layer`, holding tokens < pos[b], with the current token's
  cur_k/cur_v [B, KVH, HD] appended as one column;
* window (stacked plus win_k/win_v [B, KVH, Q, HD] and host int
  `win_count`): the quantum loop's in-flight rows, the first `win_count`
  visible.

int8 pools pass their f32 scale pools `k_scale`/`v_scale` (the pool's shape
without HD: one scale per token and KV head), with `cur_ks`/`cur_vs` [B,
KVH] for the appended row and `win_ks`/`win_vs` [B, KVH, Q] for the window.
The kernel reads the scale pools through the block table, as it reads the
values; the JAX package's per-row scale gather fed a TPU VMEM block and is
not taken over (the plain version gathers, as the XLA path did).

bf16 and float16 pools take q, cur_k/cur_v and window rows of their dtype
(the activation and pool dtypes of a 16-bit model) and return it; int8
pools take a float32, bf16 or float16 q and return q's dtype (a 16-bit
model's int8 KV).  The kernel widens everything to f32 and accumulates in
f32, as the TPU kernel does, rounding once at the output; the plain version
computes on f32 copies of q and the float rows, so it never takes the XLA
op's rounding of the probabilities to a 16-bit q's dtype.

The kernel cuts each row's visible tokens into chunks of C pages, one
block a chunk (`chunk_pages` picks C from static shapes only), and merges
the chunks of the rows that used more than one.  It takes any even HD <=
128 in float32, bf16 and float16 and HD % 4 == 0 in int8; the JAX
`supports()` gate (HD % 128 == 0) was a TPU DMA rule and has no
counterpart, so every paged decode on the card goes through the kernel.  `paged_attention` launches
the kernel for CUDA tensors and runs `paged_attention_plain` for CPU
tensors; there is no fallback from one to the other.  `paged_attention.launches` counts launches (one per call).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import core
from . import _build

# The C entry of each (pool dtype, q dtype) mode.
_ENTRIES = {(torch.float32, torch.float32): "l3t_paged_attention_f32",
            (torch.int8, torch.float32): "l3t_paged_attention_i8",
            (torch.int8, torch.bfloat16): "l3t_paged_attention_i8_bf16",
            (torch.int8, torch.float16): "l3t_paged_attention_i8_f16",
            (torch.bfloat16, torch.bfloat16): "l3t_paged_attention_bf16",
            (torch.float16, torch.float16): "l3t_paged_attention_f16"}


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          pos: torch.Tensor, k_scale=None, v_scale=None,
                          layer: Optional[int] = None, cur_k=None, cur_v=None,
                          cur_ks=None, cur_vs=None, win_k=None, win_v=None,
                          win_ks=None, win_vs=None,
                          win_count: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch: the gather oracle
    (`ops.core.paged_attention`, or `paged_attention_stacked` when `layer`
    is given).  A 16-bit q runs it on f32 copies of q and of the float rows
    (16-bit pools: the pool of the layer read; int8 pools and their f32
    scales as they are) and returns q's dtype: the kernel's f32 math, one
    rounding at the output."""
    if q.dtype != torch.float32:
        if layer is not None:
            k_pages, v_pages = k_pages[layer : layer + 1], v_pages[layer : layer + 1]
            if k_scale is not None:
                k_scale, v_scale = k_scale[layer : layer + 1], v_scale[layer : layer + 1]
            layer = 0
        up = [None if t is None else t.float() if t.is_floating_point() else t
              for t in (q, k_pages, v_pages, cur_k, cur_v, win_k, win_v)]
        return paged_attention_plain(
            *up[:3], block_table, pos, k_scale, v_scale, layer, *up[3:5],
            cur_ks, cur_vs, *up[5:], win_ks, win_vs, win_count).to(q.dtype)
    if layer is None:
        return core.paged_attention(q, k_pages, v_pages, block_table, pos,
                                    k_scale=k_scale, v_scale=v_scale)
    return core.paged_attention_stacked(
        q, k_pages, v_pages, layer, block_table, pos, cur_k=cur_k,
        cur_v=cur_v, win_k=win_k, win_v=win_v, win_count=win_count,
        k_scale_pool=k_scale, v_scale_pool=v_scale, cur_ks=cur_ks,
        cur_vs=cur_vs, win_ks=win_ks, win_vs=win_vs)


def _check_args(q, k_pages, v_pages, block_table, pos, layer, cur_k, cur_v,
                win_k, win_v, win_count, scales):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_attention takes q [B, 1, NH, HD], got {tuple(q.shape)}")
    B, _, NH, HD = q.shape
    stacked = layer is not None
    want_dim = 5 if stacked else 4
    if k_pages.dim() != want_dim or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention takes pools of {want_dim} dims "
                         f"({'[NL, P, KVH, page, HD]' if stacked else '[P, KVH, page, HD]'}); "
                         f"got {tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    KVH, hd = k_pages.shape[-3], k_pages.shape[-1]
    if hd != HD or NH % KVH:
        raise ValueError(f"q {tuple(q.shape)} and pools {tuple(k_pages.shape)} disagree")
    if stacked and not 0 <= layer < k_pages.shape[0]:
        raise ValueError(f"layer {layer} outside the pools' {k_pages.shape[0]} layers")
    if block_table.dim() != 2 or block_table.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"block_table must be [B, maxp] and pos [B] for B={B}; got "
                         f"{tuple(block_table.shape)} / {tuple(pos.shape)}")
    if stacked != (cur_k is not None) or (cur_k is None) != (cur_v is None):
        raise ValueError("stacked mode (layer given) takes cur_k and cur_v, "
                         "plain mode neither")
    if stacked and (tuple(cur_k.shape) != (B, KVH, HD) or cur_v.shape != cur_k.shape):
        raise ValueError(f"cur_k/cur_v must be [B, KVH, HD] = [{B}, {KVH}, {HD}]")
    window = win_k is not None
    if window:
        if not stacked:
            raise ValueError("window mode requires stacked mode")
        if win_k.dim() != 4 or tuple(win_k.shape[:2]) != (B, KVH) \
                or win_k.shape[3] != HD or win_v is None or win_v.shape != win_k.shape:
            raise ValueError(f"win_k/win_v must be [B, KVH, Q, HD] = [{B}, {KVH}, Q, {HD}]")
        if win_count is None or not 0 <= int(win_count) <= win_k.shape[2]:
            raise ValueError(f"win_count must be in [0, {win_k.shape[2]}], got {win_count}")
    elif win_v is not None:
        raise ValueError("win_v given without win_k")
    # int8: every scale that the mode reads, of its row's shape without HD.
    want = {"k_scale": k_pages.shape[:-1], "v_scale": k_pages.shape[:-1]}
    if stacked:
        want.update(cur_ks=(B, KVH), cur_vs=(B, KVH))
    if window:
        want.update(win_ks=win_k.shape[:-1], win_vs=win_k.shape[:-1])
    quant = k_pages.dtype == torch.int8
    given = {n for n, t in scales.items() if t is not None}
    if given != (set(want) if quant else set()):
        raise ValueError(f"int8 pools take the scales {sorted(want)} and float "
                         f"pools none; got {sorted(given)}")
    for name in given:
        if tuple(scales[name].shape) != tuple(want[name]):
            raise ValueError(f"{name} must be {list(want[name])}, got "
                             f"{list(scales[name].shape)}")
    tensors = [q, k_pages, v_pages, block_table, pos] + [
        t for t in (cur_k, cur_v, win_k, win_v, *scales.values()) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: every tensor must lie on q's device")
    return tensors


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_pages(B: int, KVH: int, page: int, maxp: int, sm_count: int) -> int:
    """C, the pages one block of the kernel walks: each row's visible tokens
    are cut into chunks of C pages, one block a chunk, and a row that fits
    one chunk needs no merge.  A pure function of static shapes (never of
    `pos`, so no host sync): about four blocks an SM were every row full,
    kept to 128-256 tokens a block (the kernel streams 64-token tiles
    through a ring of 2 or 3 stages), at least one page and at most the
    table."""
    lo = max(1, 128 // page)
    hi = max(lo, 256 // page)
    want = B * KVH * maxp // (4 * sm_count)
    return max(1, min(max(lo, min(want, hi)), maxp))


def schedule(q: torch.Tensor, k_pages: torch.Tensor, block_table: torch.Tensor,
             pos: torch.Tensor, sm_count: int) -> tuple:
    """(C, S) of a call: the chunk size (`chunk_pages`) and the grid's
    chunks a row, S = ceil(maxp / C), from the shapes of the call's tensors
    alone.  pos's values are never read (they lie on the card: reading them
    would make the host wait); the kernel finds each row's chunks from them
    itself."""
    B, maxp = block_table.shape
    if tuple(pos.shape) != (B,) or q.shape[0] != B:
        raise ValueError("schedule takes q [B, ...], block_table [B, maxp] and pos [B]")
    C = chunk_pages(B, k_pages.shape[-3], k_pages.shape[-2], maxp, sm_count)
    return C, -(-maxp // C)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor, k_scale=None, v_scale=None,
                    layer: Optional[int] = None, cur_k=None, cur_v=None,
                    cur_ks=None, cur_vs=None, win_k=None, win_v=None,
                    win_ks=None, win_vs=None,
                    win_count: Optional[int] = None) -> torch.Tensor:
    """Decode attention over the paged cache, following the block tables.

    q: [B, 1, NH, HD]; pools [P, KVH, page, HD] (or [NL, P, KVH, page, HD]
    with `layer`), float32, bf16, float16, or int8 with their scale pools;
    block_table [B, maxp] (unused entries -> null page 0); pos [B].  Modes
    and scales as the module docstring sets out.  A row whose pos ran past
    its table attends the table's pages and stays in bounds.  Returns [B,
    1, NH, HD].  CUDA tensors must be contiguous: float32 q, pools and
    rows; a float32, bf16 or float16 q with int8 pools and rows and float32
    scales; or bf16 (float16) q, pools and rows; block_table and pos
    int32.
    """
    scales = dict(k_scale=k_scale, v_scale=v_scale, cur_ks=cur_ks,
                  cur_vs=cur_vs, win_ks=win_ks, win_vs=win_vs)
    tensors = _check_args(q, k_pages, v_pages, block_table, pos, layer,
                          cur_k, cur_v, win_k, win_v, win_count, scales)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table, pos,
                                     layer=layer, cur_k=cur_k, cur_v=cur_v,
                                     win_k=win_k, win_v=win_v,
                                     win_count=win_count, **scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, not {q.device}")
    quant = k_pages.dtype == torch.int8
    rows = [t for t in (k_pages, v_pages, cur_k, cur_v, win_k, win_v) if t is not None]
    floats = [t for t in scales.values() if t is not None]
    entry = _ENTRIES.get((k_pages.dtype, q.dtype))
    if entry is None or any(t.dtype != k_pages.dtype for t in rows) \
            or any(t.dtype != torch.float32 for t in floats):
        raise NotImplementedError(
            f"the paged_attention kernel takes float32, bf16 or float16 pools "
            f"and rows under a q of their dtype, or int8 ones with float32 "
            f"scales under a float32, bf16 or float16 q (got {k_pages.dtype} "
            f"pools, {q.dtype} q)")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_attention takes int32 block_table and pos on the card")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention takes contiguous tensors")
    B, _, NH, HD = q.shape
    elem = k_pages.element_size()  # the kernel copies rows in pieces of:
    vec_bytes = 16 if HD * elem % 16 == 0 else 4
    if any(t.data_ptr() % vec_bytes for t in rows):
        raise ValueError(f"paged_attention copies pools and rows in {vec_bytes}-byte "
                         "pieces: they must be aligned to that")
    KVH, page = k_pages.shape[-3], k_pages.shape[-2]
    P, maxp = k_pages.shape[-4], block_table.shape[1]
    G = NH // KVH
    if HD % (4 if quant else 2) or HD > 128 or G * HD > 2048:
        raise ValueError(f"the paged_attention kernel takes head_dim <= 128 "
                         f"(a multiple of {4 if quant else 2}) and G*HD <= 2048; "
                         f"got HD={HD}, G={G}")
    win_q = 0 if win_k is None else win_k.shape[2]
    win_count = 0 if win_k is None else int(win_count)
    lib = _build.KernelLibrary.get()
    C, S = schedule(q, k_pages, block_table, pos, _sm_count(q.device.index))
    o = torch.empty_like(q)
    scratch = torch.empty(B * KVH * S * G * (HD + 2) if S > 1 else 1,
                          dtype=torch.float32, device=q.device)
    part_ml = scratch[: B * KVH * S * G * 2]
    part_acc = scratch[B * KVH * S * G * 2 :] if S > 1 else scratch

    def ptr(t):
        return None if t is None else t.data_ptr()

    ints = (B, NH, KVH, HD, P, page, maxp, 0 if layer is None else int(layer),
            int(layer is not None), win_q, win_count, C, q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)
    if quant:
        rc = getattr(lib, entry)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), block_table.data_ptr(),
            pos.data_ptr(), ptr(cur_k), ptr(cur_v), ptr(cur_ks), ptr(cur_vs),
            ptr(win_k), ptr(win_v), ptr(win_ks), ptr(win_vs), o.data_ptr(),
            part_ml.data_ptr(), part_acc.data_ptr(), *ints)
    else:
        rc = getattr(lib, entry)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), ptr(cur_k), ptr(cur_v),
            ptr(win_k), ptr(win_v), o.data_ptr(), part_ml.data_ptr(),
            part_acc.data_ptr(), *ints)
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
