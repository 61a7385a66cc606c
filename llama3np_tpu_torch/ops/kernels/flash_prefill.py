"""Flash prefill attention: causal GQA self-attention for the start_pos == 0
prefill, as a hand-written CUDA kernel (`csrc/flash_prefill.cu`) beside its
plain PyTorch version.

Counterpart of `llama3np_tpu.ops.kernels.flash_prefill.flash_prefill`.  The
kernel masks a ragged L itself, so every first-chunk prefill on the card
goes through it; the JAX `supports(L)` gate was a TPU tiling rule and has no
counterpart.  float32 runs on CUDA cores or, in 64-row tiles, on tensor
cores through a 3-piece bf16 split (below); bf16 and float16 on tensor
cores, with the TPU kernel's f32 semantics: 16-bit products are exact in
f32, the f32 probabilities enter P.V as a hi + lo pair of 16-bit values (P
within 2^-16 in bf16; in float16 within 2^-22, or 2^-25 absolute where the
lo part is subnormal), the sums are f32 and the output is rounded once.
`flash_prefill` launches the kernel for CUDA tensors and runs
`flash_prefill_plain` for CPU tensors; there is no fallback from one to the
other.  `flash_prefill.launches` counts kernel launches.

The float32 kernel's grid follows `f32_plan`: query tiles of 16 or 64 rows
by L, and for L >= 256 each tile's keys cut into pieces merged by the last
piece to arrive (`csrc/flash_prefill.cu`).  64-row tiles run on tensor
cores where HD <= 64 (HD % 4 == 0, 16-byte aligned rows): every f32
operand as three bf16 pieces and each product as six MMAs, never TF32.
"""

from __future__ import annotations

import torch

from ..core import causal_attention
from . import _build

_ENTRIES = {torch.float32: "l3t_flash_prefill_f32",
            torch.bfloat16: "l3t_flash_prefill_bf16",
            torch.float16: "l3t_flash_prefill_f16"}


F32_KEY_TILE = 64  # keys a tile of the float32 kernel


def f32_plan(L: int) -> tuple:
    """(BM, KS) of the float32 kernel: BM query rows a block (16 for
    L <= 128, 64 beyond: there the kernel runs on tensor cores when HD <= 64
    and HD % 4 == 0) and at most KS key tiles of 64 a block: for L >= 256 a
    query tile's key tiles are cut into pieces of KS (at least 2 tiles a
    piece, at most two pieces a tile) that the kernel merges; below that
    one piece covers every tile.  A pure function of L."""
    BM = 16 if L <= 128 else 64
    n_kt = -(-L // F32_KEY_TILE)
    KS = n_kt if L < 256 else max(2, -(-n_kt // 2))
    return BM, KS


def f32_scratch_words(B: int, L: int, NH: int, HD: int) -> tuple:
    """(partial words, tickets) of a float32 call: a slot of BM rows x (m, l,
    HD rounded up to 4 accumulators) for every piece of every (batch, head,
    query tile), and a ticket a tile; (0, 0) when no tile is split."""
    BM, KS = f32_plan(L)
    pieces = -(-(-(-L // F32_KEY_TILE)) // KS)
    if pieces == 1:
        return 0, 0
    tiles = B * NH * -(-L // BM)
    return tiles * pieces * BM * (2 + -(-HD // 4) * 4), tiles


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: dense causal attention
    (`ops.core.causal_attention`) on f32 copies of q, k and v, the output in
    q's dtype (for float32 inputs, causal_attention itself).  q: [B, L, NH,
    HD]; k, v: [B, L, KVH, HD].  Returns [B, L, NH, HD]."""
    return causal_attention(q.float(), k.float(), v.float()).to(q.dtype)


def _check_args(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_prefill takes q [B,L,NH,HD], k/v [B,L,KVH,HD]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, L, NH, HD = q.shape
    if k.shape[0] != B or k.shape[1] != L or k.shape[3] != HD:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if NH % k.shape[2]:
        raise ValueError(f"kv heads ({k.shape[2]}) must divide heads ({NH})")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention over one block at start_pos == 0.

    q: [B, L, NH, HD]; k, v: [B, L, KVH, HD], any L >= 1, HD <= 128 (even
    in bf16 and float16).  Returns [B, L, NH, HD].  CUDA tensors must be
    contiguous and all float32, all bf16 or all float16.
    """
    _check_args(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on CUDA or CPU tensors, not {q.device}")
    if q.dtype not in _ENTRIES or not q.dtype == k.dtype == v.dtype:
        raise NotImplementedError(
            f"the flash_prefill kernel takes q, k, v all float32, all bf16 or "
            f"all float16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill takes contiguous q, k, v")
    B, L, NH, HD = q.shape
    if HD > 128:
        raise ValueError(f"flash_prefill takes head_dim <= 128, got {HD}")
    if q.dtype != torch.float32:  # tiles are copied in pieces of 16 or 4 bytes
        if HD % 2:
            raise ValueError(f"the {q.dtype} flash_prefill kernel takes an even "
                             f"head_dim, got {HD}")
        piece = 16 if HD % 8 == 0 else 4
        if any(t.data_ptr() % piece for t in (q, k, v)):
            raise ValueError(f"the {q.dtype} flash_prefill kernel copies q, k and v in "
                             f"{piece}-byte pieces: they must be aligned to that")
    lib = _build.KernelLibrary.get()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype == torch.float32:
        words, n_tickets = f32_scratch_words(B, L, NH, HD)
        part = torch.empty(words, dtype=torch.float32, device=q.device) if words else None
        tickets = _build.tickets("flash_prefill", q.device, stream, n_tickets)
        args += (part.data_ptr() if words else None, tickets.data_ptr())
        rest = f32_plan(L)
    else:
        rest = ()
    rc = getattr(lib, _ENTRIES[q.dtype])(*args, B, L, NH, k.shape[2], HD, *rest,
                                         q.device.index, stream)
    _build.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
