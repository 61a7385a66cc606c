"""KV cache containers: the dense cache, and the paged pool with its page
allocator (the serving path).

The dense cache is a pair of tensors covering all layers, in the JAX
package's layout:

    k: [n_layers, B, KVH, M, HD]
    v: [n_layers, B, KVH, M, HD]

The port updates it in place (the JAX package threads it functionally):
the forward writes each layer's new rows into `cache["k"][layer]`, and the
decode kernel writes its row at `pos` straight into the batch-1 view
`cache["k"][:, 0]`.  A position's row is contiguous, so that write is one
row.

The paged pool (`init_paged_cache`) and its host-side `PageAllocator` are
the counterparts of `llama3np_tpu.kvcache.init_paged_cache` and
`PageAllocator`: the same layout, the same reserved null page 0, the same
free-list order and refcounts.  Both take quant="int8" (int8 values with
f32 scales per token and KV head, the JAX package's shapes).
`init_latent_paged_cache` is the port's own: one latent row a token and
layer, for multi-head latent attention.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .checkpoint import torch_dtype
from .config import ModelArgs


def _check_quant(quant):
    if quant not in (None, "int8"):
        raise ValueError(f"unsupported kv quant {quant!r}")


def _zeros(shape, dt, quant, device) -> Dict[str, torch.Tensor]:
    """k/v of `shape` (int8 under quant="int8", with f32 scales "k_s"/"v_s"
    of `shape[:-1]`, one per (token, KV head))."""
    _check_quant(quant)
    if quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(args: ModelArgs, batch_size: Optional[int] = None,
               max_seq_len: Optional[int] = None, dtype=None,
               quant: Optional[str] = None, *,
               device, kv_heads: Optional[int] = None,
               n_layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Allocate a zeroed dense KV cache for `args` on `device`.
    quant="int8" (the serving engine's kv_quant) stores int8 rows plus
    per-(token, KV head) f32 scales "k_s"/"v_s" [NL, B, KVH, M].
    `kv_heads` / `n_layers`: a sharded rank's own (its KV heads under
    tensor parallelism, its stage's layers under pipelining)."""
    B = batch_size or args.max_batch_size
    M = max_seq_len or args.max_seq_len
    shape = (n_layers or args.n_layers, B, kv_heads or args.kv_heads, M,
             args.head_dim)
    return _zeros(shape, torch_dtype(dtype or args.kv_dtype), quant, device)


def cache_nbytes(args: ModelArgs, batch_size: Optional[int] = None,
                 quant: Optional[str] = None) -> int:
    """Bytes of the dense cache `init_cache(args, batch_size, quant=quant)`
    allocates."""
    _check_quant(quant)
    B = batch_size or args.max_batch_size
    per_row = args.head_dim * torch_dtype(args.kv_dtype).itemsize
    if quant == "int8":
        per_row = args.head_dim + 4  # int8 values + one f32 scale
    return 2 * args.n_layers * B * args.kv_heads * args.max_seq_len * per_row


# ---------------------------------------------------------------------------
# Paged KV cache (serving path)
# ---------------------------------------------------------------------------

def init_paged_cache(args: ModelArgs, num_pages: int, page_size: int = 16,
                     dtype=None, quant: Optional[str] = None, *,
                     device, kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zeroed page pools on `device`; pages go to sequences on demand, so
    device memory holds the tokens that exist, not `capacity x max_seq_len`
    dense rows.

        k, v: [n_layers, num_pages, KVH, page_size, HD]

    KVH comes before page_size so that one (page id, KV head) slice is a
    contiguous [page_size, HD] block, the unit the paged-attention kernel
    reads.  Page 0 is the null page: block tables point unused entries at
    it, and every read from it is masked off by the row's length.
    quant="int8": int8 pools plus per-(token, KV head) f32 scale pools
    "k_s"/"v_s" [NL, P, KVH, page_size], about a quarter of the fp32 bytes.
    `kv_heads`: a tensor-parallel rank's own KV heads.
    """
    shape = (args.n_layers, num_pages, kv_heads or args.kv_heads, page_size,
             args.head_dim)
    return _zeros(shape, torch_dtype(dtype or args.kv_dtype), quant, device)


def init_latent_paged_cache(n_layers: int, num_pages: int, page_size: int,
                            width: int, dtype, *, device) -> Dict[str, torch.Tensor]:
    """A zeroed latent page pool on `device` for multi-head latent
    attention (`models/deepseek_v2.py`), which caches one row a token and
    layer for all its heads (the normed compressed KV and the rotated
    shared rope key side by side) in place of K and V pools:

        latent: [n_layers, num_pages, page_size, width]

    in `dtype` (a name or a torch dtype).  A (layer, page) slice is one
    contiguous [page_size, width] block.  Page 0 is the null page, as in
    `init_paged_cache`, and the same `PageAllocator` hands out the rest."""
    shape = (n_layers, num_pages, page_size, width)
    return {"latent": torch.zeros(shape, dtype=torch_dtype(dtype), device=device)}


class PageAllocator:
    """Host-side refcounted free-list allocator over the page pool (page 0
    reserved).  A page returns to the free list when its last reference
    drops; `share` adds references (the prefix cache's use)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # stack; 0 reserved
        self._rc = [0] * num_pages

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV cache exhausted: need {n} pages, "
                f"{len(self._free)} free of {self.num_pages - 1}"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def share(self, pages) -> None:
        """Add a reference to already-allocated pages."""
        for p in pages:
            if p != 0:
                if self._rc[p] <= 0:
                    raise ValueError(f"share of free page {p}")
                self._rc[p] += 1

    def free(self, pages) -> None:
        for p in pages:
            if p != 0:
                if self._rc[p] <= 0:
                    raise ValueError(f"double free of page {p}")
                self._rc[p] -= 1
                if self._rc[p] == 0:
                    self._free.append(p)

    def refcount(self, page: int) -> int:
        return self._rc[page]

    @property
    def available(self) -> int:
        return len(self._free)
