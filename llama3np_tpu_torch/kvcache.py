"""Dense KV cache.

The cache is a pair of tensors covering all layers, in the JAX package's
layout:

    k: [n_layers, B, KVH, M, HD]
    v: [n_layers, B, KVH, M, HD]

The port updates it in place (the JAX package threads it functionally):
the forward writes each layer's new rows into `cache["k"][layer]`, and the
decode kernel writes its row at `pos` straight into the batch-1 view
`cache["k"][:, 0]`.  A position's row is contiguous, so that write is one
row.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .checkpoint import torch_dtype
from .config import ModelArgs


def init_cache(args: ModelArgs, batch_size: Optional[int] = None,
               max_seq_len: Optional[int] = None, dtype=None, *,
               device) -> Dict[str, torch.Tensor]:
    """Allocate a zeroed dense KV cache for `args` on `device`."""
    B = batch_size or args.max_batch_size
    M = max_seq_len or args.max_seq_len
    shape = (args.n_layers, B, args.kv_heads, M, args.head_dim)
    dt = torch_dtype(dtype or args.kv_dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def cache_nbytes(args: ModelArgs, batch_size: Optional[int] = None) -> int:
    """Bytes of the dense cache `init_cache(args, batch_size)` allocates."""
    B = batch_size or args.max_batch_size
    per_row = args.head_dim * torch_dtype(args.kv_dtype).itemsize
    return 2 * args.n_layers * B * args.kv_heads * args.max_seq_len * per_row
