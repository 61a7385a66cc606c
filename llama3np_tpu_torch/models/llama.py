"""Llama-family model: a functional forward over the stacked parameter tree
plus the stateful engine with the reference's object API.

Counterpart of `llama3np_tpu.models.llama`.  Parameters are the fused,
rope-split tree of tensors (`checkpoint.fuse_param_tree`), the KV cache is
the dense `[NL, B, KVH, M, HD]` pair updated in place, and the layer loop is
a Python loop over the stacked weights.  First-chunk prefill attention goes
through the flash kernel on the card; the greedy decode loop through the
fused decode kernel (`generate.kernel_decode_steps`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint import (build_param_tree, fuse_param_tree, load_parameters,
                          params_to_device, permute_rope_layout)
from ..config import ModelArgs
from ..kvcache import init_cache
from ..ops import core as ops
from ..ops.kernels.flash_prefill import flash_prefill


class StaticConfig(NamedTuple):
    """Structural config the forward reads (frozen)."""
    n_heads: int
    kv_heads: int
    head_dim: int
    norm_eps: float
    rope_split: bool = True      # wq/wk permuted to split-halves RoPE layout
    kv_block: int = 512          # blockwise-attention block (0 = always dense)
    kernels: bool = False        # CUDA kernels: flash prefill, fused decode

    @classmethod
    def from_args(cls, args: ModelArgs, device) -> "StaticConfig":
        on_cuda = torch.device(device).type == "cuda"
        impl = args.attn_impl
        if impl not in ("auto", "xla", "pallas"):
            raise ValueError(f"attn_impl must be auto, xla or pallas, not {impl!r}")
        if impl == "pallas" and not on_cuda:
            raise ValueError("attn_impl='pallas' asks for the CUDA kernels, which "
                             "need a CUDA device; use 'auto' or 'xla' on the CPU")
        return cls(args.n_heads, args.kv_heads, args.head_dim, args.norm_eps,
                   args.rope_split_layout, args.prefill_kv_block,
                   kernels=impl in ("auto", "pallas") and on_cuda)


def embed_tokens(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Embedding gather: ids [...] int64 -> [..., D]."""
    return F.embedding(ids, params["tok_embedding"])


def lm_logits(params: Dict, h: torch.Tensor) -> torch.Tensor:
    """Final projection to vocab logits [.., VS] in f32."""
    return ops._dot(h, params["lm_head"])


def _layer_step(cfg: StaticConfig, first_chunk: bool, pos: int, cos, sin,
                h: torch.Tensor, lp: Dict, ck: torch.Tensor,
                cv: torch.Tensor) -> torch.Tensor:
    """One transformer block.  h: [B, L, D]; ck/cv: this layer's cache
    [B, KVH, M, HD], written at pos..pos+L-1 in place."""
    L = h.shape[1]
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = ops.fused_qkv(x, lp["wqkv"], cfg.n_heads, cfg.kv_heads,
                            cfg.head_dim)
    rope = ops.apply_rope_split if cfg.rope_split else ops.apply_rope
    q = rope(q, cos, sin)
    k = rope(k, cos, sin)
    ops.update_kv_cache(ck, cv, k, v, pos)
    blockwise = (cfg.kv_block > 0 and L % cfg.kv_block == 0
                 and L >= 2 * cfg.kv_block)
    if first_chunk:
        if cfg.kernels:
            attn = flash_prefill(q, k, v.contiguous())
        elif blockwise:
            # Long prefill: flash-semantics accumulation bounds peak memory
            # at O(L * kv_block) instead of the O(L^2) dense score tensor.
            attn = ops.blockwise_causal_attention(q, k, v, pos, cfg.kv_block)
        else:
            attn = ops.causal_attention(q, k, v)
    elif L > 1 and cfg.kv_block > 0 and ck.shape[2] % cfg.kv_block == 0 \
            and ck.shape[2] >= 2 * cfg.kv_block:
        # Long chunked prefill against the cache (plain in both packages).
        attn = ops.blockwise_causal_attention(
            q, ck.transpose(1, 2), cv.transpose(1, 2), pos, cfg.kv_block)
    else:
        attn = ops.cache_attention(q, ck, cv, pos)
    h = h + ops.fused_o_proj(attn, lp["wo"]).to(h.dtype)
    z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + ops.fused_ffn(z, lp["wgu"], lp["w_down"])


def forward_hidden(params: Dict, input_ids: torch.Tensor, pos: int,
                   cache: Dict, cos, sin, cfg: StaticConfig,
                   first_chunk: bool):
    """Embed -> N blocks -> pre-norm hidden states.

    input_ids: [B, L] int64; pos: host int.  Returns (h [B, L, D], cache),
    the cache updated in place.
    """
    L = input_ids.shape[1]
    h = embed_tokens(params, input_ids)
    cos_l, sin_l = cos[pos : pos + L], sin[pos : pos + L]
    layers = params["layers"]
    for i in range(layers["wqkv"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        h = _layer_step(cfg, first_chunk, pos, cos_l, sin_l, h, lp,
                        cache["k"][i], cache["v"][i])
    return h, cache


def forward(params: Dict, input_ids: torch.Tensor, pos: int, cache: Dict,
            cos, sin, cfg: StaticConfig, first_chunk: bool):
    """Full forward returning last-position logits [B, 1, VS] (the reference
    never materializes [B, L, VS]; quirk Q8)."""
    h, cache = forward_hidden(params, input_ids, pos, cache, cos, sin, cfg,
                              first_chunk)
    h = ops.rms_norm(h[:, -1:, :], params["norm"], cfg.norm_eps)
    return lm_logits(params, h), cache


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no silent CPU)."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; the port runs on the card "
                               "unless the caller asks for device='cpu'")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Llama:
    """Stateful engine over the functional core (reference-compatible API).

    Runs on `device` ("cuda" by default; it raises if there is no card).
    This slice is unquantised and single-device; a bf16 model runs on the
    card only with attn_impl="xla" (the kernels take float32)."""

    def __init__(self, model_source: Union[str, Dict], args: ModelArgs,
                 device="cuda"):
        self.args = args.validate()
        self.device = resolve_device(device)
        if args.quant or args.kv_quant:
            raise NotImplementedError("quantisation is still to port (ROADMAP.md)")
        if not args.fuse_matmuls:
            raise NotImplementedError("the port runs the fused layout only "
                                      "(fuse_matmuls=True)")
        self.cfg = StaticConfig.from_args(args, self.device)
        if self.cfg.kernels and args.dtype != "float32":
            raise NotImplementedError(
                f"the CUDA kernels take float32; {args.dtype} kernels are still "
                "to port (ROADMAP.md); pass attn_impl='xla' for a bf16 model")
        if self.device.type == "cuda" and args.dtype == "float32":
            # fp32 parity: the JAX path accumulates in full f32, and TF32
            # keeps only ~3 decimal digits, so both switches go off.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        weights = (load_parameters(model_source)
                   if isinstance(model_source, str) else model_source)
        tree = build_param_tree(weights, args)
        if args.rope_split_layout:
            tree = permute_rope_layout(tree, args)
        self.params = params_to_device(fuse_param_tree(tree), self.device,
                                       args.dtype)
        self.cos, self.sin = ops.rope_tables(
            args.head_dim, args.max_seq_len, args.rope_theta, torch.float32,
            scaling=args.rope_scaling, device=self.device)
        self.cache = self.init_cache()
        self._gen = None  # built lazily by the generate paths

    # -- cache --------------------------------------------------------------

    def init_cache(self, batch_size: Optional[int] = None) -> Dict:
        return init_cache(self.args, batch_size, device=self.device)

    def reset(self):
        self.cache = self.init_cache()

    # -- reference-compatible forward --------------------------------------

    def __call__(self, input_ids, start_pos: int) -> np.ndarray:
        """Reference API: logits [B, 1, VS] for the last position, updating
        the engine's persistent KV cache."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        first = start_pos == 0 and ids.shape[1] > 1
        logits, self.cache = forward(self.params, ids, int(start_pos),
                                     self.cache, self.cos, self.sin, self.cfg,
                                     first)
        return logits.cpu().numpy()

    # -- generation ---------------------------------------------------------

    def generate(self, input_ids, max_new_tokens: int):
        """Greedy generator yielding [B, 1] int arrays, one per token.

        Count-compatible with the reference: `max_new_tokens` bounds the
        *total* length, so this yields `max_new_tokens - L` tokens (quirk
        Q2), computed as one prefill and one decode loop whose tokens stay
        on the device until a single transfer."""
        ids = np.asarray(input_ids)
        L = ids.shape[1]
        steps = min(max(max_new_tokens - L, 0), self.args.max_seq_len - L)
        toks = self.generate_tokens(ids, steps)
        for t in toks.cpu().numpy().T:  # [steps, B] -> per-step [B]
            yield t[:, None]

    def generate_tokens(self, input_ids, num_tokens: int,
                        sampling=None) -> torch.Tensor:
        """Decode exactly `num_tokens` new tokens greedily; returns them as
        [B, num_tokens] int64 on the engine's device.  `sampling` (a policy
        with a `temperature`) must be greedy in this slice."""
        from ..generate import Generator
        if self._gen is None:
            self._gen = Generator(self)
        ids = np.asarray(input_ids)
        toks, self.cache = self._gen.generate(
            self.params, ids, self.init_cache(ids.shape[0]), num_tokens,
            sampling=sampling)
        return toks
