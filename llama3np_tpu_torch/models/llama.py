"""Llama-family model: a functional forward over the stacked parameter tree
plus the stateful engine with the reference's object API.

Counterpart of `llama3np_tpu.models.llama`.  Parameters are the fused,
rope-split tree of tensors (`checkpoint.fuse_param_tree`), the KV cache is
the dense `[NL, B, KVH, M, HD]` pair updated in place, and the layer loop is
a Python loop over the stacked weights.  First-chunk prefill attention goes
through the flash kernel on the card; the greedy decode loop through the
fused decode kernel (`generate.kernel_decode_steps`).

The serving path's ragged decode (`forward_ragged_decode`: every batch row
at its own position, over the dense cache or the page pool) and its quantum
loop (`ragged_decode_steps`) are here too; on the card a paged step runs
the paged-attention kernel once per layer.

int8 weights (`quant="int8"`) ride the same tree with `*_scale` leaves
beside the int8 payloads: every consumer post-scales its product.  int8 KV
caches carry "k_s"/"v_s" scales; new rows quantize once, when they are
made.  A bf16 model (every Llama-3 preset) holds bf16 weights, activations
and caches, and on the card runs the bf16 modes of the same kernels; a
float16 model their float16 modes.  int8 KV serves under any activation
dtype (the paged kernel takes a float32, bf16 or float16 q over int8
pools).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint import (build_param_tree, fuse_param_tree, load_parameters,
                          params_to_device, permute_rope_layout,
                          quantize_param_tree)
from ..config import ModelArgs
from ..kvcache import init_cache
from ..ops import core as ops
from ..ops.kernels.flash_prefill import flash_prefill
from ..ops.kernels.paged_attention import paged_attention


class StaticConfig(NamedTuple):
    """Structural config the forward reads (frozen)."""
    n_heads: int
    kv_heads: int
    head_dim: int
    norm_eps: float
    rope_split: bool = True      # wq/wk permuted to split-halves RoPE layout
    kv_block: int = 512          # blockwise-attention block (0 = always dense)
    kernels: bool = False        # CUDA kernels: flash prefill, fused decode,
                                 # paged attention

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
    """Embedding gather: ids [...] int64 -> [..., D]; an int8 row is
    multiplied by its row scale after the gather."""
    s = params.get("tok_embedding_scale")
    if s is None:
        return F.embedding(ids, params["tok_embedding"])
    h = params["tok_embedding"][ids].float() * s[:, 0][ids][..., None]
    return h.to(params["norm"].dtype)


def lm_logits(params: Dict, h: torch.Tensor) -> torch.Tensor:
    """Final projection to vocab logits [.., VS] in f32 (an int8 lm_head
    post-scales its columns)."""
    return ops._scaled_dot(h, params["lm_head"], params.get("lm_head_scale"))


def _layer_step(cfg: StaticConfig, first_chunk: bool, pos: int, cos, sin,
                h: torch.Tensor, lp: Dict, ck: torch.Tensor,
                cv: torch.Tensor) -> torch.Tensor:
    """One transformer block.  h: [B, L, D]; ck/cv: this layer's cache
    [B, KVH, M, HD], written at pos..pos+L-1 in place."""
    L = h.shape[1]
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = ops.fused_qkv(x, lp["wqkv"], cfg.n_heads, cfg.kv_heads,
                            cfg.head_dim, scale=lp.get("wqkv_scale"))
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
    h = h + ops.fused_o_proj(attn, lp["wo"], lp.get("wo_scale")).to(h.dtype)
    z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + _ffn(z, lp)


def _ffn(z: torch.Tensor, lp: Dict) -> torch.Tensor:
    return ops.fused_ffn(z, lp["wgu"], lp["w_down"], lp.get("wgu_scale"),
                         lp.get("w_down_scale"))


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


# ---------------------------------------------------------------------------
# Ragged (per-row position) decode: the serving path
# ---------------------------------------------------------------------------

def _refuse_unported(lora=None, adapter_ids=None, lora_rows=None):
    if lora is not None or adapter_ids is not None or lora_rows is not None:
        raise NotImplementedError("multi-LoRA serving is still to port "
                                  "(ROADMAP A7)")


def forward_ragged_decode(params: Dict, tokens: torch.Tensor,
                          pos: torch.Tensor, cache: Dict, cos, sin,
                          cfg: StaticConfig, block_table=None, pos0=None,
                          win=None, win_count: Optional[int] = None,
                          commit: bool = True, scale_rows=None, lora=None,
                          adapter_ids=None, lora_rows=None):
    """One decode step where every batch row sits at its own position.

    tokens: [B] integer ids; pos: [B] (row b's token goes to slot pos[b]),
    both on the cache's device.  Dense mode (block_table None): cache k/v
    are [NL, B, KVH, M, HD].  Paged mode: page pools [NL, P, KVH, page, HD]
    and block_table [B, maxp] int32 (kvcache.init_paged_cache).  int8
    caches (kv_quant="int8") also hold the scales "k_s"/"v_s"; the new K/V
    rows quantize when they are made (`ops.quantize_kv_rows`) and attention
    post-scales, dense or paged, plain or kernel.

    The cache is read-only through the layer loop: attention masks to
    kv_idx < pos0 and takes the current token's K/V as an explicit appended
    column, so no layer reads a row this step writes.  commit=True writes
    all layers' new rows once after the loop, in place, and returns (logits
    [B, VS], cache).  Deferred-commit mode (the quantum loop): pos0 [B] is
    the quantum's start position, `win` the in-flight window ({"k"/"v":
    [NL, B, KVH, Q, HD]}, int8 also "k_s"/"v_s") with `win_count` visible
    columns, and commit=False returns (logits, (k_rows, v_rows[, ks_rows,
    vs_rows])), each [NL, B, KVH, ...], for the caller to insert into the
    window.  `scale_rows`: every layer's int8 pool scales already gathered
    by the block table ([NL, B, KVH, maxp*page] each,
    `ops.gather_page_scales_all`), which the plain paged path reads instead
    of gathering per layer.

    On the card (`cfg.kernels`) paged attention runs the CUDA kernel, once
    per layer, which reads the scale pools through the block table itself;
    otherwise the gather form (`ops.paged_attention_stacked`).  Dense
    attention is plain in both packages.  LoRA (`lora`, `adapter_ids`,
    `lora_rows`, ROADMAP A7) is still to port and raises.
    """
    _refuse_unported(lora, adapter_ids, lora_rows)
    if pos0 is None:
        pos0 = pos
    quant = "k_s" in cache
    kc_all, vc_all = cache["k"], cache["v"]
    ks_all, vs_all = cache.get("k_s"), cache.get("v_s")
    NL, kv_dt = kc_all.shape[0], kc_all.dtype
    h = embed_tokens(params, tokens.long()[:, None])  # [B, 1, D]
    # Rows that overran max_seq_len mid-quantum take the last table row;
    # their outputs are discarded (the JAX package reads NaN there).
    pc = pos.long().clamp(0, cos.shape[0] - 1)
    cos_b, sin_b = cos[pc][:, None, None, :], sin[pc][:, None, None, :]
    hd = cfg.head_dim

    def rope_rows(x):  # [B, 1, H, HD] with per-row tables
        if cfg.rope_split:
            x1, x2 = x[..., : hd // 2], x[..., hd // 2 :]
        else:
            xp = x.reshape(*x.shape[:-1], hd // 2, 2)
            x1, x2 = xp[..., 0], xp[..., 1]
        r1 = x1 * cos_b - x2 * sin_b
        r2 = x1 * sin_b + x2 * cos_b
        if cfg.rope_split:
            return torch.cat([r1, r2], dim=-1).to(x.dtype)
        return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)

    layers = params["layers"]
    new_rows = []  # per layer: (k, v[, k_s, v_s])
    for li in range(NL):
        lp = {name: w[li] for name, w in layers.items()}
        x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q, k, v = ops.fused_qkv(x, lp["wqkv"], cfg.n_heads, cfg.kv_heads, hd,
                                scale=lp.get("wqkv_scale"))
        q = rope_rows(q)
        k = rope_rows(k)
        if quant:
            k8, k_s = ops.quantize_kv_rows(k)  # [B, 1, KVH, HD] + [B, 1, KVH]
            v8, v_s = ops.quantize_kv_rows(v)
            cur = (k8[:, 0].contiguous(), v8[:, 0].contiguous(),
                   k_s[:, 0].contiguous(), v_s[:, 0].contiguous())
        else:  # pool dtype: a read-back
            cur = (k[:, 0].to(kv_dt).contiguous(), v[:, 0].to(kv_dt).contiguous())
        # The columns appended to the cache's: this token's, and the window.
        cols = dict(zip(("cur_k", "cur_v", "cur_ks", "cur_vs"), cur))
        if win is not None:
            cols.update(win_k=win["k"][li], win_v=win["v"][li], win_count=win_count)
            if quant:
                cols.update(win_ks=win["k_s"][li], win_vs=win["v_s"][li])
        if block_table is not None and cfg.kernels:
            attn = paged_attention(q.contiguous(), kc_all, vc_all, block_table,
                                   pos0, k_scale=ks_all, v_scale=vs_all,
                                   layer=li, **cols)
        elif block_table is not None:
            if quant and scale_rows is not None:
                cols.update(k_scale_rows=scale_rows[0][li],
                            v_scale_rows=scale_rows[1][li])
            attn = ops.paged_attention_stacked(q, kc_all, vc_all, li,
                                               block_table, pos0,
                                               k_scale_pool=ks_all,
                                               v_scale_pool=vs_all, **cols)
        else:
            attn = ops.ragged_cache_attention(
                q, kc_all[li], vc_all[li], pos0,
                k_scale=None if ks_all is None else ks_all[li],
                v_scale=None if vs_all is None else vs_all[li], **cols)
        h = h + ops.fused_o_proj(attn, lp["wo"], lp.get("wo_scale")).to(h.dtype)
        z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + _ffn(z, lp)
        new_rows.append(cur)
    rows = tuple(torch.stack(r) for r in zip(*new_rows))  # [NL, B, KVH, ...]
    logits = lm_logits(params, ops.rms_norm(h[:, -1, :], params["norm"],
                                            cfg.norm_eps))
    if not commit:
        return logits, rows
    if block_table is not None:
        page, maxp = kc_all.shape[3], block_table.shape[1]
        p = pos.long()
        page_ids = torch.gather(block_table.long(), 1,
                                torch.clamp(p // page, max=maxp - 1)[:, None])[:, 0]
        cache = ops.commit_decode_rows_paged(cache, rows[0], rows[1], page_ids,
                                             p % page, *rows[2:])
    else:
        cache = ops.commit_decode_rows_dense(cache, rows[0], rows[1], pos,
                                             *rows[2:])
    return logits, cache


def token_logprobs(logits: torch.Tensor, chosen: torch.Tensor, k: int):
    """Serving log-probabilities: log_softmax over the raw logits at the
    chosen token, plus the top-k alternatives.  logits [B, VS], chosen [B],
    k >= 1.  Returns (chosen_lp [B] f32, top_ids [B, k] int64, top_lps
    [B, k] f32)."""
    lps = torch.log_softmax(logits.float(), dim=-1)
    chosen_lp = torch.gather(lps, 1, chosen.long()[:, None])[:, 0]
    top_lps, top_ids = torch.topk(lps, k, dim=-1)
    return chosen_lp, top_ids, top_lps


def init_decode_window(cache: Dict, B: int, num_steps: int) -> Dict:
    """Zeroed in-flight K/V window for a quantum: {"k"/"v": [NL, B, KVH, Q,
    HD]} in the pool dtype (int8 caches add f32 "k_s"/"v_s" [NL, B, KVH,
    Q]), on the cache's device."""
    k = cache["k"]
    NL, KVH, HD = k.shape[0], k.shape[2], k.shape[-1]
    shape = (NL, B, KVH, num_steps, HD)
    win = {"k": torch.zeros(shape, dtype=k.dtype, device=k.device),
           "v": torch.zeros(shape, dtype=cache["v"].dtype, device=k.device)}
    if "k_s" in cache:
        for name in ("k_s", "v_s"):
            win[name] = torch.zeros(shape[:-1], dtype=cache[name].dtype,
                                    device=k.device)
    return win


def insert_window_rows(win: Dict, rows, s: int) -> Dict:
    """Write one step's new rows (forward_ragged_decode commit=False:
    (k, v[, k_s, v_s]), each [NL, B, KVH, ...]) into window column `s`, in
    place."""
    for name, r in zip(("k", "v", "k_s", "v_s"), rows):
        win[name][:, :, :, s] = r
    return win


def commit_window(cache: Dict, win: Dict, pos0: torch.Tensor, block_table,
                  num_steps: int) -> Dict:
    """Commit a quantum's window to the paged pool or the dense cache."""
    if block_table is not None:
        return ops.commit_window_paged(cache, win, pos0, block_table, num_steps)
    return ops.commit_window_dense(cache, win, pos0, num_steps)


def ragged_decode_steps(params: Dict, tokens: torch.Tensor, pos: torch.Tensor,
                        cache: Dict, cos, sin, cfg: StaticConfig,
                        num_steps: int, block_table=None,
                        num_logprobs: Optional[int] = None, lora=None,
                        adapter_ids=None):
    """`num_steps` greedy ragged decode steps: the serving decode quantum.

    The cache is frozen for the quantum: each step attends it (tokens <
    pos[b]) plus the in-flight window of the quantum's own rows, and one
    commit writes the whole window after the loop.  So the kernel's window
    mode stays on the path and no step reads a row that it writes.  The
    plain paged path gathers every layer's int8 pool scales once for the
    quantum (`ops.gather_page_scales_all`); the kernel reads the scale
    pools itself.  The tokens stay on the device.  Returns (tokens [B,
    num_steps], cache); with num_logprobs=k, (tokens, (chosen_lp [B, n],
    top_ids [B, n, k], top_lps [B, n, k]), cache).  Paged mode requires
    the block tables to cover positions pos .. pos + num_steps - 1.
    """
    _refuse_unported(lora, adapter_ids)
    pos0 = pos
    scale_rows = None
    if block_table is not None and "k_s" in cache and not cfg.kernels:
        scale_rows = (ops.gather_page_scales_all(cache["k_s"], block_table),
                      ops.gather_page_scales_all(cache["v_s"], block_table))
    win = init_decode_window(cache, tokens.shape[0], num_steps)
    tok, toks, lps = tokens, [], []
    for s in range(num_steps):
        logits, rows = forward_ragged_decode(
            params, tok, pos0 + s, cache, cos, sin, cfg, block_table,
            pos0=pos0, win=win, win_count=s, commit=False,
            scale_rows=scale_rows)
        insert_window_rows(win, rows, s)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        if num_logprobs is not None:
            lps.append(token_logprobs(logits, tok, num_logprobs))
    cache = commit_window(cache, win, pos0, block_table, num_steps)
    toks = torch.stack(toks, dim=1)
    if num_logprobs is None:
        return toks, cache
    return toks, tuple(torch.stack(x, dim=1) for x in zip(*lps)), cache


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

def _refuse_unported_kernel_modes(args: ModelArgs):
    """The kernels run float32, bf16 and float16 models (float or int8
    weights, a float or int8 KV cache) with the float KV cache in the
    activation dtype; raise for the JAX package's `kv_dtype` override,
    which none of them takes yet."""
    if args.kv_dtype != args.dtype:
        raise NotImplementedError(f"a {args.kv_dtype} KV cache under {args.dtype} "
                                  "activations (the kv_dtype override) is still "
                                  "to port (ROADMAP B11); pass attn_impl='xla'")


class Llama:
    """Stateful engine over the functional core (reference-compatible API).

    Runs on `device` ("cuda" by default; it raises if there is no card),
    single-device, on the fused whole-layer layout.  dtype "float32",
    "bfloat16" (the Llama-3 presets' default) or "float16": on the card
    prefill runs the flash kernel, batch-1 greedy decode the fused decode
    kernel and the greedy head, and paged serving the paged-attention
    kernel, each in the model's dtype.  quant="int8" holds int8 weights
    with per-output-channel scales (built, permuted, fused, then quantized,
    as the JAX engine's whole-layer tree) under float32, bf16 or float16
    activations, and on the card batch-1 decode runs the decode kernel's
    int8 mode for that activation dtype.  kv_quant="int8" is read by
    `serving.BatchEngine`: int8 pools under any of the three activation
    dtypes.  On the card's kernel path a KV dtype other than the
    activations' (`kv_dtype`) raises NotImplementedError naming its
    ROADMAP item; attn_impl="xla" runs it plainly."""

    def __init__(self, model_source: Union[str, Dict], args: ModelArgs,
                 device="cuda"):
        self.args = args.validate()
        self.device = resolve_device(device)
        if not args.fuse_matmuls:
            raise NotImplementedError("the port runs the fused layout only "
                                      "(fuse_matmuls=True)")
        self.cfg = StaticConfig.from_args(args, self.device)
        if self.cfg.kernels:
            _refuse_unported_kernel_modes(args)
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
        tree = fuse_param_tree(tree)
        if args.quant == "int8":
            tree = quantize_param_tree(tree)
        self.params = params_to_device(tree, self.device, args.dtype)
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
