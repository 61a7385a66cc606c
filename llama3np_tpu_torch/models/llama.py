"""Llama-family model: a functional forward over the stacked parameter tree
plus the stateful engine with the reference's object API.

Counterpart of `llama3np_tpu.models.llama`.  Parameters are the fused,
rope-split tree of tensors (`checkpoint.fuse_param_tree`) or the split tree
of `fuse_matmuls=False` (`_split_qkv`, `ops.swiglu`), the KV cache is
the dense `[NL, B, KVH, M, HD]` pair updated in place, and the layer loop is
a Python loop over the stacked weights.  First-chunk prefill attention goes
through the flash kernel on the card; the greedy decode loop through the
fused decode kernel (`generate.kernel_decode_steps`).

The serving path's ragged decode (`forward_ragged_decode`: every batch row
at its own position, over the dense cache or the page pool) and its quantum
loop (`ragged_decode_steps`) are here too; on the card a paged step runs
the paged-attention kernel once per layer.  Multi-LoRA serving (the split
layout): an admission prefills through its request's adapter
(`forward_hidden(lora=)`), and a ragged step adds each row's low-rank
deltas from the adapter bank (`gather_lora_rows`).

int8 weights (`quant="int8"`) ride the same tree with `*_scale` leaves
beside the int8 payloads: every consumer post-scales its product.  int4
weights (`quant="int4"`, the split tree only) are packed two a byte and
unpacked by the plain products (`ops.core._dot`) and the embedding gather.  int8 KV
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

from ..checkpoint import (build_param_tree, fuse_param_tree,
                          load_parameters, load_quantized_npz,
                          params_to_device, permute_rope_layout,
                          quantize_param_tree, unfuse_param_tree)
from ..config import ModelArgs
from .. import prng
from ..kvcache import init_cache
from ..observability import check_finite
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
    fused: bool = True           # wqkv / wgu instead of wq/wk/wv, w_gate/w_up
    mesh: Optional[object] = None  # parallel.sharding.Mesh: a sharded engine,
                                   # whose n_heads/kv_heads are this rank's

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
                   kernels=impl in ("auto", "pallas") and on_cuda,
                   fused=args.fuse_matmuls)


def tensor_parallel(mesh):
    """`mesh` when it splits the model over "tp" ranks, else None."""
    return mesh if mesh is not None and mesh.size("tp") > 1 else None


def embed_tokens(params: Dict, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Embedding gather: ids [...] int64 -> [..., D]; an int8 or int4 row
    is multiplied by its row scale after the gather (a packed int4 row is
    unpacked after it).  Under a tensor-parallel `mesh` the table holds
    this rank's vocabulary rows: ids outside them gather zeros, and the
    sum over "tp" is the whole gather (exact)."""
    tp = tensor_parallel(mesh)
    if tp is not None:
        lo = tp.index("tp") * params["tok_embedding"].shape[0]
        local = ids - lo
        inside = (local >= 0) & (local < params["tok_embedding"].shape[0])
        h = embed_tokens(params, torch.where(inside, local, 0))
        return tp.tp_reduce(h * inside[..., None].to(h.dtype))
    s = params.get("tok_embedding_scale")
    if s is None:
        return F.embedding(ids, params["tok_embedding"])
    rows = params["tok_embedding"][ids]
    if rows.dtype == torch.uint8:
        rows = ops.unpack_int4(rows, params["norm"].shape[-1], torch.float32)
    h = rows.float() * s[:, 0][ids][..., None]
    return h.to(params["norm"].dtype)


def lm_logits(params: Dict, h: torch.Tensor, mesh=None) -> torch.Tensor:
    """Final projection to vocab logits [.., VS] in f32 (an int8 or int4
    lm_head post-scales its columns); checked for NaN/Inf inside
    `observability.debug_mode`.  Under a tensor-parallel `mesh` the head
    holds this rank's vocabulary columns, and the logits are gathered to
    the whole vocabulary on every rank (exact)."""
    tp = tensor_parallel(mesh)
    if tp is not None:
        h = tp.tp_copy(h)
    logits = ops._scaled_dot(h, params["lm_head"], params.get("lm_head_scale"))
    if tp is not None:
        logits = tp.tp_gather(logits)
    check_finite(logits, "logits")
    return logits


def _split_qkv(x: torch.Tensor, lp: Dict, cfg: "StaticConfig"):
    """Q/K/V projections on the split weights; each is post-scaled (int8 or
    int4) and rounded to x's dtype, as the JAX package's `_split_qkv`."""
    B, L = x.shape[:2]

    def proj(name, heads):
        out = ops._scaled_dot(x, lp[name], lp.get(name + "_scale"))
        return out.to(x.dtype).reshape(B, L, heads, cfg.head_dim)

    return (proj("wq", cfg.n_heads), proj("wk", cfg.kv_heads),
            proj("wv", cfg.kv_heads))


def _qkv(x: torch.Tensor, lp: Dict, cfg: "StaticConfig"):
    if cfg.fused:
        return ops.fused_qkv(x, lp["wqkv"], cfg.n_heads, cfg.kv_heads,
                             cfg.head_dim, scale=lp.get("wqkv_scale"))
    return _split_qkv(x, lp, cfg)


ROW_SHARDED = ("wo", "w_down")  # tensor parallelism splits their input rows


def _lora_delta(x: torch.Tensor, ll: Dict, t: str, scale,
                mesh=None) -> Optional[torch.Tensor]:
    """Low-rank serving delta scale * (x@A)@B in f32 for ONE layer's
    factors, the rank-r product's input rounded to x's dtype; None when `t`
    is not an adapted target.  ll[f"{t}_a"] [in, r] / ll[f"{t}_b"] [r, out]
    are one adapter's (an admission), or [B, in, r] / [B, r, out] each row's
    own against x [B, 1, in] (a ragged step).  Under a tensor-parallel
    `mesh` the factors are this rank's (`lora.shard_lora`'s layout): a
    row-sharded target's x@A is a partial sum, summed over "tp" in f32
    before the rounding, and its delta is whole; a column-sharded target's
    delta is this rank's columns."""
    if f"{t}_a" not in ll:
        return None
    u = ops._dot(x, ll[f"{t}_a"])
    tp = tensor_parallel(mesh)
    if tp is not None and t in ROW_SHARDED:
        u = tp.tp_reduce(u)
    return scale * ops._dot(u.to(x.dtype), ll[f"{t}_b"])


def _reduce(cfg: "StaticConfig"):
    """The "tp" sum of a row-sharded product's partial, or None."""
    tp = tensor_parallel(cfg.mesh)
    return None if tp is None else tp.tp_reduce


def _add_qkv_deltas(q, k, v, x, delta):
    """q/k/v (already rounded to the activation dtype) plus each adapted
    target's delta `delta(t, x)`, rounded to q's dtype before the add, as
    the JAX serving paths add it."""
    out = []
    for t, y in (("wq", q), ("wk", k), ("wv", v)):
        d = delta(t, x)
        out.append(y if d is None else y + d.to(y.dtype).reshape(y.shape))
    return out


def _layer_step(cfg: StaticConfig, first_chunk: bool, pos: int, cos, sin,
                h: torch.Tensor, lp: Dict, ck: torch.Tensor,
                cv: torch.Tensor, ll: Optional[Dict] = None,
                lora_scale: float = 1.0) -> torch.Tensor:
    """One transformer block.  h: [B, L, D]; ck/cv: this layer's cache
    [B, KVH, M, HD], written at pos..pos+L-1 in place.  ll: one layer's
    single-adapter LoRA slices (a serving admission prefills its request
    through its adapter)."""
    L = h.shape[1]
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(x, lp, cfg)
    lora_cb = None
    if ll is not None:
        def lora_cb(t, xin):
            return _lora_delta(xin, ll, t, lora_scale, cfg.mesh)
        q, k, v = _add_qkv_deltas(q, k, v, x, lora_cb)
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
    h = h + ops.fused_o_proj(attn, lp["wo"], lp.get("wo_scale"),
                             lora=lora_cb, reduce=_reduce(cfg)).to(h.dtype)
    z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    return h + _ffn(z, lp, cfg, lora_cb)


def _ffn(z: torch.Tensor, lp: Dict, cfg: StaticConfig, lora=None) -> torch.Tensor:
    if cfg.fused:
        return ops.fused_ffn(z, lp["wgu"], lp["w_down"], lp.get("wgu_scale"),
                             lp.get("w_down_scale"))
    return ops.swiglu(z, lp["w_gate"], lp["w_up"], lp["w_down"],
                      lp.get("w_gate_scale"), lp.get("w_up_scale"),
                      lp.get("w_down_scale"), lora=lora, reduce=_reduce(cfg))


def forward_hidden(params: Dict, input_ids: torch.Tensor, pos: int,
                   cache: Dict, cos, sin, cfg: StaticConfig,
                   first_chunk: bool, lora: Optional[Dict] = None):
    """Embed -> N blocks -> pre-norm hidden states.

    input_ids: [B, L] int64; pos: host int.  Returns (h [B, L, D], cache),
    the cache updated in place.  lora: an optional SINGLE-adapter tree
    {"layers": {t_a: [NL, in, r], t_b: [NL, r, out]}, "scale": alpha/r}
    (`lora.bank_adapter_slice`): a serving admission prefills its request
    through its adapter.
    """
    L = input_ids.shape[1]
    h = embed_tokens(params, input_ids, cfg.mesh)
    cos_l, sin_l = cos[pos : pos + L], sin[pos : pos + L]
    layers = params["layers"]
    for i in range(layers["wo"].shape[0]):
        lp = {name: w[i] for name, w in layers.items()}
        ll = None if lora is None else {n: w[i] for n, w in lora["layers"].items()}
        h = _layer_step(cfg, first_chunk, pos, cos_l, sin_l, h, lp,
                        cache["k"][i], cache["v"][i], ll=ll,
                        lora_scale=1.0 if lora is None else lora["scale"])
    return h, cache


def forward(params: Dict, input_ids: torch.Tensor, pos: int, cache: Dict,
            cos, sin, cfg: StaticConfig, first_chunk: bool):
    """Full forward returning last-position logits [B, 1, VS] (the reference
    never materializes [B, L, VS]; quirk Q8)."""
    h, cache = forward_hidden(params, input_ids, pos, cache, cos, sin, cfg,
                              first_chunk)
    h = ops.rms_norm(h[:, -1:, :], params["norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg.mesh), cache


# ---------------------------------------------------------------------------
# Ragged (per-row position) decode: the serving path
# ---------------------------------------------------------------------------

def gather_lora_rows(lora_layers: Dict, adapter_ids: torch.Tensor) -> Dict:
    """Per-row adapter factors: {t: [NL, NA, ...]} gathered by adapter_ids
    [B] -> {t: [NL, B, ...]}.  The quantum loop gathers them once a
    dispatch (adapter assignments are frozen for it)."""
    ids = adapter_ids.long()
    return {name: bank[:, ids] for name, bank in lora_layers.items()}


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
    attention is plain in both packages.

    Multi-LoRA serving: `lora` is the engine's adapter bank ({"layers":
    {t_a: [NL, NA, in, r], t_b: [NL, NA, r, out]}, "scale": alpha/r}, bank
    slot 0 the zero adapter) and adapter_ids [B] picks each row's adapter;
    `lora_rows` is their per-row gather (`gather_lora_rows`), which the
    quantum loop makes once and which is made here when absent.  The
    deltas add to q/k/v after their rounding, and to wo and the FFN's
    products before it, as in the JAX package.
    """
    if lora is not None and lora_rows is None:
        lora_rows = gather_lora_rows(lora["layers"], adapter_ids)
    if pos0 is None:
        pos0 = pos
    quant = "k_s" in cache
    kc_all, vc_all = cache["k"], cache["v"]
    ks_all, vs_all = cache.get("k_s"), cache.get("v_s")
    NL, kv_dt = kc_all.shape[0], kc_all.dtype
    h = embed_tokens(params, tokens.long()[:, None], cfg.mesh)  # [B, 1, D]
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
        q, k, v = _qkv(x, lp, cfg)
        lora_cb = None
        if lora_rows is not None:
            ll = {name: rows[li] for name, rows in lora_rows.items()}  # [B, ...]

            def lora_cb(t, xin, ll=ll):
                return _lora_delta(xin, ll, t, lora["scale"], cfg.mesh)
            q, k, v = _add_qkv_deltas(q, k, v, x, lora_cb)
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
        h = h + ops.fused_o_proj(attn, lp["wo"], lp.get("wo_scale"),
                                 lora=lora_cb, reduce=_reduce(cfg)).to(h.dtype)
        z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
        h = h + _ffn(z, lp, cfg, lora_cb)
        new_rows.append(cur)
    rows = tuple(torch.stack(r) for r in zip(*new_rows))  # [NL, B, KVH, ...]
    logits = lm_logits(params, ops.rms_norm(h[:, -1, :], params["norm"],
                                            cfg.norm_eps), cfg.mesh)
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


def _ragged_quantum(params: Dict, tokens: torch.Tensor, pos: torch.Tensor,
                    cache: Dict, cos, sin, cfg: StaticConfig, num_steps: int,
                    block_table, num_logprobs: Optional[int], pick, lora=None,
                    adapter_ids=None):
    """The quantum loop of `ragged_decode_steps` and
    `sampled_ragged_decode_steps`; `pick(logits, s)` chooses step s's
    tokens [B].  The adapter rows are gathered once for the quantum."""
    pos0 = pos
    lora_rows = (None if lora is None
                 else gather_lora_rows(lora["layers"], adapter_ids))
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
            scale_rows=scale_rows, lora=lora, lora_rows=lora_rows)
        insert_window_rows(win, rows, s)
        tok = pick(logits, s)
        toks.append(tok)
        if num_logprobs is not None:
            lps.append(token_logprobs(logits, tok, num_logprobs))
    cache = commit_window(cache, win, pos0, block_table, num_steps)
    toks = torch.stack(toks, dim=1)
    if num_logprobs is None:
        return toks, cache
    return toks, tuple(torch.stack(x, dim=1) for x in zip(*lps)), cache


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
    `lora`/`adapter_ids`: the adapter bank and each row's bank slot
    (`forward_ragged_decode`).
    """
    return _ragged_quantum(params, tokens, pos, cache, cos, sin, cfg,
                           num_steps, block_table, num_logprobs,
                           lambda logits, s: torch.argmax(logits, dim=-1),
                           lora, adapter_ids)


def fold_row_keys(base_key, rids, ctrs) -> np.ndarray:
    """Per-row keys fold_in(fold_in(base, request_id), token_index) (the
    JAX package's `fold_row_keys`), computed on the host: base_key a key
    [2] (a host tensor or array), rids and ctrs integer arrays that
    broadcast together -> int64 keys [..., 2] for the caller to move to
    its device at once.  A request's stream is a pure function of (engine
    seed, request id, token index), whatever its co-tenants, admission
    time or quantum.  The threefry runs as numpy vector ops on the rows
    (a few hundred on arrays of B entries) instead of a few hundred device
    launches a step."""
    k = np.asarray(base_key, np.int64)
    r, c = np.broadcast_arrays(np.asarray(rids, np.int64) & prng.MASK32,
                               np.asarray(ctrs, np.int64) & prng.MASK32)
    a0, a1 = prng.threefry2x32(k[0], k[1], np.zeros_like(r), r)
    return np.stack(prng.threefry2x32(a0, a1, np.zeros_like(c), c), axis=-1)


def top_k_mask(scaled: torch.Tensor, k: int) -> torch.Tensor:
    """-inf below the k-th largest entry of each row (entries equal to it
    stay)."""
    kth = torch.topk(scaled, k, dim=-1).values[..., -1:]
    return torch.where(scaled < kth, -torch.inf, scaled)


def top_p_mask(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus mask, in JAX's op order: sort descending, the exclusive
    cumsum of the softmax (exp(x - max) / sum), the cutoff by index, -inf
    below the cutoff's value."""
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    e = torch.exp(sorted_logits - sorted_logits[..., :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1) - probs  # exclusive cumsum
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True) - 1
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(scaled < cutoff, -torch.inf, scaled)


def sample_rows(logits: torch.Tensor, keys: torch.Tensor, temps: torch.Tensor,
                top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Per-row sampling for batched serving (the JAX package's
    `sample_rows`): logits [B, VS] f32, keys [B, 2] (`fold_row_keys`),
    temps [B] f32 (0 keeps that row greedy); top_k / top_p engine-wide.
    Each row divides by max(temp, 1e-6), takes the masks and its own
    Gumbel draw (`prng.categorical` under its key)."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits.float() / torch.clamp_min(temps.float(), 1e-6)[:, None]
    if top_k:
        scaled = top_k_mask(scaled, top_k)
    if top_p < 1.0:
        scaled = top_p_mask(scaled, top_p)
    return torch.where(temps > 0, prng.categorical(keys, scaled), greedy)


def sampled_ragged_decode_steps(params: Dict, tokens: torch.Tensor,
                                pos: torch.Tensor, cache: Dict, cos, sin,
                                keys: torch.Tensor, temps: torch.Tensor,
                                cfg: StaticConfig, num_steps: int,
                                top_k: int = 0, top_p: float = 1.0,
                                block_table=None,
                                num_logprobs: Optional[int] = None,
                                lora=None, adapter_ids=None):
    """`ragged_decode_steps` with per-row sampling (temps[b] == 0 keeps
    row b greedy): step s draws row b under keys[b, s] ([B, num_steps, 2]
    on the cache's device; the JAX package's fold_row_keys(base_key,
    rids[b], ctrs[b] + s), `fold_row_keys` made on the host for the whole
    quantum).  Log-probabilities, when asked for, are of the drawn token
    under the raw (untempered) distribution.  `lora`/`adapter_ids` as in
    `ragged_decode_steps`."""
    return _ragged_quantum(
        params, tokens, pos, cache, cos, sin, cfg, num_steps, block_table,
        num_logprobs,
        lambda logits, s: sample_rows(logits, keys[:, s], temps, top_k, top_p),
        lora, adapter_ids)


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

_PRECISIONS = (None, "default", "highest")


def _cache_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A cache tensor as the array the JAX package's `np.savez` writes: a
    bf16 cache as its 2-byte payload ('V2', what numpy stores for an
    ml_dtypes bfloat16 array), the others as they are."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _cache_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """The inverse of `_cache_to_numpy`: a 2-byte void array (a bf16 cache,
    written by either package) is read as bf16 bits, never through
    ml_dtypes."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class Llama:
    """Stateful engine over the functional core (reference-compatible API).

    Runs on `device` ("cuda" by default; it raises if there is no card),
    single-device.  dtype "float32", "bfloat16" (the Llama-3 presets'
    default) or "float16": on the card prefill runs the flash kernel,
    batch-1 greedy decode the fused decode kernel and the greedy head, and
    paged serving the paged-attention kernel, each in the model's dtype.
    quant="int8" holds int8 weights with per-output-channel scales (built,
    permuted, fused, then quantized, as the JAX engine's whole-layer tree)
    under float32, bf16 or float16 activations, and on the card batch-1
    decode runs the decode kernel's int8 mode for that activation dtype.
    fuse_matmuls=False keeps the split weights (built, permuted, then
    quantized at quant's width): prefill and serving still run their
    kernels, decode the plain forward, since the decode kernel reads the
    fused tree.  quant="int4" (weights packed two a byte) runs only that
    split layout, as in the JAX package.  kv_quant="int8" is read by
    `serving.BatchEngine`: int8 pools under any of the three activation
    dtypes.  A float KV cache of another dtype than the activations'
    (`kv_dtype`, e.g. float32 over a bf16 cache) runs the kernels' override
    modes: the decode kernel and the paged kernel read and write the cache
    in its dtype, flash prefill attends the new K/V before their cast, as
    the JAX engine's.  `from_quantized` boots from a quantized checkpoint
    of either package.

    `precision` takes the JAX engine's values (None, "default",
    "highest"), which there pick XLA's matmul precision.  Here every one of
    them keeps f32 sums with TF32 off on the float32 path (on the CPU, the
    oracle, the JAX engine computes them alike too).

    `save_generation_state` / `resume_generate` write and continue a
    greedy generation in the JAX package's file format (the cache, the
    last position and last tokens), so either package resumes the other's
    file.

    `mesh` (`parallel.sharding.make_mesh`, in every rank of a
    torch.distributed group) makes the engine this rank's part of a
    tensor- and data-parallel one, as the JAX engine's `mesh=`: the split
    layout (quantized whole, then sharded: each scale is that of the
    whole column), this rank's shards on `mesh.device` (the `device`
    argument is not read), caches of this rank's KV heads (and dp rows),
    and the model's collectives at the row-sharded products, the
    embedding and the logits.  On the card its prefill runs the flash
    kernel and its paged serving steps the paged kernel, on this rank's
    heads; its decode runs the split layout's plain forward (the fused
    decode kernel has no point between wo and the FFN for the sum).
    Every rank returns the same tokens and logits."""

    mesh = None  # a sharded engine's parallel.sharding.Mesh

    def __init__(self, model_source: Union[str, Dict], args: ModelArgs,
                 device="cuda", precision: Optional[str] = None, mesh=None):
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, not {precision!r}")
        self.args = args.validate()
        fused = args.fuse_matmuls and mesh is None
        if args.quant == "int4" and fused:
            raise ValueError(
                "quant='int4' runs the unfused split layout (the fused "
                "decode kernel consumes int8 blocks only); set "
                "fuse_matmuls=False")
        weights = (load_parameters(model_source)
                   if isinstance(model_source, str) else model_source)
        tree = build_param_tree(weights, args)
        if args.rope_split_layout:
            tree = permute_rope_layout(tree, args)
        # A sharded engine quantizes the whole split tree, then shards it
        # (scales with their weights), as the JAX engine's `mesh=`.
        qdev = resolve_device(device if mesh is None else mesh.device)
        if fused:
            tree = fuse_param_tree(tree)
        if args.quant:
            # On the card the weights quantize there (the JAX package's
            # `device=True` path: the same codes and scales, at HBM speed
            # instead of minutes of host numpy at 8B); each weight is first
            # rounded to the activation dtype, as the JAX engine's tree is
            # cast before it quantizes.
            tree = quantize_param_tree(
                tree, bits=4 if args.quant == "int4" else 8,
                device=qdev if qdev.type == "cuda" else None, dtype=args.dtype)
        if mesh is not None:
            self._init_mesh(tree, mesh, args.rope_split_layout, args.dtype)
            return
        self.device = qdev
        self.cfg = StaticConfig.from_args(args, self.device)
        self._finish_init(params_to_device(tree, self.device, args.dtype))

    @classmethod
    def from_quantized(cls, path: str, args: ModelArgs, device="cuda",
                       mesh=None) -> "Llama":
        """Boot from a quantized checkpoint (`checkpoint.save_quantized_npz`,
        or the JAX package's file of the same name): the tree loads as it
        is, each leaf in its own dtype (no float32 staging, no
        re-quantization), and runs the split layout's paths, as the JAX
        package's `from_quantized`: single-device, or this rank's shards of
        it (scales with their weights) under `mesh`."""
        params, rope_split = load_quantized_npz(path)
        self = cls.__new__(cls)
        self.args = args.validate()
        if mesh is not None:
            self._init_mesh(params, mesh, rope_split, None)
            return self
        self.device = resolve_device(device)
        self.cfg = StaticConfig.from_args(args, self.device)._replace(
            rope_split=rope_split, fused="wqkv" in params["layers"])
        self._finish_init(params_to_device(params, self.device))
        return self

    @classmethod
    def from_param_tree(cls, params: Dict, args: ModelArgs, device="cuda",
                        mesh=None) -> "Llama":
        """An engine over a parameter tree already in the engine's layout
        (`build_param_tree` [+ `permute_rope_layout`, as
        args.rope_split_layout says] [+ `fuse_param_tree`] [+
        `quantize_param_tree`]; numpy leaves, or
        tensors on any device): single-device on `device`, the leaves cast
        to args.dtype (scales and integer codes kept), or under `mesh`
        this rank's shards of a split tree, copied."""
        self = cls.__new__(cls)
        self.args = args.validate()
        if mesh is not None:
            self._init_mesh(params, mesh, args.rope_split_layout, args.dtype)
            return self
        self.device = resolve_device(device)
        self.cfg = StaticConfig.from_args(args, self.device)._replace(
            fused="wqkv" in params["layers"])
        self._finish_init(params_to_device(params, self.device, args.dtype))
        return self

    @classmethod
    def from_sharded_checkpoint(cls, model_path: str, args: ModelArgs, mesh,
                                precision: Optional[str] = None) -> "Llama":
        """This rank's part of a tensor-parallel engine, read from a
        reference-schema .npz slice by slice
        (`parallel.sharding.load_param_tree_sharded`: host memory peaks at
        one layer's shard, not the checkpoint).  The 70B-class load path;
        no RoPE permutation, as the JAX package's."""
        from ..parallel.sharding import load_param_tree_sharded
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, not {precision!r}")
        self = cls.__new__(cls)
        self.args = args.validate()
        self._set_mesh(mesh, rope_split=False)
        self._finish_init(load_param_tree_sharded(model_path, args, mesh))
        return self

    def _set_mesh(self, mesh, rope_split: bool):
        from ..parallel.sharding import local_config, validate_tp
        validate_tp(self.args, mesh)
        self.mesh, self.device = mesh, resolve_device(mesh.device)
        self.cfg = local_config(StaticConfig.from_args(self.args, self.device)._replace(
            rope_split=rope_split, fused=False), mesh)

    def _init_mesh(self, tree: Dict, mesh, rope_split: bool, dtype):
        """This rank's shards of a split tree (float, or quantized with its
        scales), float leaves cast to `dtype` (None: kept)."""
        from ..parallel.sharding import shard_params
        self._set_mesh(mesh, rope_split)
        if "wqkv" in tree["layers"]:
            raise ValueError("a sharded engine runs the split layout; give it an "
                             "unfused tree (fuse_matmuls=False)")
        params = shard_params(tree, mesh, self.args)
        self._finish_init(params_to_device(params, self.device, dtype))

    def _finish_init(self, params: Dict):
        args = self.args
        if self.device.type == "cuda" and args.dtype == "float32":
            # fp32 parity: the JAX path accumulates in full f32, and TF32
            # keeps only ~3 decimal digits, so both switches go off.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = params
        self.cos, self.sin = ops.rope_tables(
            args.head_dim, args.max_seq_len, args.rope_theta, torch.float32,
            scaling=args.rope_scaling, device=self.device)
        self.cache = self.init_cache()
        self._gen = None  # built lazily by the generate paths
        self._last_pos = None     # the last generation's state, for
        self._last_tokens = None  # save_generation_state

    def split_view(self) -> "Llama":
        """An engine of the split layout (`fuse_matmuls=False`) over this
        fused float engine's weights, sharing them
        (`checkpoint.unfuse_param_tree`: views, no copy): multi-LoRA
        serving over an engine already loaded fused.  Its prefill and
        serving run the same kernels; its batch-1 decode the plain forward,
        as any split engine's."""
        import copy
        twin = copy.copy(self)
        twin.args = self.args.replace(fuse_matmuls=False)
        twin.cfg = self.cfg._replace(fused=False)
        twin.params = unfuse_param_tree(self.params, self.args)
        twin._gen = None
        return twin

    # -- cache --------------------------------------------------------------

    def init_cache(self, batch_size: Optional[int] = None) -> Dict:
        """The dense cache for `batch_size` rows (default max_batch_size):
        under a mesh this rank's dp rows and KV heads."""
        B = batch_size or self.args.max_batch_size
        if self.mesh is not None:
            dp = self.mesh.size("dp")
            if B % dp:
                raise ValueError(f"batch {B} must divide over dp={dp} (the dense "
                                 f"cache shards its rows)")
            B //= dp
        return init_cache(self.args, B, device=self.device,
                          kv_heads=self.cfg.kv_heads)

    def reset(self):
        self.cache = self.init_cache()

    # -- reference-compatible forward --------------------------------------

    def __call__(self, input_ids, start_pos: int) -> np.ndarray:
        """Reference API: logits [B, 1, VS] for the last position, updating
        the engine's persistent KV cache."""
        ids = np.asarray(input_ids)
        if self.mesh is not None:
            ids = self.mesh.dp_rows(ids)
        ids = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        first = start_pos == 0 and ids.shape[1] > 1
        logits, self.cache = forward(self.params, ids, int(start_pos),
                                     self.cache, self.cos, self.sin, self.cfg,
                                     first)
        self._check_cache()
        if self.mesh is not None:
            logits = self.mesh.dp_gather_rows(logits)
        return logits.cpu().numpy()

    def _check_cache(self):
        for name, c in self.cache.items():
            check_finite(c, f"KV cache {name!r}", kind="checks")

    # -- generation ---------------------------------------------------------

    def generate(self, input_ids, max_new_tokens: int, sampling=None):
        """Generator yielding [B, 1] int arrays, one per token: greedy, or
        drawn under a `generate.Sampling` policy.

        Count-compatible with the reference: `max_new_tokens` bounds the
        *total* length, so this yields `max_new_tokens - L` tokens (quirk
        Q2), computed as one prefill and one decode loop whose tokens stay
        on the device until a single transfer."""
        ids = np.asarray(input_ids)
        L = ids.shape[1]
        steps = min(max(max_new_tokens - L, 0), self.args.max_seq_len - L)
        toks = self.generate_tokens(ids, steps, sampling=sampling)
        for t in toks.cpu().numpy().T:  # [steps, B] -> per-step [B]
            yield t[:, None]

    def generate_tokens(self, input_ids, num_tokens: int,
                        sampling=None) -> torch.Tensor:
        """Decode exactly `num_tokens` new tokens; returns them as [B,
        num_tokens] int64 on the engine's device.  Greedy by default; a
        `generate.Sampling` policy draws them with temperature / top-k /
        top-p, the JAX package's tokens for the same seed."""
        from ..generate import Generator
        if self._gen is None:
            self._gen = Generator(self)
        ids = np.asarray(input_ids)
        local = ids if self.mesh is None else self.mesh.dp_rows(ids)
        toks, self.cache = self._gen.generate(
            self.params, local, self.init_cache(ids.shape[0]), num_tokens,
            sampling=sampling)
        self._check_cache()
        if self.mesh is not None:
            toks = self.mesh.dp_gather_rows(toks)
        if num_tokens > 0:
            self._last_pos = ids.shape[1] + num_tokens - 1
            self._last_tokens = toks[:, -1].cpu().numpy()
        return toks

    # -- generation-state checkpointing -------------------------------------

    def save_generation_state(self, path: str):
        """Write (KV cache, last position, last tokens) of the last
        `generate_tokens` call as the JAX package's .npz (`cache_k`,
        `cache_v`, `pos`, `last_tokens`).  A bf16 cache is written as its
        2-byte payload, the bytes the JAX package writes for its
        ml_dtypes array.  A sharded engine gathers the whole cache (its KV
        heads over "tp", its rows over "dp") and rank 0 writes the file;
        every rank returns once it is written."""
        if self._last_tokens is None:
            raise ValueError("no generation to save; call generate_tokens first")
        k, v, m = self.cache["k"], self.cache["v"], self.mesh
        if m is not None:
            k, v = (m.gather_dim(m.gather_dim(c, 2, "tp"), 1, "dp") for c in (k, v))
        if m is None or m.rank == 0:
            np.savez(path, cache_k=_cache_to_numpy(k), cache_v=_cache_to_numpy(v),
                     pos=np.int32(self._last_pos),
                     last_tokens=np.asarray(self._last_tokens, np.int32))
        if m is not None:
            m.barrier()

    def resume_generate(self, path: str, num_tokens: int) -> torch.Tensor:
        """Continue greedy decoding from a saved generation state (either
        package's file); returns the new tokens [B, num_tokens] on the
        engine's device.  The saved `pos` is the position of the last
        generated token: resuming forwards that token at `pos` (writing its
        K/V) and continues the stream exactly.  On the card a batch-1
        resume runs the decode kernel over the restored cache.  A sharded
        engine takes its shards of the cache and its dp rows."""
        from ..generate import Generator
        state = np.load(path)
        pos = int(state["pos"])
        if pos + 1 + num_tokens > self.args.max_seq_len:
            raise ValueError("resume would exceed max_seq_len")
        cache = {"k": _cache_from_numpy(state["cache_k"], self.device),
                 "v": _cache_from_numpy(state["cache_v"], self.device)}
        last = np.asarray(state["last_tokens"], np.int64)
        if self.mesh is not None:
            from ..parallel.sharding import shard_cache
            cache, last = shard_cache(cache, self.mesh), self.mesh.dp_rows(last)
        self.cache = cache
        if self._gen is None:
            self._gen = Generator(self)
        tok = torch.as_tensor(last, device=self.device)
        toks, self.cache = self._gen.decode_fn(num_tokens, tok.shape[0])(
            self.params, tok, pos, self.cache, self.cos, self.sin)
        self._check_cache()
        if self.mesh is not None:
            toks = self.mesh.dp_gather_rows(toks)
        self._last_pos = pos + num_tokens
        self._last_tokens = toks[:, -1].cpu().numpy()
        return toks
