"""DeepSeek-V2 block (DeepSeek-V2-Lite's): multi-head latent attention
(MLA) without a query low-rank, YaRN rotary embeddings, and a mixture of
routed and shared SwiGLU experts after leading dense layers.

Notation of HF `modeling_deepseek.py` (DeepseekV2), for a token x [D] and
H heads:

* attention input: q = x wq [H, nope + rope], split into q_nope and q_pe;
  c = x wkv_a [R + rope]: c_kv = RMSNorm_kv(c[:R]) and k_pe = c[R:], one
  rope-wide key head shared by all H.
* prefill, decompressed: [k_nope | v] = c_kv wkv_b [H, nope + v];
  k = [k_nope | rope(k_pe)], q = [q_nope | rope(q_pe)]; causal
  softmax(q k^T scale) v [H, v], then wo.
* decode, absorbed: the pool keeps [c_kv | rope(k_pe)] (R + rope wide) once
  a token and layer (`kvcache.init_latent_paged_cache`); head h's query is
  [q_nope_h W_UK_h^T | rope(q_pe_h)], scored against those rows, and its
  output is (sum_t p_t c_kv_t) W_UV_h, where W_UK_h and W_UV_h are head h's
  k_nope and v columns of wkv_b.  The same scores as prefill's, in another
  association of the same products.
* scale: (nope + rope)^-0.5 x yarn_mscale(factor, mscale_all_dim)^2.
* FFN: layers below `first_k_dense_replace` a SwiGLU of
  `intermediate_size`; the rest a mixture: the router's logits x W_gate
  [E] and their softmax in float32, the top k scores (not renormalized)
  times `routed_scaling_factor` weight their experts' SwiGLUs, plus the
  shared experts (one SwiGLU of n_shared x the expert width).  Pre-norm
  residuals, a final norm, an untied head.

Rotary layout: the rope columns of wq and wkv_a are taken in split-halves
form (pair j with j + rope/2, `ops.apply_rope_split`); HF permutes its
interleaved columns to that form before rotating, and a permutation of
random columns is random columns.

Experts: tokens are sorted by expert on the device and each projection is
one grouped product for all experts (`ops.grouped_dot`), so a step never
waits for per-expert counts.  Dense products go through `ops._dot` (on
the card bf16 x bf16 tensor-core GEMMs with f32 sums), attention's batched
products through `ops._bdot`; attention itself is plain torch.

Tracing: every layer's attention and expert blocks run inside
`torch.profiler.record_function` ranges `deepseek_v2.mla` and
`deepseek_v2.moe`.  `engine.timer = BlockTimer(device)` also times each
block call with a pair of CUDA events (host clocks on the CPU), stamped
with the host clock and marked "prefill" or "decode"; without a timer the
forward records no event.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..checkpoint import torch_dtype
from ..kvcache import init_latent_paged_cache
from ..ops import core as ops
from .llama import resolve_device

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
QUERY_BLOCK = 1024  # prefill's query rows a score block: H x 1024 x L scores held


@dataclasses.dataclass
class DeepseekV2Args:
    """The sizes of a DeepSeek-V2 model (HF config names in comments)."""
    dim: int                      # hidden_size
    n_layers: int                 # num_hidden_layers
    n_heads: int                  # num_attention_heads
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    kv_lora_rank: int
    intermediate_size: int        # the dense layers' SwiGLU
    moe_intermediate_size: int    # one expert's SwiGLU
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    vocab_size: int
    max_seq_len: int              # max_position_embeddings: tables and pool
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = None  # {"type": "yarn", ...} or None
    routed_scaling_factor: float = 1.0
    norm_eps: float = 1e-6        # rms_norm_eps
    dtype: str = "bfloat16"
    prefill_buckets: tuple = DEFAULT_BUCKETS

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """One pool row: the compressed KV and the shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        scale = self.qk_head_dim ** -0.5
        rs = self.rope_scaling or {}
        if rs.get("mscale_all_dim"):
            m = ops.yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
            scale *= m * m
        return scale


def layer_shapes(a: DeepseekV2Args, i: int) -> Dict[str, tuple]:
    """Layer i's leaves as the engine holds them: products [in, out],
    stacked experts [E, out, in] (`ops.grouped_dot`), gate|up fused."""
    H, R, D = a.n_heads, a.kv_lora_rank, a.dim
    s = {"attn_norm": (D,), "wq": (D, H * a.qk_head_dim), "wkv_a": (D, a.latent_dim),
         "kv_norm": (R,), "wkv_b": (R, H * (a.qk_nope_head_dim + a.v_head_dim)),
         "wo": (H * a.v_head_dim, D), "ffn_norm": (D,)}
    if i < a.first_k_dense_replace:
        s.update(wgu=(D, 2 * a.intermediate_size), w_down=(a.intermediate_size, D))
        return s
    E, Fe = a.n_routed_experts, a.moe_intermediate_size
    Fs = a.n_shared_experts * Fe
    s.update(router=(D, E), e_gu=(E, 2 * Fe, D), e_down=(E, D, Fe),
             s_gu=(D, 2 * Fs), s_down=(Fs, D))
    return s


class BlockTimer:
    """Device time of each block call: an event pair around it (CUDA
    events on the card, host clocks elsewhere), with the host time it was
    issued at, its block's name and its phase ("prefill" or "decode");
    `steps` holds the host time each decode step began.  Read once the
    device has finished them (`ms`)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.records: List[tuple] = []  # (host_s, name, phase, start, end)
        self.steps: List[float] = []

    def event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def ms(self, start, end) -> float:
        end.synchronize()
        return start.elapsed_time(end)


class _HostEvent:
    """A CUDA event's interface on the host clock (the CPU, where the
    forward's work is done by the time its call returns)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class _Block:
    """A profiler range around one block call, and the timer's event pair
    when the engine has a timer."""

    __slots__ = ("name", "phase", "timer", "rf", "ev")

    def __init__(self, name: str, phase: str, timer: Optional[BlockTimer]):
        self.name, self.phase, self.timer = name, phase, timer

    def __enter__(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()
        if self.timer is not None:
            self.ev = (self.timer.event(), self.timer.event())
            self.ev[0].record()
            self.timer.records.append((time.perf_counter(), self.name, self.phase) + self.ev)

    def __exit__(self, *exc):
        if self.timer is not None:
            self.ev[1].record()
        self.rf.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [N, ..., rope] (split halves) at the N rows' own cos/sin
    [N, rope / 2]."""
    shape = x.shape
    return ops.apply_rope_split(x.reshape(1, shape[0], -1, shape[-1]), cos, sin).reshape(shape)


def _latent(x: torch.Tensor, lp: Dict, a: DeepseekV2Args, cos, sin):
    """q [N, H, nope + rope] with its rope part rotated, and the latent
    rows [N, R + rope] ([c_kv | rope(k_pe)]) of x [N, D]."""
    N, R = x.shape[0], a.kv_lora_rank
    q = ops._dot(x, lp["wq"]).to(x.dtype).view(N, a.n_heads, a.qk_head_dim)
    q_pe = _rope(q[..., a.qk_nope_head_dim:], cos, sin)
    q = torch.cat([q[..., :a.qk_nope_head_dim], q_pe], dim=-1)
    c = ops._dot(x, lp["wkv_a"]).to(x.dtype)
    c_kv = ops.rms_norm(c[:, :R], lp["kv_norm"], a.norm_eps)
    return q, torch.cat([c_kv, _rope(c[:, R:], cos, sin)], dim=-1)


def _mla_prefill(x: torch.Tensor, lp: Dict, a: DeepseekV2Args, cos, sin):
    """Causal MLA over one sequence x [L, D] from position 0, decompressed,
    queries in blocks of QUERY_BLOCK rows.  Returns (the block's output
    [L, D] in f32, the latent rows [L, R + rope])."""
    L, H, nope, vd = x.shape[0], a.n_heads, a.qk_nope_head_dim, a.v_head_dim
    q, rows = _latent(x, lp, a, cos, sin)
    kv = ops._dot(rows[:, :a.kv_lora_rank], lp["wkv_b"]).to(x.dtype).view(L, H, nope + vd)
    k_pe = rows[:, None, a.kv_lora_rank:].expand(L, H, a.qk_rope_head_dim)
    kt = torch.cat([kv[..., :nope], k_pe], dim=-1).permute(1, 2, 0)  # [H, qk, L]
    v = kv[..., nope:].transpose(0, 1)  # [H, L, v]
    qh = q.transpose(0, 1)  # [H, L, qk]
    out = torch.empty(L, H, vd, dtype=x.dtype, device=x.device)
    for lo in range(0, L, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, L)
        s = ops._bdot(qh[:, lo:hi], kt[:, :, :hi]) * a.softmax_scale
        future = (torch.arange(hi, device=x.device)[None, :]
                  > torch.arange(lo, hi, device=x.device)[:, None])
        p = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1).to(x.dtype)
        out[lo:hi] = ops._bdot(p, v[:, :hi]).transpose(0, 1).to(x.dtype)
    return ops._dot(out.reshape(L, H * vd), lp["wo"]), rows


def _mla_decode(x: torch.Tensor, lp: Dict, a: DeepseekV2Args, cos, sin,
                pool: torch.Tensor, w_uk: torch.Tensor, w_uv: torch.Tensor,
                page_ids: torch.Tensor, offsets: torch.Tensor,
                block_table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode token a row, absorbed, against one layer's latent pool
    [P, page, R + rope]: row b's latent row is written at (page_ids[b],
    offsets[b]) first, then row b attends its block table's positions <=
    pos[b].  x [B, D]; w_uk [H, nope, R], w_uv [H, R, v].  Returns the
    block's output [B, D] in f32."""
    B, H, R = x.shape[0], a.n_heads, a.kv_lora_rank
    q, row = _latent(x, lp, a, cos, sin)
    pool[page_ids, offsets] = row
    q_lat = ops._bdot(q[..., :a.qk_nope_head_dim].transpose(0, 1), w_uk).to(x.dtype)
    q_full = torch.cat([q_lat.transpose(0, 1), q[..., a.qk_nope_head_dim:]], dim=-1)
    n, page = block_table.shape[1], pool.shape[1]
    rows = pool[block_table.long()].view(B, n * page, a.latent_dim)  # [B, T, R + rope]
    s = ops._bdot(q_full, rows.transpose(1, 2)) * a.softmax_scale  # [B, H, T]
    future = torch.arange(n * page, device=x.device)[None, :] > pos[:, None]
    p = torch.softmax(s.masked_fill(future[:, None, :], float("-inf")), dim=-1).to(x.dtype)
    o_lat = ops._bdot(p, rows[..., :R]).to(x.dtype)  # [B, H, R]
    o = ops._bdot(o_lat.transpose(0, 1), w_uv).to(x.dtype)  # [H, B, v]
    return ops._dot(o.transpose(0, 1).reshape(B, H * a.v_head_dim), lp["wo"])


def _moe(x: torch.Tensor, lp: Dict, a: DeepseekV2Args) -> torch.Tensor:
    """The routed and shared experts of x [N, D] -> [N, D] in x's dtype.
    Every (token, expert) pair is sorted by expert on the device, and the
    gate|up and down products are one grouped product each over all
    experts; the routed sum is taken in f32, rounded, then the shared
    experts' output added, as HF's DeepseekV2MoE."""
    N, k, E = x.shape[0], a.num_experts_per_tok, a.n_routed_experts
    scores = torch.softmax(torch.matmul(x.float(), lp["router"].float()), dim=-1)
    weight, expert = torch.topk(scores, k, dim=-1)  # [N, k]
    sorted_expert, order = torch.sort(expert.reshape(-1), stable=True)
    token = order // k
    # Each expert's row end: a search, since bincount on the card reads its
    # input's max back to the host.
    offs = torch.searchsorted(sorted_expert, torch.arange(E, device=x.device),
                              right=True).to(torch.int32)
    gu = ops.grouped_dot(x[token], lp["e_gu"], offs)
    fe = a.moe_intermediate_size
    act = (F.silu(gu[:, :fe].float()) * gu[:, fe:].float()).to(x.dtype)
    y = ops.grouped_dot(act, lp["e_down"], offs).float()
    y = y * (weight.reshape(-1)[order] * a.routed_scaling_factor)[:, None]
    routed = torch.zeros(N, x.shape[1], dtype=torch.float32, device=x.device)
    routed.index_add_(0, token, y)
    return routed.to(x.dtype) + ops.fused_ffn(x, lp["s_gu"], lp["s_down"])


def _ffn(x: torch.Tensor, lp: Dict, a: DeepseekV2Args) -> torch.Tensor:
    if "router" in lp:
        return _moe(x, lp, a)
    return ops.fused_ffn(x, lp["wgu"], lp["w_down"])


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class DeepseekV2:
    """A DeepSeek-V2 model on one device, for `serving.BatchEngine(...,
    paged=True)` and batch greedy `generate_tokens`.  It brings its own
    pool and forward to the serving engine: `init_paged_pool`,
    `prefill_paged` (one prompt, decompressed, its latent rows into its
    pages) and `decode_paged` (one ragged step, absorbed).  Weights in
    `args.dtype`; on the card bf16 (the grouped expert product's dtype
    there).  No tensor parallelism: experts and the latent pool are whole
    on one device."""

    @classmethod
    def from_param_tree(cls, params: Dict, args: DeepseekV2Args, device="cuda",
                        mesh=None) -> "DeepseekV2":
        """An engine over `params` {"tok_embedding" [VS, D], "norm" [D],
        "lm_head" [D, VS], "layers": [layer i's leaves, `layer_shapes`]},
        numpy arrays or tensors on any device, cast to args.dtype on
        `device`."""
        if mesh is not None:
            raise ValueError("DeepSeek-V2 has no tensor-parallel path (experts and "
                             "the latent pool are not sharded); build it without a mesh")
        self = cls.__new__(cls)
        self.args = args
        self.device = resolve_device(device)
        dt = torch_dtype(args.dtype)
        if self.device.type == "cuda" and dt != torch.bfloat16:
            raise ValueError("on the card DeepSeek-V2 runs in bfloat16 (the grouped "
                             f"expert product's dtype), not {args.dtype}")

        def put(t):
            return torch.as_tensor(t).to(device=self.device, dtype=dt)

        if len(params["layers"]) != args.n_layers:
            raise ValueError(f"{len(params['layers'])} layers in the tree, "
                             f"args.n_layers is {args.n_layers}")
        for i, lp in enumerate(params["layers"]):
            got = {k: tuple(v.shape) for k, v in lp.items()}
            if got != layer_shapes(args, i):
                raise ValueError(f"layer {i}'s leaves {got} are not {layer_shapes(args, i)}")
        self.params = {k: put(params[k]) for k in ("tok_embedding", "norm", "lm_head")}
        self.params["layers"] = [{k: put(v) for k, v in lp.items()} for lp in params["layers"]]
        # Head h's k_nope and v columns of wkv_b, for the absorbed decode.
        H, R, nope = args.n_heads, args.kv_lora_rank, args.qk_nope_head_dim
        self.absorbed = []
        for lp in self.params["layers"]:
            w = lp["wkv_b"].view(R, H, nope + args.v_head_dim)
            self.absorbed.append((w[..., :nope].permute(1, 2, 0).contiguous(),
                                  w[..., nope:].permute(1, 0, 2).contiguous()))
        self.cfg = args  # what BatchEngine reads as the model's static config
        self.cos, self.sin = ops.rope_tables(
            args.qk_rope_head_dim, args.max_seq_len, args.rope_theta, torch.float32,
            scaling=args.rope_scaling, device=self.device)
        self.timer: Optional[BlockTimer] = None
        return self

    def _block(self, name: str, phase: str) -> _Block:
        return _Block(name, phase, self.timer)

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        return ops._dot(ops.rms_norm(h, self.params["norm"], self.args.norm_eps),
                        self.params["lm_head"])

    # -- the serving engine's calls -----------------------------------------

    def init_paged_pool(self, num_pages: int, page_size: int) -> Dict[str, torch.Tensor]:
        return init_latent_paged_cache(self.args.n_layers, num_pages, page_size,
                                       self.args.latent_dim, self.args.dtype,
                                       device=self.device)

    @torch.no_grad()
    def prefill_paged(self, ids: torch.Tensor, page_idx: torch.Tensor,
                      pool: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Prefill one prompt ids [1, L] from position 0 and write its latent
        rows into the pool's pages page_idx[0..ceil(L / page)) (in place).
        Returns the last position's logits [1, VS] in f32."""
        a, L = self.args, ids.shape[1]
        latent = pool["latent"]
        page = latent.shape[2]
        n = -(-L // page)
        cos, sin = self.cos[:L], self.sin[:L]
        h = F.embedding(ids[0], self.params["tok_embedding"])
        for i, lp in enumerate(self.params["layers"]):
            with self._block("deepseek_v2.mla", "prefill"):
                attn, rows = _mla_prefill(ops.rms_norm(h, lp["attn_norm"], a.norm_eps),
                                          lp, a, cos, sin)
                h = h + attn.to(h.dtype)
                padded = F.pad(rows, (0, 0, 0, n * page - L))
                latent[i, page_idx[:n].long()] = padded.view(n, page, a.latent_dim)
            with self._block("deepseek_v2.moe", "prefill"):
                h = h + _ffn(ops.rms_norm(h, lp["ffn_norm"], a.norm_eps), lp, a)
        return self._head(h[-1:])

    @torch.no_grad()
    def decode_paged(self, tokens: torch.Tensor, pos: torch.Tensor,
                     pool: Dict[str, torch.Tensor],
                     block_table: torch.Tensor) -> torch.Tensor:
        """One decode step, row b's token tokens[b] at position pos[b]
        (both [B] on the device) through block_table [B, n] (the pages in
        use; unused entries the null page 0).  Each layer writes the rows'
        latent rows into the pool, then attends.  Returns logits [B, VS]
        in f32."""
        a = self.args
        if self.timer is not None:
            self.timer.steps.append(time.perf_counter())
        latent = pool["latent"]
        page = latent.shape[2]
        p = pos.long().clamp(max=a.max_seq_len - 1)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        page_ids = block_table.long()[rows, torch.div(p, page, rounding_mode="floor")]
        offsets = p % page
        cos, sin = self.cos[p], self.sin[p]
        h = F.embedding(tokens.long(), self.params["tok_embedding"])
        for i, lp in enumerate(self.params["layers"]):
            with self._block("deepseek_v2.mla", "decode"):
                attn = _mla_decode(ops.rms_norm(h, lp["attn_norm"], a.norm_eps), lp, a,
                                   cos, sin, latent[i], *self.absorbed[i], page_ids,
                                   offsets, block_table, p)
                h = h + attn.to(h.dtype)
            with self._block("deepseek_v2.moe", "decode"):
                h = h + _ffn(ops.rms_norm(h, lp["ffn_norm"], a.norm_eps), lp, a)
        return self._head(h)

    # -- generation ----------------------------------------------------------

    @torch.no_grad()
    def generate_tokens(self, input_ids, num_tokens: int) -> torch.Tensor:
        """Greedy: `num_tokens` new tokens for each row of input_ids [B, L]
        (host ints), as [B, num_tokens] int64 on the device: each prompt
        prefilled into pages of its own, then batched decode steps through
        the same forward as serving, the tokens fed back on the device."""
        ids = np.asarray(input_ids, np.int64)
        B, L = ids.shape
        if L + num_tokens > self.args.max_seq_len:
            raise ValueError(f"prompt {L} + {num_tokens} new tokens exceed "
                             f"max_seq_len {self.args.max_seq_len}")
        page = 16
        n = -(-(L + num_tokens) // page)
        pool = self.init_paged_pool(1 + B * n, page)
        table = torch.arange(1, 1 + B * n, device=self.device, dtype=torch.int32).view(B, n)
        dev_ids = torch.as_tensor(ids, device=self.device)
        first = [self.prefill_paged(dev_ids[b : b + 1], table[b], pool) for b in range(B)]
        tok = torch.argmax(torch.cat(first), dim=-1)
        out = [tok]
        pos = torch.full((B,), L, dtype=torch.long, device=self.device)
        for _ in range(num_tokens - 1):
            tok = torch.argmax(self.decode_paged(tok, pos, pool, table), dim=-1)
            out.append(tok)
            pos = pos + 1
        if not num_tokens:
            return torch.zeros(B, 0, dtype=torch.long, device=self.device)
        return torch.stack(out, dim=1)
