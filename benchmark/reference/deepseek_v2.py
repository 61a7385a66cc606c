"""Plain PyTorch reference of the DeepSeek-V2 decoder (DeepSeek-V2-Lite):
multi-head latent attention without a query low-rank, YaRN rotary
embeddings, a dense SwiGLU in the leading layers and routed plus shared
SwiGLU experts in the rest, an untied head.  It imports nothing but torch
and is written from the published description (HF `modeling_deepseek.py`,
DeepseekV2), not from the program.

* float32 throughout, TF32 off: the reference the served tokens are held
  to.  Weights come in their served dtype and are widened exactly.
* "fp8": the control.  Every product of a weight (q, kv_a, kv_b, o, the
  router, the dense, routed and shared experts' gate, up and down, the
  head) takes both operands rounded to float8 e4m3, the weight with a scale
  per output column and the activation with one per token (amax / 448),
  and sums in float32; norms, RoPE, attention, the softmax of the router
  and the residual stay float32.

Attention is the published (decompressed) form: k_nope and v from the
normed compressed KV through wkv_b, the rope key shared by all heads,
scores scaled by (nope + rope)^-0.5 x mscale^2, where mscale = 0.1 x
mscale_all_dim x ln(factor) + 1.  RoPE pairs dimension j of the rope part
with j + rope / 2 (HuggingFace's `rotate_half`, after the permutation HF
applies to its interleaved columns); its frequencies are YaRN's: the base
frequencies below the correction range, the base / factor above it, a
linear ramp between, the range bounded by the pairs that turn beta_fast
and beta_slow times over the original context; cos and sin carry
mscale(mscale) / mscale(mscale_all_dim).

Experts: the router's softmax over float32 logits, the top k scores
unnormalized (times routed_scaling_factor) weight the chosen experts; each
expert is computed on its own tokens, one expert at a time.

The model is run layer by layer over all the sequences, each layer's
weights asked for when it is reached (`layer_fn(i)`) and dropped after.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
PRECISIONS = ("float32", "fp8")


def exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, rs: Dict) -> torch.Tensor:
    """[dim / 2] float64 frequencies."""
    base = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim))
    if not rs:
        return base
    orig = float(rs["original_max_position_embeddings"])

    def pair(turns):
        return dim * math.log(orig / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(pair(float(rs.get("beta_fast", 32)))), 0)
    high = min(math.ceil(pair(float(rs.get("beta_slow", 1)))), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    return base / float(rs["factor"]) * ramp + base * (1 - ramp)


def rope_tables(dim: int, n: int, theta: float, rs: Dict, device):
    ang = torch.arange(n, dtype=torch.float64)[:, None] * yarn_inv_freq(dim, theta, rs)[None, :]
    mag = 1.0
    if rs:
        f = float(rs["factor"])
        mag = mscale(f, float(rs.get("mscale", 1.0))) / mscale(f, float(rs.get("mscale_all_dim", 0.0)))
    return (ang.cos() * mag).float().to(device), (ang.sin() * mag).float().to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, d]; cos, sin [T, d/2]."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`'s
    complement (amax over `dim` maps to 448), returned as float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def attention(q, k, v, scale: float, block: int = 1024) -> torch.Tensor:
    """Causal attention, q/k [T, H, dk], v [T, H, dv], in query blocks."""
    T = q.shape[0]
    k, v = k.transpose(0, 1), v.transpose(0, 1)
    out = torch.empty(T, q.shape[1], v.shape[-1], device=q.device)
    for a in range(0, T, block):
        b = min(a + block, T)
        s = torch.matmul(q[a:b].transpose(0, 1), k[:, :b].transpose(1, 2)) * scale
        mask = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1), v[:, :b]).transpose(0, 1)
    return out


class Reference:
    """The decoder over a model's sizes and a source of its weights.

    dims: n_layers, n_heads, nope, rope, v, kv_rank, eps, rope_theta,
    rope_scaling, top_k, routed_scale (a dict).  layer_fn(i): layer i's
    leaves {attn_norm, wq [D, H (nope + rope)], wkv_a [D, R + rope],
    kv_norm [R], wkv_b [R, H (nope + v)], wo [H v, D], ffn_norm}, with
    either a dense SwiGLU {w_gate, w_up [D, F], w_down [F, D]} or experts
    {router [D, E], e_gate, e_up [E, Fe, D], e_down [E, D, Fe], s_gate,
    s_up [D, Fs], s_down [Fs, D]}; model: {tok_embedding [VS, D], norm,
    lm_head [D, VS]}."""

    def __init__(self, dims: Dict, layer_fn: Callable[[int], Dict], model: Dict, device):
        self.dm, self.layer_fn, self.device = dims, layer_fn, device
        self.model = model
        rs = dims.get("rope_scaling") or {}
        self.scale = (dims["nope"] + dims["rope"]) ** -0.5
        if rs.get("mscale_all_dim"):
            m = mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
            self.scale *= m * m

    def _mm(self, x, w, precision):
        if precision == "fp8":
            return torch.matmul(to_fp8(x, -1), to_fp8(w, 0))
        return torch.matmul(x, w)

    def _attn(self, x, w, cos, sin, p):
        dm = self.dm
        T, H, nope, R = x.shape[0], dm["n_heads"], dm["nope"], dm["kv_rank"]
        q = self._mm(x, w["wq"], p).view(T, H, nope + dm["rope"])
        c = self._mm(x, w["wkv_a"], p)
        kv = self._mm(rms_norm(c[:, :R], w["kv_norm"], dm["eps"]), w["wkv_b"], p)
        kv = kv.view(T, H, nope + dm["v"])
        k_pe = rope(c[:, None, R:], cos[:T], sin[:T]).expand(T, H, dm["rope"])
        q = torch.cat([q[..., :nope], rope(q[..., nope:], cos[:T], sin[:T])], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe], dim=-1)
        o = attention(q, k, kv[..., nope:], self.scale)
        return self._mm(o.reshape(T, -1), w["wo"], p)

    def _swiglu(self, x, g, u, d, p):
        return self._mm(F.silu(self._mm(x, g, p)) * self._mm(x, u, p), d, p)

    def _ffn(self, x, w, p):
        if "router" not in w:
            return self._swiglu(x, w["w_gate"], w["w_up"], w["w_down"], p)
        dm = self.dm
        scores = torch.softmax(self._mm(x, w["router"], p), dim=-1)
        weight, expert = torch.topk(scores, dm["top_k"], dim=-1)
        weight = weight * dm["routed_scale"]
        y = torch.zeros_like(x)
        for e in expert.unique().tolist():
            tok, slot = (expert == e).nonzero(as_tuple=True)
            out = self._swiglu(x[tok], w["e_gate"][e].T, w["e_up"][e].T, w["e_down"][e].T, p)
            y.index_add_(0, tok, out * weight[tok, slot][:, None])
        return y + self._swiglu(x, w["s_gate"], w["s_up"], w["s_down"], p)

    def _layer(self, h, w, cos, sin, p):
        eps = self.dm["eps"]
        h = h + self._attn(rms_norm(h, w["attn_norm"], eps), w, cos, sin, p)
        return h + self._ffn(rms_norm(h, w["ffn_norm"], eps), w, p)

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]], spans: Sequence[Tuple[int, int]],
               precisions: Sequence[str] = ("float32",)) -> Dict[str, List[torch.Tensor]]:
        """For each sequence s and its span (lo, hi): the logits [hi - lo, VS]
        at positions lo..hi-1 (each predicting the token after it), in each
        precision."""
        exact_float32()
        dm = self.dm
        n = max(len(s) for s in seqs)
        cos, sin = rope_tables(dm["rope"], n, dm["rope_theta"], dm.get("rope_scaling"),
                               self.device)
        emb = self.model["tok_embedding"]
        ids = [torch.as_tensor(list(s), device=self.device) for s in seqs]
        hs = {p: [emb[t].float() for t in ids] for p in precisions}
        for i in range(dm["n_layers"]):
            w = {k: t.float() for k, t in self.layer_fn(i).items()}
            for p in precisions:
                hs[p] = [self._layer(h, w, cos, sin, p) for h in hs[p]]
            del w
        head = self.model["lm_head"].float()
        norm = self.model["norm"].float()
        return {p: [self._mm(rms_norm(h[lo:hi], norm, dm["eps"]), head, p)
                    for h, (lo, hi) in zip(hs[p], spans)] for p in precisions}
