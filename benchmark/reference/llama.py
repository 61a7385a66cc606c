"""Plain PyTorch reference of the Llama-architecture decoder the cells run
(Mistral-7B-v0.3 and DeepSeek-LLM-7B are both this block): RMSNorm,
attention with rotary embeddings over grouped KV heads, SwiGLU, an untied
head, no biases.  It imports nothing but torch and is written from the
published description, not from the program.

* float32 throughout, TF32 off: the reference the served tokens are held
  to.  Weights come in their served dtype and are widened exactly.
* "fp8": the control.  Every product of a weight (q, k, v, o, gate, up,
  down and the head) takes both operands rounded to float8 e4m3, the
  weight with a scale per output column and the activation with one per
  token (amax / 448), and sums in float32, as an fp8 GEMM on the H100's
  tensor cores would; norms, RoPE, attention and the residual stay
  float32.

RoPE: a head's dimension j pairs with j + head_dim / 2 (HuggingFace's
`rotate_half`), at frequency theta^(-2j / head_dim).

The model is run layer by layer over all the sequences at once, each
layer's weights asked for when it is reached (`layer_fn(i)`) and dropped
after, so a 7B model takes one layer's float32 weights on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value
PRECISIONS = ("float32", "fp8")


def exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rope_tables(head_dim: int, n: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    return ang.cos().float().to(device), ang.sin().float().to(device)


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, H, HD]; cos, sin [T, HD/2]."""
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


def attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """Causal attention, q [T, NH, HD], k/v [T, KVH, HD], in query blocks."""
    T, nh, hd = q.shape
    rep = nh // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [NH, T, HD]
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, T, block):
        b = min(a + block, T)
        s = torch.matmul(q[a:b].transpose(0, 1), k[:, :b].transpose(1, 2)) / hd ** 0.5
        mask = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[a:b] = torch.matmul(torch.softmax(s, dim=-1), v[:, :b]).transpose(0, 1)
    return out


class Reference:
    """The decoder over a model's sizes and a source of its weights.

    dims: n_layers, n_heads, kv_heads, head_dim, eps, rope_theta (a dict).
    layer_fn(i): layer i's leaves {wq, wk, wv, wo [in, out], w_gate, w_up,
    w_down, attn_norm, ffn_norm}; model: {tok_embedding [VS, D], norm,
    lm_head [D, VS]}."""

    def __init__(self, dims: Dict, layer_fn: Callable[[int], Dict], model: Dict, device):
        self.dm, self.layer_fn, self.device = dims, layer_fn, device
        self.model = model

    def _mm(self, x, w, precision):
        if precision == "fp8":
            return torch.matmul(to_fp8(x, -1), to_fp8(w, 0))
        return torch.matmul(x, w)

    def _layer(self, h, w, cos, sin, precision):
        dm = self.dm
        T = h.shape[0]
        x = rms_norm(h, w["attn_norm"], dm["eps"])
        q = self._mm(x, w["wq"], precision).view(T, dm["n_heads"], dm["head_dim"])
        k = self._mm(x, w["wk"], precision).view(T, dm["kv_heads"], dm["head_dim"])
        v = self._mm(x, w["wv"], precision).view(T, dm["kv_heads"], dm["head_dim"])
        o = attention(rope(q, cos[:T], sin[:T]), rope(k, cos[:T], sin[:T]), v)
        h = h + self._mm(o.reshape(T, -1), w["wo"], precision)
        x = rms_norm(h, w["ffn_norm"], dm["eps"])
        g = self._mm(x, w["w_gate"], precision)
        u = self._mm(x, w["w_up"], precision)
        return h + self._mm(F.silu(g) * u, w["w_down"], precision)

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]], spans: Sequence[Tuple[int, int]],
               precisions: Sequence[str] = ("float32",)) -> Dict[str, List[torch.Tensor]]:
        """For each sequence s and its span (lo, hi): the logits [hi - lo, VS]
        at positions lo..hi-1 (each predicting the token after it), in each
        precision."""
        exact_float32()
        dm = self.dm
        n = max(len(s) for s in seqs)
        cos, sin = rope_tables(dm["head_dim"], n, dm["rope_theta"], self.device)
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
