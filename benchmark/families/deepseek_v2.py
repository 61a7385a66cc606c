"""The DeepSeek-V2 block (DeepSeek-V2-Lite): multi-head latent attention
without a query low-rank, YaRN RoPE, a dense SwiGLU in the first
`first_k_dense_replace` layers and routed plus shared SwiGLU experts in the
rest, an untied head, no biases.  Everything the harness, the drivers and
the output check know of the model comes from here (`harness/spec.py`
lists what a family file provides).

Weights: each leaf drawn by `harness.weights.draw` from (seed, leaf name,
layer), stacked experts as one leaf a layer.  The rope columns of wq and
wkv_a are declared to be in the split-halves layout (a rope head's first
half pairs with its second, HuggingFace's `rotate_half`, after the
permutation HF applies to its interleaved columns), the layout the program
and the reference both take; a permutation of random columns is random
columns.

Work counts, from shapes and positions.  Model FLOPs of one token at
context `ctx` (the positions it attends, itself included): 2 x every
weight the token multiplies in a product (the attention projections, the
dense FFN or the router with top-k routed and the shared experts, and the
head) + 2 x ctx x heads x (qk + v head dims) in each layer's attention
(QK^T and PV of the published, decompressed form).  A prompt of L tokens
counts token i at ctx i + 1, and the head once.  No kernel of the program
runs here whose roofline a metric reads: no paged_attention or
decode_layers counts.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, NamedTuple

from benchmark.harness.spec import load_module
from benchmark.harness.weights import draw

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ATTN_LEAVES = ("attn_norm", "wq", "wkv_a", "kv_norm", "wkv_b", "wo", "ffn_norm")
DENSE_LEAVES = ("w_gate", "w_up", "w_down")
MOE_LEAVES = ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")
NORMS = ("attn_norm", "kv_norm", "ffn_norm", "norm")


class Dims(NamedTuple):
    nl: int
    d: int
    nh: int
    nope: int
    rope: int
    v: int
    kv_rank: int
    fd: int          # the dense layers' SwiGLU width
    fe: int          # one expert's SwiGLU width
    experts: int
    shared: int
    top_k: int
    dense: int       # leading dense layers
    vs: int
    max_seq: int
    rope_theta: float
    yarn: tuple      # the rope_scaling dict's items, sorted
    routed_scale: float
    eps: float
    dtype: str

    @property
    def qk(self) -> int:
        return self.nope + self.rope

    @property
    def latent(self) -> int:
        return self.kv_rank + self.rope


def dims(config: Dict) -> Dims:
    """The sizes of a configuration file (HuggingFace DeepseekV2 config
    keys).  Raises for what this block does not compute."""
    c = config
    for key, want in (("q_lora_rank", None), ("scoring_func", "softmax"),
                      ("topk_method", "greedy"), ("norm_topk_prob", False),
                      ("hidden_act", "silu"), ("attention_bias", False),
                      ("tie_word_embeddings", False), ("moe_layer_freq", 1)):
        if c.get(key, want) != want:
            raise ValueError(f"{key}={c[key]!r}: the block takes {want!r}")
    if c.get("n_group", 1) > 1:
        raise ValueError(f"n_group={c['n_group']}: group-limited routing is not computed")
    rs = c.get("rope_scaling")
    if rs is not None and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs!r}: the block takes YaRN or none")
    return Dims(nl=c["num_hidden_layers"], d=c["hidden_size"], nh=c["num_attention_heads"],
                nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"], v=c["v_head_dim"],
                kv_rank=c["kv_lora_rank"], fd=c["intermediate_size"],
                fe=c["moe_intermediate_size"], experts=c["n_routed_experts"],
                shared=c["n_shared_experts"], top_k=c["num_experts_per_tok"],
                dense=c["first_k_dense_replace"], vs=c["vocab_size"],
                max_seq=c["max_position_embeddings"], rope_theta=float(c["rope_theta"]),
                yarn=tuple(sorted((rs or {}).items())),
                routed_scale=float(c.get("routed_scaling_factor", 1.0)),
                eps=float(c["rms_norm_eps"]), dtype=c["torch_dtype"])


# -- weights -----------------------------------------------------------------

def shapes(dm: Dims) -> Dict[str, tuple]:
    """Each leaf's shape: products [in, out], stacked experts [E, out, in]."""
    fs = dm.shared * dm.fe
    return {"attn_norm": (dm.d,), "wq": (dm.d, dm.nh * dm.qk), "wkv_a": (dm.d, dm.latent),
            "kv_norm": (dm.kv_rank,), "wkv_b": (dm.kv_rank, dm.nh * (dm.nope + dm.v)),
            "wo": (dm.nh * dm.v, dm.d), "ffn_norm": (dm.d,),
            "w_gate": (dm.d, dm.fd), "w_up": (dm.d, dm.fd), "w_down": (dm.fd, dm.d),
            "router": (dm.d, dm.experts), "e_gate": (dm.experts, dm.fe, dm.d),
            "e_up": (dm.experts, dm.fe, dm.d), "e_down": (dm.experts, dm.d, dm.fe),
            "s_gate": (dm.d, fs), "s_up": (dm.d, fs), "s_down": (fs, dm.d),
            "tok_embedding": (dm.vs, dm.d), "norm": (dm.d,), "lm_head": (dm.d, dm.vs)}


def leaf(torch, dm: Dims, seed: int, name: str, layer: int, device, dtype):
    """One leaf of one layer (layer -1: the model's own leaves)."""
    return draw(torch, seed, name, layer, shapes(dm)[name], name in NORMS, device, dtype)


def layer_leaves(dm: Dims, i: int) -> tuple:
    return ATTN_LEAVES + (DENSE_LEAVES if i < dm.dense else MOE_LEAVES)


def layer(torch, dm: Dims, seed: int, i: int, device, dtype) -> Dict:
    """Layer i's split leaves, as the reference takes them."""
    return {n: leaf(torch, dm, seed, n, i, device, dtype) for n in layer_leaves(dm, i)}


def model_leaves(torch, dm: Dims, seed: int, device, dtype) -> Dict:
    return {n: leaf(torch, dm, seed, n, -1, device, dtype)
            for n in ("tok_embedding", "norm", "lm_head")}


# Fused leaves of the program's tree: (name, parts concatenated, axis).
FUSED = (("wgu", ("w_gate", "w_up"), -1), ("e_gu", ("e_gate", "e_up"), 1),
         ("s_gu", ("s_gate", "s_up"), -1))


def program_tree(torch, dm: Dims, seed: int, device, dtype) -> Dict:
    """The program's tree (`models/deepseek_v2.layer_shapes`): the same
    leaves, gate|up fused, made on the device layer by layer."""
    layers = []
    for i in range(dm.nl):
        names = layer_leaves(dm, i)
        lp = {}
        for fused, parts, axis in FUSED:
            if parts[0] not in names:
                continue
            ws = [leaf(torch, dm, seed, n, i, device, dtype) for n in parts]
            lp[fused] = torch.cat(ws, dim=axis)
            del ws
        lp.update({n: leaf(torch, dm, seed, n, i, device, dtype) for n in names
                   if not any(n in parts for _, parts, _ in FUSED)})
        layers.append(lp)
    return {**model_leaves(torch, dm, seed, device, dtype), "layers": layers}


# -- the program and the reference -------------------------------------------

def program_args(dm: Dims):
    """The program's DeepseekV2Args for the configuration, every width as
    the file gives it."""
    from llama3np_tpu_torch.models.deepseek_v2 import DeepseekV2Args

    return DeepseekV2Args(
        dim=dm.d, n_layers=dm.nl, n_heads=dm.nh, qk_nope_head_dim=dm.nope,
        qk_rope_head_dim=dm.rope, v_head_dim=dm.v, kv_lora_rank=dm.kv_rank,
        intermediate_size=dm.fd, moe_intermediate_size=dm.fe, n_routed_experts=dm.experts,
        n_shared_experts=dm.shared, num_experts_per_tok=dm.top_k,
        first_k_dense_replace=dm.dense, vocab_size=dm.vs, max_seq_len=dm.max_seq,
        rope_theta=dm.rope_theta, rope_scaling=dict(dm.yarn) or None,
        routed_scaling_factor=dm.routed_scale, norm_eps=dm.eps, dtype=dm.dtype)


def engine(h):
    """The program's engine over the seeded tree, made on the device; in
    a traced run with its block timer on, kept on the harness for the
    readers (`harness/blocks.py`)."""
    from llama3np_tpu_torch.models.deepseek_v2 import BlockTimer, DeepseekV2

    args = program_args(h.dm)
    tree = program_tree(h.torch, h.dm, h.seed, h.device, h.dtype)
    eng = DeepseekV2.from_param_tree(tree, args, device=h.device)
    if h.traced:
        eng.timer = h.block_timer = BlockTimer(h.device)
    return eng


def reference(torch, dm: Dims, seed: int, device):
    """`benchmark/reference/deepseek_v2.py` over the weights made again
    from the seed, one layer at a time."""
    ref = load_module(os.path.join(BENCH_DIR, "reference", "deepseek_v2.py"),
                      "bench_reference_deepseek_v2")
    dt = getattr(torch, dm.dtype)
    return ref.Reference({"n_layers": dm.nl, "n_heads": dm.nh, "nope": dm.nope,
                          "rope": dm.rope, "v": dm.v, "kv_rank": dm.kv_rank, "eps": dm.eps,
                          "rope_theta": dm.rope_theta, "rope_scaling": dict(dm.yarn),
                          "top_k": dm.top_k, "routed_scale": dm.routed_scale},
                         lambda i: layer(torch, dm, seed, i, device, dt),
                         model_leaves(torch, dm, seed, device, dt), device)


# -- work counts ---------------------------------------------------------------

def attention_params(dm: Dims) -> int:
    return (dm.d * dm.nh * dm.qk + dm.d * dm.latent + dm.kv_rank * dm.nh * (dm.nope + dm.v)
            + dm.nh * dm.v * dm.d)


def ffn_params(dm: Dims, i: int) -> int:
    """Weights a token multiplies in layer i's FFN: the dense SwiGLU, or the
    router and its top-k routed and the shared experts."""
    if i < dm.dense:
        return 3 * dm.d * dm.fd
    return dm.d * dm.experts + (dm.top_k + dm.shared) * 3 * dm.d * dm.fe


def layers_params(dm: Dims) -> int:
    return sum(attention_params(dm) + ffn_params(dm, i) for i in range(dm.nl))


def product_params(dm: Dims) -> int:
    """Weights a token multiplies: every layer's and the head."""
    return layers_params(dm) + dm.d * dm.vs


def decode_flops(dm: Dims, ctxs: Iterable[int]) -> float:
    """One decode token for each context in `ctxs`."""
    ctxs = list(ctxs)
    return (2.0 * product_params(dm) * len(ctxs)
            + 2.0 * dm.nl * dm.nh * (dm.qk + dm.v) * sum(ctxs))


def prefill_flops(dm: Dims, L: int) -> float:
    """Tokens at ctx 1..L; only the last goes through the head."""
    return (2.0 * (layers_params(dm) * L + dm.d * dm.vs)
            + 2.0 * dm.nl * dm.nh * (dm.qk + dm.v) * L * (L + 1) / 2)
