"""The Llama block (Mistral-7B-v0.3 and DeepSeek-LLM-7B are this block):
RMSNorm, attention with rotary embeddings over grouped KV heads, SwiGLU,
an untied head, no biases.  Everything the harness, the drivers and the
output check know of the model comes from here (`harness/spec.py` lists
what a family file provides).

Weights: each leaf drawn by `harness.weights.draw` from (seed, leaf name,
layer).  wq and wk columns are declared to be in the split-halves RoPE
layout (a head's first HD/2 columns pair with its last HD/2, HuggingFace's
`rotate_half`), which is the layout `Llama.from_param_tree` expects with
`rope_split_layout`; a permutation of random columns is random columns.

Work counts, from shapes and positions.  Model FLOPs of one token at
context `ctx` (the positions it attends, itself included): 2 x every
weight a token multiplies in a product (all but the embedding and the
norms) + 4 x ctx x (heads x head_dim) in each layer's attention (QK^T and
PV).  A prompt of L tokens counts token i at ctx i + 1, and the head once
(for the last); padding counts nothing.  A kernel's bytes count each input
read once and each output written once.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, NamedTuple

from benchmark.harness.roofline import ELEM
from benchmark.harness.spec import load_module
from benchmark.harness.weights import draw

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Keys that name parts the Llama block lacks (experts, latent or windowed
# attention, state-space layers): set to anything but null, false or 0,
# they are refused.
FOREIGN = ("expert", "moe", "lora_rank", "nope_head_dim", "rope_head_dim", "v_head_dim",
           "window", "ssm", "state_size", "conv_kernel")
LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "attn_norm", "ffn_norm")
NORMS = ("attn_norm", "ffn_norm", "norm")


class Dims(NamedTuple):
    nl: int
    d: int
    nh: int
    kvh: int
    hd: int
    fd: int
    vs: int
    max_seq: int
    rope_theta: float
    eps: float
    dtype: str

    @property
    def qd(self) -> int:
        return self.nh * self.hd

    @property
    def kvd(self) -> int:
        return self.kvh * self.hd


def dims(config: Dict) -> Dims:
    """The sizes of a configuration file (HuggingFace config keys).  Raises
    for what a Llama-architecture block does not compute."""
    c = config
    for key, want in (("hidden_act", "silu"), ("sliding_window", None),
                      ("rope_scaling", None), ("attention_bias", False),
                      ("mlp_bias", False), ("tie_word_embeddings", False)):
        if c.get(key, want) != want:
            raise ValueError(f"{key}={c[key]!r}: the Llama block takes {want!r}")
    for key, v in c.items():
        if v and any(f in key for f in FOREIGN):
            raise ValueError(f"{key}={v!r}: the Llama block has no such part")
    d, nh = c["hidden_size"], c["num_attention_heads"]
    hd = c.get("head_dim", d // nh)
    if hd * nh != d:
        raise ValueError(f"head_dim {hd} x {nh} heads != hidden_size {d}")
    return Dims(nl=c["num_hidden_layers"], d=d, nh=nh,
                kvh=c.get("num_key_value_heads", nh), hd=hd,
                fd=c["intermediate_size"], vs=c["vocab_size"],
                max_seq=c["max_position_embeddings"], rope_theta=float(c["rope_theta"]),
                eps=float(c["rms_norm_eps"]), dtype=c["torch_dtype"])


# -- weights -----------------------------------------------------------------

def shapes(dm: Dims) -> Dict[str, tuple]:
    """Each layer's leaf shapes ([in, out] for the products) and the
    model's own."""
    return {"wq": (dm.d, dm.qd), "wk": (dm.d, dm.kvd), "wv": (dm.d, dm.kvd),
            "wo": (dm.qd, dm.d), "w_gate": (dm.d, dm.fd), "w_up": (dm.d, dm.fd),
            "w_down": (dm.fd, dm.d), "attn_norm": (dm.d,), "ffn_norm": (dm.d,),
            "tok_embedding": (dm.vs, dm.d), "norm": (dm.d,), "lm_head": (dm.d, dm.vs)}


def leaf(torch, dm: Dims, seed: int, name: str, layer: int, device, dtype):
    """One leaf of one layer (layer -1: the model's own leaves)."""
    return draw(torch, seed, name, layer, shapes(dm)[name], name in NORMS, device, dtype)


def layer(torch, dm: Dims, seed: int, i: int, device, dtype) -> Dict:
    """Layer i's split leaves, as the reference takes them."""
    return {n: leaf(torch, dm, seed, n, i, device, dtype) for n in LAYER_LEAVES}


def model_leaves(torch, dm: Dims, seed: int, device, dtype) -> Dict:
    return {n: leaf(torch, dm, seed, n, -1, device, dtype)
            for n in ("tok_embedding", "norm", "lm_head")}


def fused_tree(torch, dm: Dims, seed: int, device, dtype) -> Dict:
    """The fused parameter tree (`wqkv` = wq|wk|wv, `wgu` = w_gate|w_up,
    norms [NL, 1, D]) that the decode kernel reads, filled layer by layer
    on the device from the same leaves `layer` makes."""
    nl, d = dm.nl, dm.d
    qd, kvd, fd = dm.qd, dm.kvd, dm.fd

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    ly = {"wqkv": empty(nl, d, qd + 2 * kvd), "wo": empty(nl, qd, d),
          "wgu": empty(nl, d, 2 * fd), "w_down": empty(nl, fd, d),
          "attn_norm": empty(nl, 1, d), "ffn_norm": empty(nl, 1, d)}
    cols = {"wq": ("wqkv", 0, qd), "wk": ("wqkv", qd, qd + kvd),
            "wv": ("wqkv", qd + kvd, qd + 2 * kvd), "w_gate": ("wgu", 0, fd),
            "w_up": ("wgu", fd, 2 * fd)}
    for i in range(nl):
        for name in LAYER_LEAVES:
            w = leaf(torch, dm, seed, name, i, device, dtype)
            if name in cols:
                dst, a, b = cols[name]
                ly[dst][i, :, a:b] = w
            elif name in ("attn_norm", "ffn_norm"):
                ly[name][i, 0] = w
            else:
                ly[name][i] = w
            del w
    return {**model_leaves(torch, dm, seed, device, dtype), "layers": ly}


# -- the program and the reference -------------------------------------------

def program_args(dm: Dims):
    """The program's ModelArgs for the configuration, every width as the
    file gives it."""
    from llama3np_tpu_torch.config import ModelArgs

    return ModelArgs(dim=dm.d, n_layers=dm.nl, n_heads=dm.nh, n_kv_heads=dm.kvh,
                     vocab_size=dm.vs, max_seq_len=dm.max_seq, hidden_dim=dm.fd,
                     rope_theta=dm.rope_theta, norm_eps=dm.eps, dtype=dm.dtype)


def engine(h):
    """The program's engine over the seeded fused tree, made on the device
    (no host staging)."""
    from llama3np_tpu_torch.models.llama import Llama

    tree = fused_tree(h.torch, h.dm, h.seed, h.device, h.dtype)
    return Llama.from_param_tree(tree, program_args(h.dm), device=h.device)


def reference(torch, dm: Dims, seed: int, device):
    """`benchmark/reference/llama.py` over the weights made again from the
    seed, one layer at a time."""
    ref = load_module(os.path.join(BENCH_DIR, "reference", "llama.py"), "bench_reference_llama")
    dt = getattr(torch, dm.dtype)
    return ref.Reference({"n_layers": dm.nl, "n_heads": dm.nh, "kv_heads": dm.kvh,
                          "head_dim": dm.hd, "eps": dm.eps, "rope_theta": dm.rope_theta},
                         lambda i: layer(torch, dm, seed, i, device, dt),
                         model_leaves(torch, dm, seed, device, dt), device)


# -- work counts ---------------------------------------------------------------

def layer_product_params(dm: Dims) -> int:
    return dm.d * (dm.qd + 2 * dm.kvd) + dm.qd * dm.d + 3 * dm.d * dm.fd


def product_params(dm: Dims) -> int:
    """Weights a token multiplies: every layer's products and the head."""
    return dm.nl * layer_product_params(dm) + dm.d * dm.vs


def token_flops(dm: Dims, ctx: int) -> float:
    return 2.0 * product_params(dm) + 4.0 * dm.nl * ctx * dm.qd


def decode_flops(dm: Dims, ctxs: Iterable[int]) -> float:
    """One decode token for each context in `ctxs`."""
    ctxs = list(ctxs)
    return 2.0 * product_params(dm) * len(ctxs) + 4.0 * dm.nl * dm.qd * sum(ctxs)


def prefill_flops(dm: Dims, L: int) -> float:
    """Tokens at ctx 1..L; only the last goes through the head."""
    layers = dm.nl * layer_product_params(dm)
    return 2.0 * (layers * L + dm.d * dm.vs) + 4.0 * dm.nl * dm.qd * L * (L + 1) / 2


def decode_layers_bytes(dm: Dims, pos: int) -> float:
    """The fused decode kernel, one token at position `pos`: every layer's
    weights and norms, the cache rows 0..pos (K and V) read, the new row
    written."""
    e = ELEM[dm.dtype]
    weights = dm.nl * (layer_product_params(dm) + 2 * dm.d) * e
    row = dm.nl * 2 * dm.kvd * e
    return weights + (pos + 1) * row + row


def paged_attention_bytes(dm: Dims, ctxs: Iterable[int]) -> float:
    """One paged-attention call per layer over a batch whose row b attends
    ctxs[b] positions (its pooled rows and the current one): K and V of
    those, q read and the output written once."""
    e = ELEM[dm.dtype]
    ctxs = list(ctxs)
    per_layer = sum(ctxs) * 2 * dm.kvd * e + len(ctxs) * 2 * dm.qd * e
    return dm.nl * per_layer


def paged_attention_flops(dm: Dims, ctxs: Iterable[int]) -> float:
    """The same calls' QK^T and PV over every head."""
    return 4.0 * dm.nl * dm.qd * sum(ctxs)
