"""Seeded weights, made on the device, that the program and the reference
both get.

Every leaf of every layer comes from a generator of its own, seeded from
(run seed, leaf name, layer), so the reference can make any one layer
again, alone, after the program's state is freed, and get the very values
the program was handed: normal x 0.02 (the published configs'
`initializer_range`), norms 1 + 0.02 x normal, drawn in float32 on the
device in one call a leaf and a layer, then cast to the served dtype.

wq and wk columns are declared to be in the split-halves RoPE layout (a
head's first HD/2 columns pair with its last HD/2, HuggingFace's
`rotate_half`), which is the layout `Llama.from_param_tree` expects with
`rope_split_layout`; a permutation of random columns is random columns.
"""

from __future__ import annotations

import hashlib
from typing import Dict, NamedTuple

SCALE = 0.02
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
    d, nh = c["hidden_size"], c["num_attention_heads"]
    hd = c.get("head_dim", d // nh)
    if hd * nh != d:
        raise ValueError(f"head_dim {hd} x {nh} heads != hidden_size {d}")
    return Dims(nl=c["num_hidden_layers"], d=d, nh=nh,
                kvh=c.get("num_key_value_heads", nh), hd=hd,
                fd=c["intermediate_size"], vs=c["vocab_size"],
                max_seq=c["max_position_embeddings"], rope_theta=float(c["rope_theta"]),
                eps=float(c["rms_norm_eps"]), dtype=c["torch_dtype"])


def shapes(dm: Dims) -> Dict[str, tuple]:
    """Each layer's leaf shapes ([in, out] for the products) and the
    model's own."""
    return {"wq": (dm.d, dm.qd), "wk": (dm.d, dm.kvd), "wv": (dm.d, dm.kvd),
            "wo": (dm.qd, dm.d), "w_gate": (dm.d, dm.fd), "w_up": (dm.d, dm.fd),
            "w_down": (dm.fd, dm.d), "attn_norm": (dm.d,), "ffn_norm": (dm.d,),
            "tok_embedding": (dm.vs, dm.d), "norm": (dm.d,), "lm_head": (dm.d, dm.vs)}


def leaf_seed(seed: int, name: str, layer: int) -> int:
    digest = hashlib.sha256(f"{seed}/{name}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1  # under 2**63


def leaf(torch, dm: Dims, seed: int, name: str, layer: int, device, dtype):
    """One leaf of one layer (layer -1: the model's own leaves)."""
    g = torch.Generator(device).manual_seed(leaf_seed(seed, name, layer))
    x = torch.randn(shapes(dm)[name], generator=g, device=device, dtype=torch.float32)
    x = 1.0 + SCALE * x if name in NORMS else x.mul_(SCALE)
    return x.to(dtype)


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
