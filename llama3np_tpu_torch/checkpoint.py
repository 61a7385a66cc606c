"""Checkpoint I/O and the stacked parameter tree, numpy in and numpy out,
plus the step onto a device.

The on-disk schema follows the reference loader's HF-Transformers key naming:

    model.embed_tokens.weight                         [VS, D]
    model.layers.{i}.self_attn.{q,k,v,o}_proj.weight  [out, in]
    model.layers.{i}.mlp.{up,gate,down}_proj.weight   [out, in]
    model.layers.{i}.input_layernorm.weight           [D]
    model.layers.{i}.post_attention_layernorm.weight  [D]
    model.norm.weight                                 [D]
    lm_head.weight                                    [VS, D]

In memory the model uses the same *stacked* tree as the JAX package: every
per-layer weight is stacked along a leading ``n_layers`` axis and projection
matrices are stored pre-transposed to ``[in, out]``, so the forward is plain
``x @ w`` and the decode kernel's GEMVs read neighbouring output columns
from neighbouring addresses.  The port runs the fused whole-layer layout
(`fuse_param_tree`) in the split-halves RoPE column order
(`permute_rope_layout`), which is the layout `llama3np_tpu`'s single-chip
engine holds in `Llama.params`; `params_from_jax` carries such a tree over.
`quantize_param_tree` makes its int8 form (int8 payloads beside f32
`*_scale` leaves), as the JAX package's does.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict

import numpy as np
import torch

from .config import ModelArgs
from .ops.core import rope_split_permutation

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name) -> torch.dtype:
    """torch dtype for a `ModelArgs` dtype string (or a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    if str(name) not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[str(name)]


def load_parameters(model_path: str):
    """Reference-compatible raw loader: the flat HF-schema mapping."""
    return np.load(model_path)


def _parallel_items(fns):
    """Run the (name, thunk) list on a thread pool (the stack/transpose/cast
    transforms are large numpy ops that release the GIL)."""
    fns = list(fns)
    workers = min(os.cpu_count() or 1, len(fns), 16)
    if workers <= 1:
        return {name: thunk() for name, thunk in fns}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        futs = {name: pool.submit(thunk) for name, thunk in fns}
        return {name: f.result() for name, f in futs.items()}


def _keys(weights):
    return weights.files if hasattr(weights, "files") else weights.keys()


def build_param_tree(weights, args: ModelArgs) -> Dict:
    """Assemble the stacked float32 parameter tree from a flat HF-schema
    mapping (an NpzFile, a dict, ...).  The cast to the working dtype happens
    on the way to the device (`params_to_device`): numpy has no bfloat16."""

    def get(key):
        return np.asarray(weights[key], dtype=np.float32)

    def stack(fmt, transpose=False):
        # Layer by layer into one preallocated array: the staging holds the
        # stack and one layer, not every layer twice (an 8B model stages
        # 32 GB of float32 here).
        out = None
        for i in range(args.n_layers):
            a = get(fmt.format(i=i))
            a = a.T if transpose else a
            if out is None:
                out = np.empty((args.n_layers, *a.shape), np.float32)
            out[i] = a
        return out

    def stack_t(fmt):
        # [out, in] -> [in, out], stacked over layers.
        return stack(fmt, transpose=True)

    layers = _parallel_items([
        ("wq", partial(stack_t, "model.layers.{i}.self_attn.q_proj.weight")),
        ("wk", partial(stack_t, "model.layers.{i}.self_attn.k_proj.weight")),
        ("wv", partial(stack_t, "model.layers.{i}.self_attn.v_proj.weight")),
        ("wo", partial(stack_t, "model.layers.{i}.self_attn.o_proj.weight")),
        ("w_gate", partial(stack_t, "model.layers.{i}.mlp.gate_proj.weight")),
        ("w_up", partial(stack_t, "model.layers.{i}.mlp.up_proj.weight")),
        ("w_down", partial(stack_t, "model.layers.{i}.mlp.down_proj.weight")),
        ("attn_norm", partial(stack, "model.layers.{i}.input_layernorm.weight")),
        ("ffn_norm",
         partial(stack, "model.layers.{i}.post_attention_layernorm.weight")),
    ])
    embed = get("model.embed_tokens.weight")
    if args.tie_word_embeddings or "lm_head.weight" not in _keys(weights):
        lm_head = embed.T.copy()
    else:
        lm_head = np.ascontiguousarray(get("lm_head.weight").T)
    return {
        "tok_embedding": embed,
        "layers": layers,
        "norm": get("model.norm.weight"),
        "lm_head": lm_head,
    }


def permute_rope_layout(params: Dict, args: ModelArgs) -> Dict:
    """Permute wq/wk output columns from interleaved RoPE pairs to the
    split-halves layout (`ops.core.rope_split_permutation`).  Exact: Q and K
    are permuted consistently, so attention scores are unchanged; only the
    (internal) K-cache layout differs."""
    q_perm = rope_split_permutation(args.n_heads, args.head_dim)
    k_perm = rope_split_permutation(args.kv_heads, args.head_dim)
    ly = dict(params["layers"])
    ly["wq"] = ly["wq"][..., q_perm]
    ly["wk"] = ly["wk"][..., k_perm]
    return {**params, "layers": ly}


def fuse_param_tree(params: Dict) -> Dict:
    """Fuse per-layer Q/K/V into one [NL, D, QD+2*KVD] weight and gate/up
    into one [NL, D, 2*FD] weight, in the whole-layer form the decode kernel
    reads.  Norms become [NL, 1, D], as in the JAX package's fused tree, so
    that `params_from_jax` is a plain conversion.  (The JAX package's
    FFN-blocked and KV-head-grouped layouts are TPU VMEM plans and have no
    counterpart here.)"""
    ly = params["layers"]
    nl, d = ly["attn_norm"].shape
    fused = {
        "wqkv": np.concatenate([ly["wq"], ly["wk"], ly["wv"]], axis=-1),
        "wgu": np.concatenate([ly["w_gate"], ly["w_up"]], axis=-1),
        "wo": ly["wo"],
        "w_down": ly["w_down"],
        "attn_norm": np.reshape(ly["attn_norm"], (nl, 1, d)),
        "ffn_norm": np.reshape(ly["ffn_norm"], (nl, 1, d)),
    }
    return {**params, "layers": fused}


def quantize_param_tree(params: Dict, bits: int = 8) -> Dict:
    """Weight-only int8 quantization of the fused whole-layer tree or of the
    split tree (the numpy counterpart of `llama3np_tpu.checkpoint.
    quantize_param_tree` for bits=8, giving the same payloads and scales).

    Matmul weights (wqkv/wo/wgu/w_down or wq/wk/wv/wo/w_gate/w_up/w_down,
    and lm_head) get per-output-column symmetric scales reduced over the
    contraction (second-to-last) axis: s = max|w_col| / 127 (floored at
    1e-12), w8 = clip(rint(w / s), -127, 127).  The scale commutes with the
    matmul, x @ (w8 * s) == (x @ w8) * s, so consumers post-scale the
    product and never dequantize a weight ahead of time.  The embedding
    gets one scale per row, applied after the gather.  Norms stay as they
    are."""
    if bits != 8:
        raise NotImplementedError("int4 and mixed-bit trees run the "
                                  "split-weight layout, still to port "
                                  "(ROADMAP A5)")

    def q(w, axis):
        w = np.asarray(w, np.float32)
        s = np.max(np.abs(w), axis=axis, keepdims=True) / 127
        s = np.maximum(s, 1e-12).astype(np.float32)
        return np.clip(np.rint(w / s), -127, 127).astype(np.int8), s

    ly = dict(params["layers"])
    kinds = (("wqkv", "wo", "wgu", "w_down") if "wqkv" in ly
             else ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    tasks = [(kind, partial(q, ly[kind], -2)) for kind in kinds]
    tasks += [("lm_head", partial(q, params["lm_head"], -2)),
              ("tok_embedding", partial(q, params["tok_embedding"], -1))]
    done = _parallel_items(tasks)
    for kind in kinds:
        ly[kind], ly[kind + "_scale"] = done[kind]
    head8, head_s = done["lm_head"]
    emb8, emb_s = done["tok_embedding"]
    return {**params, "layers": ly,
            "tok_embedding": emb8, "tok_embedding_scale": emb_s,
            "lm_head": head8, "lm_head_scale": head_s}


def _to_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 leaves (a bf16 JAX tree): widen losslessly, then
        # narrow again in torch.
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX array
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_to_device(tree: Dict, device, dtype=None) -> Dict:
    """Copy a numpy parameter tree onto `device` as torch tensors, cast to
    `dtype` (a `ModelArgs` dtype string or torch dtype; None keeps each
    leaf's own).  int8 payloads stay torch.int8 and `*_scale` leaves
    float32 whatever `dtype` is."""
    dt = None if dtype is None else torch_dtype(dtype)

    def put(name, v):
        if np.asarray(v).dtype == np.int8:
            return _to_tensor(v, device, None)
        return _to_tensor(v, device, torch.float32 if name.endswith("_scale") else dt)

    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = {kk: put(kk, vv) for kk, vv in v.items()}
        else:
            out[k] = put(k, v)
    return out


def params_from_jax(tree: Dict, device) -> Dict:
    """Carry the JAX package's parameter tree over to the port.

    `tree` is `llama3np_tpu.models.llama.Llama.params` with its leaves as
    numpy arrays: the fused, rope-split, whole-layer layout ("wqkv"
    [NL,D,QD+2KVD], "wo", "wgu" [NL,D,2FD], "w_down", norms [NL,1,D]).
    Returns the port's tensor tree on `device`, which both packages then
    compute the same function with.  An int8 tree (`quant="int8"`) carries
    over with its `*_scale` leaves.  The TPU-only FFN-blocked and
    KV-head-grouped layouts are refused: their per-(block, column) scales
    belong to a TPU VMEM plan."""
    ly = tree["layers"]
    if "wqkv" not in ly:
        raise ValueError("params_from_jax takes the fused tree "
                         "(ModelArgs.fuse_matmuls=True)")
    if np.ndim(ly["wqkv"]) != 3 or np.ndim(ly["wgu"]) != 3:
        raise ValueError("only the whole-layer fused layout carries over; the "
                         "FFN-blocked / KV-head-grouped layouts are TPU VMEM "
                         "plans (pass pallas_ffn_block=0 to the JAX engine)")
    return params_to_device(tree, device)


# ---------------------------------------------------------------------------
# Synthetic checkpoints (tests and benchmarks without downloads)
# ---------------------------------------------------------------------------

def synthetic_weights(args: ModelArgs, seed: int = 0, scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Random HF-schema weights for `args` (the same numbers as the JAX
    package's `synthetic_weights` for the same seed)."""
    rng = np.random.default_rng(seed)
    d, fd, vs = args.dim, args.hidden_dim, args.vocab_size
    kvd = args.kv_heads * args.head_dim

    def w(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    out = {
        "model.embed_tokens.weight": w(vs, d),
        "model.norm.weight": np.ones(d, np.float32) + w(d),
        "lm_head.weight": w(vs, d),
    }
    for i in range(args.n_layers):
        p = f"model.layers.{i}"
        out[f"{p}.self_attn.q_proj.weight"] = w(d, d)
        out[f"{p}.self_attn.k_proj.weight"] = w(kvd, d)
        out[f"{p}.self_attn.v_proj.weight"] = w(kvd, d)
        out[f"{p}.self_attn.o_proj.weight"] = w(d, d)
        out[f"{p}.mlp.gate_proj.weight"] = w(fd, d)
        out[f"{p}.mlp.up_proj.weight"] = w(fd, d)
        out[f"{p}.mlp.down_proj.weight"] = w(d, fd)
        out[f"{p}.input_layernorm.weight"] = np.ones(d, np.float32) + w(d)
        out[f"{p}.post_attention_layernorm.weight"] = np.ones(d, np.float32) + w(d)
    return out


def save_npz(weights: Dict[str, np.ndarray], path: str, compressed: bool = False):
    """Write an HF-schema weight dict as .npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    (np.savez_compressed if compressed else np.savez)(path, **weights)


def write_synthetic_checkpoint(path: str, args: ModelArgs, seed: int = 0) -> str:
    save_npz(synthetic_weights(args, seed), path)
    return path
