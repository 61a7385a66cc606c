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
engine holds in `Llama.params`, or the split layout of
`fuse_matmuls=False`; `params_from_jax` carries either over.
`quantize_param_tree` makes their int8 and int4 forms (payloads beside f32
`*_scale` leaves; int4 packed two a byte, `pack_int4`), as the JAX
package's does, and `save_quantized_npz` / `load_quantized_npz` write and
read quantized trees in the JAX package's file format.

The converters (`convert_llama2c_bin`, `convert_hf_model` with
`args_from_hf_config`) turn a llama2.c `.bin` export or a HuggingFace
directory into the reference schema, as the JAX package's do, in numpy and
the standard library: `.safetensors` files are read by the port's own
reader (`read_safetensors`), `.bin` shards by `torch.load`.
"""

from __future__ import annotations

import json
import os
import struct
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from .config import ModelArgs
from .ops.core import rope_split_permutation, unpack_int4

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


def load_param_tree(model_path: str, args: ModelArgs, dtype=None) -> Dict:
    """Load a reference-schema .npz straight into the stacked tree: float32
    numpy leaves, or with `dtype` (numpy has no bfloat16) CPU tensors of
    that dtype."""
    tree = build_param_tree(load_parameters(model_path), args)
    return tree if dtype is None else params_to_device(tree, "cpu", dtype)


def infer_args_from_weights(weights, base: Optional[ModelArgs] = None,
                            n_heads: Optional[int] = None) -> ModelArgs:
    """Derive structural hyperparameters (dim, n_layers, hidden_dim, vocab,
    kv heads) from weight shapes; non-structural fields come from `base`.

    `n_heads` is not recoverable from weight shapes (under MHA every head
    count divides the same [dim, dim] projections), so it must come from
    either the explicit `n_heads` argument or a `base` whose `dim` matches
    the checkpoint; anything else raises rather than guessing."""
    keys = list(_keys(weights))
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in keys if k.startswith("model.layers."))
    vs, dim = weights["model.embed_tokens.weight"].shape
    hidden = weights["model.layers.0.mlp.gate_proj.weight"].shape[0]
    kv_out = weights["model.layers.0.self_attn.k_proj.weight"].shape[0]
    base = base or ModelArgs()
    if n_heads is None:
        if base.dim != dim:
            raise ValueError(
                f"cannot infer n_heads: checkpoint dim={dim} does not match "
                f"base config dim={base.dim} (head counts are not recoverable "
                f"from weight shapes — pass n_heads= explicitly or a matching "
                f"base ModelArgs/preset)"
            )
        n_heads = base.n_heads
    if dim % n_heads:
        raise ValueError(f"n_heads={n_heads} does not divide dim={dim}")
    head_dim = dim // n_heads
    if kv_out % head_dim:
        raise ValueError(
            f"k_proj out dim {kv_out} is not a multiple of head_dim "
            f"{head_dim} (dim={dim}, n_heads={n_heads})"
        )
    return base.replace(
        dim=dim, n_layers=n_layers, vocab_size=vs, hidden_dim=hidden,
        n_heads=n_heads, n_kv_heads=(kv_out // head_dim) if kv_out != dim else None,
    )


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


def unfuse_param_tree(params: Dict, args: ModelArgs) -> Dict:
    """The split tree of a fused float tree, as views of its tensors:
    wq|wk|wv and w_gate|w_up are column slices of wqkv and wgu (which
    `fuse_param_tree` concatenates), the norms [NL, D].  No weight is
    copied, so an engine of the split layout can share a loaded fused
    engine's weights (multi-LoRA serving needs the split layout)."""
    ly = params["layers"]
    if "wqkv" not in ly or "wqkv_scale" in ly:
        raise ValueError("unfuse_param_tree takes a fused float tree")
    qd, kvd = args.n_heads * args.head_dim, args.kv_heads * args.head_dim
    fd = args.hidden_dim
    wqkv, wgu = ly["wqkv"], ly["wgu"]
    split = {"wq": wqkv[..., :qd], "wk": wqkv[..., qd : qd + kvd],
             "wv": wqkv[..., qd + kvd :], "wo": ly["wo"],
             "w_gate": wgu[..., :fd], "w_up": wgu[..., fd:], "w_down": ly["w_down"],
             "attn_norm": ly["attn_norm"][:, 0], "ffn_norm": ly["ffn_norm"][:, 0]}
    return {**params, "layers": split}


def pack_int4(w) -> torch.Tensor:
    """int4 codes [..., n] (an int8 tensor or array) -> torch.uint8 [...,
    ceil(n / 2)], two a byte along the last axis: value 2j in the low
    nibble, 2j + 1 in the high one, each the low nibble of its byte (a
    code in [-8, 7] in two's complement, or a JAX int4 file's byte).  An
    odd n pads one zero nibble."""
    t = torch.from_numpy(np.ascontiguousarray(w)) if isinstance(w, np.ndarray) else w
    if t.shape[-1] % 2:
        t = torch.cat([t, t.new_zeros(*t.shape[:-1], 1)], dim=-1)
    u = t.to(torch.uint8)  # two's complement bytes; the low nibble is the code
    return (u[..., 0::2] & 15) | ((u[..., 1::2] & 15) << 4)


def int4_width(params: Dict, name: str) -> int:
    """The unpacked length of packed leaf `name` ("lm_head",
    "tok_embedding", or a layer weight "layers.wq"): a matmul weight's
    output columns are its scale's, the embedding's row is the model
    width."""
    if name == "tok_embedding":
        return params["norm"].shape[-1]
    if name.startswith("layers."):
        return params["layers"][name[len("layers."):] + "_scale"].shape[-1]
    return params[name + "_scale"].shape[-1]


def quantize_param_tree(params: Dict, bits: int = 8, head_bits: int = None,
                        device=None, dtype=None) -> Dict:
    """Weight-only quantization of the fused whole-layer tree or of the
    split tree, the counterpart of `llama3np_tpu.checkpoint.
    quantize_param_tree`, giving the same codes and scales.

    Matmul weights (wqkv/wo/wgu/w_down or wq/wk/wv/wo/w_gate/w_up/w_down,
    and lm_head) get per-output-column symmetric scales reduced over the
    contraction (second-to-last) axis: s = max|w_col| / qmax (floored at
    1e-12), w_q = clip(rint(w / s), -qmax, qmax), qmax 127 for bits=8 and 7
    for bits=4.  The scale commutes with the matmul, x @ (w_q * s) ==
    (x @ w_q) * s, so consumers post-scale the product and never dequantize
    a weight ahead of time.  The embedding gets one scale per row, applied
    after the gather.  Norms stay as they are.  int4 codes are stored two
    a byte (`pack_int4`, along each weight's last axis), so their bytes are
    half int8's; the JAX package's host tree holds one byte a value.

    head_bits (default: bits) quantizes lm_head and tok_embedding at their
    own width: bits=4, head_bits=8 is the mixed tree, int4 layers under an
    int8 head.  The host path runs numpy on a thread pool and returns numpy
    leaves; `device` (a torch device) quantizes there instead and returns
    tensors on it, the JAX package's `device=True`.

    `dtype` (a `ModelArgs` dtype string or torch dtype; bf16 or float16)
    first rounds each weight to that dtype (a cast there and back, one
    weight at a time, on the host or on `device`): the JAX engine casts its
    tree to `args.dtype` before it quantizes, so a 16-bit engine's codes
    and scales are those of the rounded weights."""
    head_bits = bits if head_bits is None else head_bits
    rt = None if dtype is None else torch_dtype(dtype)
    if rt == torch.float32:
        rt = None
    for b in (bits, head_bits):
        if b not in (8, 4):
            raise ValueError(f"bits must be 8 or 4, not {b}")

    def make_q(nbits):
        qmax = 127 if nbits == 8 else 7

        def finish(w8):
            return pack_int4(w8) if nbits == 4 else w8

        if device is not None:
            def q(w, axis):
                w = torch.as_tensor(w).to(device=device, dtype=torch.float32, copy=True)
                if rt is not None:
                    w.copy_(w.to(rt))  # rounded in place: one f32 copy
                # A tensor divisor: CUDA divides by a Python scalar as a
                # multiply by its reciprocal, an ulp off numpy's quotient.
                qm = torch.tensor(float(qmax), device=w.device)
                s = torch.clamp(w.abs().amax(dim=axis, keepdim=True) / qm, min=1e-12)
                # in place on the copy: one weight-sized temporary at a time
                w8 = w.div_(s).round_().clamp_(-qmax, qmax).to(torch.int8)
                return finish(w8), s
        else:
            def q(w, axis):
                w = np.asarray(w, np.float32)
                if rt is not None:
                    w = torch.from_numpy(np.ascontiguousarray(w)).to(rt).float().numpy()
                s = np.max(np.abs(w), axis=axis, keepdims=True) / qmax
                s = np.maximum(s, 1e-12).astype(np.float32)
                w8 = np.clip(np.rint(w / s), -qmax, qmax).astype(np.int8)
                return (pack_int4(w8).numpy() if nbits == 4 else w8), s
        return q

    q, q_head = make_q(bits), make_q(head_bits)
    ly = dict(params["layers"])
    kinds = (("wqkv", "wo", "wgu", "w_down") if "wqkv" in ly
             else ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    tasks = [(kind, partial(q, ly[kind], -2)) for kind in kinds]
    tasks += [("lm_head", partial(q_head, params["lm_head"], -2)),
              ("tok_embedding", partial(q_head, params["tok_embedding"], -1))]
    done = ({name: thunk() for name, thunk in tasks} if device is not None
            else _parallel_items(tasks))
    for kind in kinds:
        ly[kind], ly[kind + "_scale"] = done[kind]
    head_q, head_s = done["lm_head"]
    emb_q, emb_s = done["tok_embedding"]
    return {**params, "layers": ly,
            "tok_embedding": emb_q, "tok_embedding_scale": emb_s,
            "lm_head": head_q, "lm_head_scale": head_s}


# ---------------------------------------------------------------------------
# Quantized checkpoints, in the JAX package's file format
# ---------------------------------------------------------------------------

def _flat_items(params: Dict):
    """(dotted key, leaf) of a parameter tree: "layers.wq", "lm_head"..."""
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                yield f"{k}.{kk}", vv
        else:
            yield k, v


def save_quantized_npz(params: Dict, path: str, rope_split: bool = True):
    """Write a quantized split tree (`build_param_tree` [+
    `permute_rope_layout`] + `quantize_param_tree`, numpy leaves or tensors
    on any device) as one .npz in the JAX package's format
    (`llama3np_tpu.checkpoint.save_quantized_npz`), which either package
    boots with `Llama.from_quantized`: dotted tree keys, a
    `__rope_split__` marker, bfloat16 leaves as their uint16 bits listed
    under `__bf16__`, and int4 leaves as one byte a value listed under
    `__int4__`, the value's two's-complement low nibble in the low four
    bits and zeros above (the bytes of an `ml_dtypes.int4` array)."""
    flat = {"__rope_split__": np.asarray(int(rope_split))}
    bf16_keys, int4_keys = [], []
    for key, v in _flat_items(params):
        if v.dtype in (torch.uint8, np.uint8):  # packed int4, the only uint8 leaves
            codes = unpack_int4(torch.as_tensor(v).cpu(), int4_width(params, key))
            v = (codes & 15).numpy()
            int4_keys.append(key)
        elif isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            v = v.cpu().view(torch.int16).numpy().view(np.uint16)
            bf16_keys.append(key)
        elif isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        flat[key] = np.asarray(v)
    flat["__bf16__"] = np.asarray(bf16_keys)
    flat["__int4__"] = np.asarray(int4_keys)
    np.savez(path, **flat)


def load_quantized_npz(path: str):
    """Load a quantized checkpoint of either package (`save_quantized_npz`);
    returns (parameter tree of CPU tensors, rope_split).  An int4 byte
    holds its value's low nibble (read back sign-extended, `unpack_int4`),
    and the nibbles are packed two a byte; bfloat16 bits become
    torch.bfloat16 through a view."""
    npz = np.load(path)
    bf16 = set(npz["__bf16__"].tolist()) if "__bf16__" in npz.files else set()
    int4 = set(npz["__int4__"].tolist()) if "__int4__" in npz.files else set()

    def get(k):
        v = npz[k]
        if k in int4:  # the low nibble is the code; packing keeps just that
            return pack_int4(v.view(np.int8))
        if k in bf16 or (v.dtype.kind == "V" and v.dtype.itemsize == 2):
            # (a legacy file without the list stored bfloat16 as raw 2-byte
            # void: the only 2-byte non-native dtype either package writes)
            return torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(v))

    out: Dict = {"layers": {}}
    rope_split = True
    for k in npz.files:
        if k == "__rope_split__":
            rope_split = bool(int(npz[k]))
        elif k in ("__bf16__", "__int4__"):
            continue
        elif k.startswith("layers."):
            out["layers"][k[len("layers."):]] = get(k)
        else:
            out[k] = get(k)
    return out, rope_split


def _to_tensor(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype).contiguous()
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
    """Copy a parameter tree (numpy leaves, or tensors) onto `device` as
    torch tensors, cast to `dtype` (a `ModelArgs` dtype string or torch
    dtype; None keeps each leaf's own).  int8 payloads stay torch.int8,
    packed int4 torch.uint8, and `*_scale` leaves float32 whatever `dtype`
    is."""
    dt = None if dtype is None else torch_dtype(dtype)

    def put(name, v):
        if v.dtype in (np.int8, np.uint8, torch.int8, torch.uint8):
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
    [NL,D,QD+2KVD], "wo", "wgu" [NL,D,2FD], "w_down", norms [NL,1,D]) or
    the split layout of `fuse_matmuls=False` ("wq"/"wk"/"wv"/"wo",
    "w_gate"/"w_up"/"w_down", norms [NL,D]).  Returns the port's tensor
    tree on `device`, which both packages then compute the same function
    with.  An int8 or int4 tree carries over with its `*_scale` leaves; an
    int4 leaf (one `ml_dtypes.int4` value a byte) is cast to int8 by value
    and packed two a byte.  The TPU-only FFN-blocked and KV-head-grouped
    layouts are refused: their per-(block, column) scales belong to a TPU
    VMEM plan."""
    ly = tree["layers"]
    if "wqkv" in ly and (np.ndim(ly["wqkv"]) != 3 or np.ndim(ly["wgu"]) != 3):
        raise ValueError("only the whole-layer fused layout carries over; the "
                         "FFN-blocked / KV-head-grouped layouts are TPU VMEM "
                         "plans (pass pallas_ffn_block=0 to the JAX engine)")
    if "wqkv" not in ly and "wq" not in ly:
        raise ValueError("params_from_jax takes the fused or the split tree")

    def conv(v):
        arr = np.asarray(v)
        return pack_int4(arr.astype(np.int8)) if arr.dtype.name == "int4" else arr

    host = {k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict) else conv(v))
            for k, v in tree.items()}
    return params_to_device(host, device)


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


# ---------------------------------------------------------------------------
# Converters (reference schema in, reference schema out)
# ---------------------------------------------------------------------------

def _host(v) -> np.ndarray:
    """A leaf as a host numpy array (a bf16 tensor widened to float32,
    exactly: numpy has no bfloat16)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def param_tree_to_weights(params: Dict, args: ModelArgs) -> Dict[str, np.ndarray]:
    """Inverse of `build_param_tree`: unstack a split tree (numpy leaves or
    tensors) back into the reference HF-schema flat mapping, so that it
    round-trips through `save_npz` and boots any engine, the NumPy oracle
    included.

    Requires the unpermuted interleaved-RoPE layout (`permute_rope_layout`
    is a load-time transform)."""
    ly = {k: _host(v) for k, v in params["layers"].items()}
    if "wqkv" in ly or "wq_scale" in ly:
        raise ValueError("fused or quantized trees cannot round-trip to the "
                         "reference schema; export the fp32 split tree")
    out = {
        "model.embed_tokens.weight": _host(params["tok_embedding"]),
        "model.norm.weight": _host(params["norm"]),
        "lm_head.weight": np.ascontiguousarray(_host(params["lm_head"]).T),
    }
    fmt = {
        "wq": "model.layers.{i}.self_attn.q_proj.weight",
        "wk": "model.layers.{i}.self_attn.k_proj.weight",
        "wv": "model.layers.{i}.self_attn.v_proj.weight",
        "wo": "model.layers.{i}.self_attn.o_proj.weight",
        "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
        "w_up": "model.layers.{i}.mlp.up_proj.weight",
        "w_down": "model.layers.{i}.mlp.down_proj.weight",
    }
    for name, f in fmt.items():
        for i in range(args.n_layers):
            out[f.format(i=i)] = np.ascontiguousarray(ly[name][i].T)
    for name, f in (("attn_norm", "model.layers.{i}.input_layernorm.weight"),
                    ("ffn_norm",
                     "model.layers.{i}.post_attention_layernorm.weight")):
        for i in range(args.n_layers):
            out[f.format(i=i)] = ly[name][i]
    return out


def convert_llama2c_bin(bin_path: str, out_path: Optional[str] = None):
    """Convert a llama2.c ``.bin`` export (Karpathy format, v0 legacy
    layout) to the reference .npz schema.  Returns (weights dict,
    ModelArgs).

    Layout: 7 int32 header [dim, hidden_dim, n_layers, n_heads, n_kv_heads,
    vocab_size, seq_len]; a negative vocab_size flags an untied lm_head;
    then float32 tensors in llama2.c order."""
    with open(bin_path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=7)
        dim, hidden, n_layers, n_heads, n_kv_heads, vocab, seq_len = map(int, header)
        shared_classifier = vocab > 0
        vocab = abs(vocab)
        head_dim = dim // n_heads

        def rd(*shape):
            n = int(np.prod(shape))
            return np.fromfile(f, dtype=np.float32, count=n).reshape(shape)

        emb = rd(vocab, dim)
        rms_att = rd(n_layers, dim)
        wq = rd(n_layers, n_heads * head_dim, dim)
        wk = rd(n_layers, n_kv_heads * head_dim, dim)
        wv = rd(n_layers, n_kv_heads * head_dim, dim)
        wo = rd(n_layers, dim, n_heads * head_dim)
        rms_ffn = rd(n_layers, dim)
        w1 = rd(n_layers, hidden, dim)   # gate
        w2 = rd(n_layers, dim, hidden)   # down
        w3 = rd(n_layers, hidden, dim)   # up
        rms_final = rd(dim)
        # the legacy RoPE frequency tables, unused
        np.fromfile(f, dtype=np.float32, count=seq_len * head_dim // 2)
        np.fromfile(f, dtype=np.float32, count=seq_len * head_dim // 2)
        wcls = emb if shared_classifier else rd(vocab, dim)

    weights = {"model.embed_tokens.weight": emb,
               "model.norm.weight": rms_final,
               "lm_head.weight": wcls}
    for i in range(n_layers):
        p = f"model.layers.{i}"
        weights[f"{p}.self_attn.q_proj.weight"] = wq[i]
        weights[f"{p}.self_attn.k_proj.weight"] = wk[i]
        weights[f"{p}.self_attn.v_proj.weight"] = wv[i]
        weights[f"{p}.self_attn.o_proj.weight"] = wo[i]
        weights[f"{p}.mlp.gate_proj.weight"] = w1[i]
        weights[f"{p}.mlp.down_proj.weight"] = w2[i]
        weights[f"{p}.mlp.up_proj.weight"] = w3[i]
        weights[f"{p}.input_layernorm.weight"] = rms_att[i]
        weights[f"{p}.post_attention_layernorm.weight"] = rms_ffn[i]

    args = ModelArgs(
        dim=dim, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=None if n_kv_heads == n_heads else n_kv_heads,
        vocab_size=vocab, max_seq_len=seq_len, hidden_dim=hidden,
        tie_word_embeddings=shared_classifier,
    )
    if out_path:
        save_npz(weights, out_path)
    return weights, args


_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The tensors of one ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header (dtype, shape, [begin, end) data offsets
    of each tensor, and an optional "__metadata__"), then the raw
    little-endian data.  F32 and F16 tensors come back as they are; a BF16
    tensor's 2-byte payload is read as bf16 bits through a torch view and
    widened to float32, exactly (numpy has no bfloat16; the JAX function
    keeps an ml_dtypes bfloat16 array of the same values)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; "
                             f"the reader takes {sorted(_ST_DTYPES)}")
        begin, end = info["data_offsets"]
        # a copy: aligned, and owning its bytes
        a = data[begin:end].copy().view(np.dtype(dt).newbyteorder("<"))
        a = a.astype(a.dtype.newbyteorder("="), copy=False).reshape(info["shape"])
        if info["dtype"] == "BF16":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).float().numpy()
        out[name] = a
    return out


def convert_hf_model(model_dir: str, out_path: Optional[str] = None,
                     permute_rope: bool = True):
    """Convert a HuggingFace Llama-family checkpoint directory (safetensors
    or torch .bin shards, in sorted order) to the reference .npz schema.

    HF checkpoints store q_proj/k_proj rows pre-permuted for rotate-half
    (split-halves) RoPE; the reference schema, and the loaders, expect
    Meta's interleaved pairing.  With `permute_rope` (default) the inverse
    permutation is applied per head, so attention is numerically correct
    after conversion; pass False only for checkpoints already in
    interleaved layout.  Head counts come from the directory's
    config.json."""
    weights: Dict[str, np.ndarray] = {}
    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if st_files:
        for fname in st_files:
            weights.update(read_safetensors(os.path.join(model_dir, fname)))
    else:
        bins = sorted(f for f in os.listdir(model_dir) if f.endswith(".bin"))
        if not bins:
            raise FileNotFoundError(f"no safetensors/bin files in {model_dir}")
        for fname in bins:
            sd = torch.load(os.path.join(model_dir, fname), map_location="cpu",
                            weights_only=True)
            weights.update({k: v.float().numpy() for k, v in sd.items()})

    if permute_rope:
        cfg_path = os.path.join(model_dir, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(
                "config.json required to undo the HF rotate-half layout "
                "(pass permute_rope=False for interleaved checkpoints)"
            )
        with open(cfg_path) as f:
            cfg = json.load(f)
        n_heads = cfg["num_attention_heads"]
        kv_heads = cfg.get("num_key_value_heads", n_heads)
        head_dim = cfg.get("head_dim", cfg["hidden_size"] // n_heads)

        def inverse(perm):
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            return inv

        q_inv = inverse(rope_split_permutation(n_heads, head_dim))
        k_inv = inverse(rope_split_permutation(kv_heads, head_dim))
        for key in list(weights):
            if key.endswith("self_attn.q_proj.weight"):
                weights[key] = np.asarray(weights[key])[q_inv]
            elif key.endswith("self_attn.k_proj.weight"):
                weights[key] = np.asarray(weights[key])[k_inv]

    if out_path:
        save_npz(weights, out_path)
    return weights


def args_from_hf_config(model_dir: str, **overrides) -> ModelArgs:
    """`ModelArgs` from a HuggingFace checkpoint directory's config.json:
    head counts, FFN width, rope_theta, and the llama3.1 `rope_scaling`
    remap (rope_type "llama3") when present; other remaps are refused.
    Pairs with `convert_hf_model`.  `max_position_embeddings` becomes
    max_seq_len unless overridden (the KV cache scales with it)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    rs = cfg.get("rope_scaling") or None
    if rs is not None:
        kind = rs.get("rope_type", rs.get("type"))
        if kind != "llama3":
            raise ValueError(f"unsupported rope_scaling type {kind!r} "
                             "(only the llama3.1 'llama3' remap)")
        rs = dict(factor=rs["factor"],
                  low_freq_factor=rs.get("low_freq_factor", 1.0),
                  high_freq_factor=rs.get("high_freq_factor", 4.0),
                  original_max_position_embeddings=rs.get(
                      "original_max_position_embeddings", 8192))
    kw = dict(
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads"),
        vocab_size=cfg["vocab_size"],
        max_seq_len=cfg.get("max_position_embeddings", 2048),
        rope_theta=cfg.get("rope_theta", 10000.0),
        norm_eps=cfg.get("rms_norm_eps", 1e-5),
        hidden_dim=cfg.get("intermediate_size"),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        rope_scaling=rs,
        dtype="bfloat16" if cfg.get("torch_dtype") == "bfloat16"
        else "float32",
    )
    kw.update(overrides)
    return ModelArgs(**kw).validate()
