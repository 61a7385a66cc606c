"""LoRA (low-rank adaptation): adapter trees, the adapted training forward,
its loss and train step, adapter files, the serving bank and merging.

Counterpart of `llama3np_tpu.lora`, with its names, arguments and error
messages.  The frozen base weights stay untouched and only per-layer
low-rank factors train: W + (alpha / r) * A @ B.

  * Adapters are stacked over layers ([NL, in, r] / [NL, r, out]), as the
    base tree's `params["layers"]`; the layer loop takes one slice a layer.
  * The adapted product is x@W + scale * (x@A)@B, never a materialized
    W + A@B: each dot accumulates in float32 (`ops.core._dot`), the
    rank-r product's input is rounded to x's dtype, and the sum is rounded
    once (`_adapted`), as the JAX package's `_adapted` rounds it.
  * The train step takes the frozen base and the adapters apart: autograd
    and the optimizer's moments exist for the adapters only, and a 16-bit
    base is widened again in the backward instead of being kept in float32
    (`ops.core._FrozenDot`).
  * `merge_lora` folds adapters into a split-layout tree for any inference
    path; `stack_adapters` builds the serving bank of
    `serving.BatchEngine(adapters=...)`, with bank slot 0 the zero adapter.

Adapter trees are {"layers": {t_a: [NL, in, r], t_b: [NL, r, out]},
"rank", "alpha", "targets"} of torch tensors, in the training layout
(`build_param_tree`'s columns, interleaved RoPE): the serving bank
permutes wq_b/wk_b for engines of the split-halves layout; `lora_from_jax` carries the
JAX package's tree across, and `save_lora`/`load_lora` write and read the
JAX package's `.npz` (the same keys), so either package reads the other's
file.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import prng
from .checkpoint import _to_tensor, torch_dtype
from .config import ModelArgs
from .models.llama import (ROW_SHARDED, StaticConfig, _cache_from_numpy,
                           _cache_to_numpy, _lora_delta, embed_tokens,
                           lm_logits, resolve_device, tensor_parallel)
from .ops import core as ops
from .train import cross_entropy, optimizer_step, run_layers

# target name -> (in_dim, out_dim) as functions of ModelArgs
_TARGET_DIMS = {
    "wq": lambda a: (a.dim, a.n_heads * a.head_dim),
    "wk": lambda a: (a.dim, a.kv_heads * a.head_dim),
    "wv": lambda a: (a.dim, a.kv_heads * a.head_dim),
    "wo": lambda a: (a.n_heads * a.head_dim, a.dim),
    "w_gate": lambda a: (a.dim, a.hidden_dim),
    "w_up": lambda a: (a.dim, a.hidden_dim),
    "w_down": lambda a: (a.hidden_dim, a.dim),
}

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(args: ModelArgs, rank: int = 8, alpha: float = 16.0,
              targets: Tuple[str, ...] = DEFAULT_TARGETS, seed: int = 0,
              dtype=torch.float32, device="cuda") -> Dict:
    """Fresh adapter tree on `device`: A ~ N(0, 1) / r, B = 0, so the
    adapted model starts exactly equal to the base.  A is drawn with the
    JAX package's key schedule (`prng.normal` under split keys of
    PRNGKey(seed)) in float32, then cast to `dtype`: float32 factors equal
    JAX's within a few ulps (`prng.normal`); JAX draws a 16-bit dtype from
    16-bit uniform bits, which the port does not replay."""
    bad = set(targets) - set(_TARGET_DIMS)
    if bad:
        raise ValueError(f"unknown LoRA targets {sorted(bad)}; "
                         f"available: {sorted(_TARGET_DIMS)}")
    device = resolve_device(device)
    dt = torch_dtype(dtype)
    key = prng.prng_key(seed, device)
    layers = {}
    for t in targets:
        d_in, d_out = _TARGET_DIMS[t](args)
        key, sub = prng.split(key)
        layers[f"{t}_a"] = (prng.normal(sub, (args.n_layers, d_in, rank))
                            / rank).to(dt)
        layers[f"{t}_b"] = torch.zeros((args.n_layers, rank, d_out), dtype=dt,
                                       device=device)
    return {"layers": layers, "rank": rank, "alpha": float(alpha),
            "targets": tuple(targets)}


def lora_from_jax(tree: Dict, device) -> Dict:
    """Carry a JAX adapter tree (`init_lora`, `load_lora` or a trained
    one; a bank of `stack_adapters` too) across: its leaves as tensors on
    `device` in their own dtype, its metadata as it is."""
    layers = {k: _to_tensor(v, resolve_device(device), None)
              for k, v in tree["layers"].items()}
    return {**tree, "layers": layers, "targets": tuple(tree["targets"])}


def _adapted(x: torch.Tensor, w: torch.Tensor, ll: Dict, t: str,
             scale: float, mesh=None) -> torch.Tensor:
    """x @ w plus the low-rank update when target `t` is adapted, summed in
    f32 and rounded once to x's dtype.  ll holds ONE layer's slices.

    Under a tensor-parallel `mesh` (the base and the adapters sharded by
    `shard_lora`'s layout), with Megatron's pair of collectives so that
    the gradients are the single device's: a row-sharded target (wo,
    w_down) sums its partial x@w and x@A over "tp" in the forward
    (`Mesh.tp_reduce`); a column-sharded one takes x, and x@A before this
    rank's columns of B, through `Mesh.tp_copy`, whose backward sums the
    gradient over "tp"."""
    tp = tensor_parallel(mesh)
    if tp is None or t in ROW_SHARDED:
        y = ops._dot(x, w)
        y = y if tp is None else tp.tp_reduce(y)
        d = _lora_delta(x, ll, t, scale, mesh)
    else:
        y, d = ops._dot(tp.tp_copy(x), w), None
        if f"{t}_a" in ll:
            u = tp.tp_copy(ops._dot(x, ll[f"{t}_a"]))
            d = scale * ops._dot(u.to(x.dtype), ll[f"{t}_b"])
    return (y if d is None else y + d).to(x.dtype)


def _lora_block(cfg: StaticConfig, scale: float, cos, sin, h, lp, ll):
    """One adapted transformer block of the training forward (this rank's
    heads and FFN columns under a tensor-parallel cfg.mesh)."""
    B, L = h.shape[:2]
    m = cfg.mesh
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = _adapted(x, lp["wq"], ll, "wq", scale, m)
    k = _adapted(x, lp["wk"], ll, "wk", scale, m)
    v = _adapted(x, lp["wv"], ll, "wv", scale, m)
    rope = ops.apply_rope_split if cfg.rope_split else ops.apply_rope
    q = rope(q.reshape(B, L, cfg.n_heads, cfg.head_dim), cos, sin)
    k = rope(k.reshape(B, L, cfg.kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(B, L, cfg.kv_heads, cfg.head_dim)
    attn = ops.causal_attention(q, k, v)
    h = h + _adapted(attn.reshape(B, L, -1), lp["wo"], ll, "wo", scale, m)
    z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    gate = _adapted(z, lp["w_gate"], ll, "w_gate", scale, m)
    up = _adapted(z, lp["w_up"], ll, "w_up", scale, m)
    act = F.silu(gate.float()).to(z.dtype) * up
    return h + _adapted(act, lp["w_down"], ll, "w_down", scale, m)


def forward_train_lora(params: Dict, lora_layers: Dict, batch: torch.Tensor,
                       cos, sin, cfg: StaticConfig, scale: float,
                       remat: bool = False) -> torch.Tensor:
    """`train.forward_train` with LoRA deltas on the adapted projections:
    logits [B, L, VS] in f32.  lora_layers: the stacked {t_a/t_b: [NL,
    ...]} dict (lora["layers"]); scale: alpha / rank; remat recomputes each
    layer's activations in the backward (`torch.utils.checkpoint`).  Under
    a tensor-parallel cfg.mesh, params and lora_layers are this rank's
    shards (`parallel.sharding.shard_params`, `shard_lora`) and the
    logits are gathered to the whole vocabulary."""
    L = batch.shape[1]
    h = embed_tokens(params, batch.long(), cfg.mesh)
    ly = params["layers"]

    def layer(i):
        return ({name: w[i] for name, w in ly.items()},
                {name: w[i] for name, w in lora_layers.items()})

    h = run_layers(lambda h, lp, ll: _lora_block(cfg, scale, cos[:L], sin[:L], h, lp, ll),
                   h, ly["wo"].shape[0], layer, remat)
    h = ops.rms_norm(h, params["norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg.mesh)


def lora_loss(lora_layers: Dict, params: Dict, batch: torch.Tensor, cos, sin,
              cfg: StaticConfig, scale: float, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy with adapters active (lora_layers first, as
    the JAX package's, whose value_and_grad differentiates the adapters)."""
    logits = forward_train_lora(params, lora_layers, batch[:, :-1], cos, sin,
                                cfg, scale, remat=remat)
    return cross_entropy(logits, batch[:, 1:])


def make_lora_train_step(optimizer, cfg: StaticConfig, scale: float,
                         remat: bool = False):
    """(lora_layers, opt_state, params, batch, cos, sin) -> (lora_layers,
    opt_state, loss): one AdamW step of the adapters (`optimizer` from
    `train.init_optimizer(lora["layers"])`, which owns those tensors and
    updates them in place).  The base `params` is a frozen input: no
    gradient, no optimizer state.  Under cfg.mesh (a dp x tp mesh; cfg,
    params and the adapters this rank's: `parallel.sharding.local_config`,
    `shard_params`, `shard_lora`), `batch` is this rank's dp rows
    (`data.prefetch_to_device(mesh=)`), the gradients are averaged over
    "dp" before the step, and the loss is the whole batch's."""

    def train_step(lora_layers, opt_state, params, batch, cos, sin):
        loss = optimizer_step(optimizer, lora_layers, lambda: lora_loss(
            lora_layers, params, batch, cos, sin, cfg, scale, remat), cfg.mesh)
        return lora_layers, opt_state, loss

    return train_step


def save_lora(lora: Dict, path: str) -> None:
    """Write an adapter tree as the JAX package's `.npz`: "layers.<name>"
    factors and the __rank__/__alpha__/__targets__ metadata (a bf16 factor
    as its 2-byte payload, as numpy stores the JAX package's)."""
    arrays = {f"layers.{k}": _cache_to_numpy(v) for k, v in lora["layers"].items()}
    np.savez(path, __rank__=lora["rank"], __alpha__=lora["alpha"],
             __targets__=np.asarray(lora["targets"]), **arrays)


def load_lora(path: str, device="cuda") -> Dict:
    """Read a `save_lora` file of either package into an adapter tree on
    `device`."""
    device = resolve_device(device)
    z = np.load(path)
    layers = {k[len("layers."):]: _cache_from_numpy(z[k], device)
              for k in z.files if k.startswith("layers.")}
    return {"layers": layers, "rank": int(z["__rank__"]),
            "alpha": float(z["__alpha__"]),
            "targets": tuple(str(t) for t in z["__targets__"])}


def lora_pspecs(lora: Dict):
    """Spec tree (`parallel.sharding`'s tuples) for lora["layers"],
    composing with the base tensor-parallel layout (`param_pspecs`):

      * column-sharded weights (wq/wk/wv/w_gate/w_up, output axis over
        "tp"): A replicates (its input axis matches the replicated
        activations), B shards its OUTPUT columns over "tp", so the
        low-rank delta lands sharded exactly like the base product.
      * row-sharded weights (wo/w_down, input axis over "tp"): A shards its
        INPUT rows over "tp" (matching the sharded activations entering
        the base product), so x@A is a partial sum taken over "tp" before
        B; B replicates.
    """
    specs = {}
    for t in lora["targets"]:
        if t in ROW_SHARDED:
            specs[f"{t}_a"] = (None, "tp", None)
            specs[f"{t}_b"] = (None, None, None)
        else:
            specs[f"{t}_a"] = (None, None, None)
            specs[f"{t}_b"] = (None, None, "tp")
    return specs


def local_lora_layers(layers: Dict, mesh) -> Dict:
    """Views of this rank's shards of adapter factors (an adapter tree's
    [NL, ...] or a serving bank's [NL, NA, ...]): what the forward of a
    tensor-parallel engine reads from a bank every rank holds whole."""
    out = {}
    for name, leaf in layers.items():
        t, kind = name.rsplit("_", 1)
        axis = leaf.ndim - 2 if kind == "a" else leaf.ndim - 1
        idx = [slice(None)] * leaf.ndim
        if (t in ROW_SHARDED) == (kind == "a"):
            idx[axis] = slice(*mesh.tp_range(leaf.shape[axis]))
        out[name] = leaf[tuple(idx)]
    return out


def shard_lora(lora: Dict, mesh) -> Dict:
    """This rank's shards of an adapter tree under `lora_pspecs`, each
    copied onto mesh.device (so that its own tensors train)."""
    layers = {name: leaf.to(mesh.device).clone(memory_format=torch.contiguous_format)
              for name, leaf in local_lora_layers(lora["layers"], mesh).items()}
    return {**lora, "layers": layers}


def permute_lora_rope_layout(lora: Dict, args: ModelArgs) -> Dict:
    """Permute wq_b/wk_b output columns to the split-halves RoPE layout,
    the load-time transform `checkpoint.permute_rope_layout` applies to the
    base wq/wk, so the deltas add to the permuted weights' outputs.  A
    factors are untouched (their axis is the input)."""
    ly = dict(lora["layers"])
    for t, heads in (("wq", args.n_heads), ("wk", args.kv_heads)):
        if f"{t}_b" in ly:
            perm = torch.from_numpy(ops.rope_split_permutation(heads, args.head_dim))
            ly[f"{t}_b"] = ly[f"{t}_b"][..., perm.to(ly[f"{t}_b"].device)]
    return {**lora, "layers": ly}


def stack_adapters(adapters, args: ModelArgs, rope_split: bool = False,
                   dtype=None) -> Dict:
    """A serving adapter bank from a list of adapter trees: each factor
    stacks to [NL, NA+1, ...] with bank index 0 all-zero (the base model,
    for requests with no adapter), in `dtype` (default args.dtype).
    rope_split permutes wq_b/wk_b for engines of the split-halves layout.
    All adapters must share rank, alpha and targets."""
    if not adapters:
        raise ValueError("stack_adapters needs at least one adapter")
    r0, a0, t0 = (adapters[0]["rank"], adapters[0]["alpha"],
                  tuple(adapters[0]["targets"]))
    for i, ad in enumerate(adapters):
        if (ad["rank"], ad["alpha"], tuple(ad["targets"])) != (r0, a0, t0):
            raise ValueError(
                f"adapter {i} has (rank, alpha, targets)="
                f"{(ad['rank'], ad['alpha'], tuple(ad['targets']))}; the "
                f"bank requires {(r0, a0, t0)} (one compiled program)")
    if rope_split:
        adapters = [permute_lora_rope_layout(ad, args) for ad in adapters]
    dt = torch_dtype(dtype or args.dtype)
    layers = {}
    for name in adapters[0]["layers"]:
        parts = [torch.zeros_like(adapters[0]["layers"][name])] + [
            ad["layers"][name] for ad in adapters]
        # [NA+1, NL, ...] -> [NL, NA+1, ...]
        layers[name] = torch.stack(parts).transpose(0, 1).to(dt).contiguous()
    return {"layers": layers, "rank": r0, "alpha": a0, "targets": t0,
            "scale": a0 / r0}


def bank_adapter_slice(bank: Dict, index: int) -> Dict:
    """One adapter's [NL, ...] single-adapter tree from a serving bank (the
    admission prefill's; index 0 is the zero adapter)."""
    return {"layers": {name: leaf[:, index] for name, leaf in bank["layers"].items()},
            "scale": bank["scale"]}


def merge_lora(params: Dict, lora: Dict) -> Dict:
    """Fold adapters into a split-layout tree: W <- W + scale * A@B (the
    product in f32, cast to W's dtype, then added).  Returns a new tree
    (the base is untouched); numpy leaves of a merged weight come back as
    tensors on the adapters' device."""
    ly = dict(params["layers"])
    if "wqkv" in ly or "wgu" in ly:
        raise ValueError("merge_lora needs the split weight layout; merge "
                         "before fusing (build_param_tree fuse_matmuls=False)")
    scale = lora["alpha"] / lora["rank"]
    for t in lora["targets"]:
        a, b = lora["layers"][f"{t}_a"], lora["layers"][f"{t}_b"]
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * scale
        w = torch.as_tensor(ly[t], device=a.device)
        ly[t] = w + delta.to(w.dtype)
    return {**params, "layers": ly}
