"""Training: the cacheless full-sequence forward, next-token loss and an
AdamW train step with optax's defaults.

Counterpart of `llama3np_tpu.train`.  The forward is the JAX package's
`forward_train`: no KV cache, the plain causal attention of
`ops.causal_attention` (training runs no kernel there either), and the
same roundings to the activation dtype.  Gradients come from autograd, as
the JAX package's from `jax.value_and_grad`.  Parameters and optimizer
state live in the tensors themselves: a train step updates them in place
and returns them, where the JAX step returns new arrays.

Over a dp x tp mesh (cfg.mesh, `parallel.sharding.local_config`) the
parameters are this rank's shards and the batch its dp rows: the forward
takes Megatron's pair of collectives (`Mesh.tp_copy` into the
column-sharded products, `Mesh.tp_reduce` out of the row-sharded ones) so
that autograd gives each shard the single device's gradient, and the step
averages the gradients over "dp" before the update.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .models.llama import StaticConfig, embed_tokens, lm_logits, tensor_parallel
from .ops import core as ops


def run_layers(block, h: torch.Tensor, n_layers: int, layer, remat: bool):
    """h through `block(h, *layer(i))` for each layer i; remat wraps each
    layer in `torch.utils.checkpoint` (non-reentrant): the backward
    recomputes the layer's activations instead of storing them, for ~1.3x
    the forward's work."""
    for i in range(n_layers):
        if remat and torch.is_grad_enabled():
            h = checkpoint(block, h, *layer(i), use_reentrant=False)
        else:
            h = block(h, *layer(i))
    return h


def _block(cfg: StaticConfig, cos, sin, h: torch.Tensor, lp: Dict) -> torch.Tensor:
    B, L = h.shape[:2]
    tp = tensor_parallel(cfg.mesh)
    x = ops.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    x = x if tp is None else tp.tp_copy(x)
    q = ops._dot(x, lp["wq"]).to(x.dtype)
    k = ops._dot(x, lp["wk"]).to(x.dtype)
    v = ops._dot(x, lp["wv"]).to(x.dtype)
    rope = ops.apply_rope_split if cfg.rope_split else ops.apply_rope
    q = rope(q.reshape(B, L, cfg.n_heads, cfg.head_dim), cos, sin)
    k = rope(k.reshape(B, L, cfg.kv_heads, cfg.head_dim), cos, sin)
    v = v.reshape(B, L, cfg.kv_heads, cfg.head_dim)
    attn = ops.causal_attention(q, k, v)
    reduce = None if tp is None else tp.tp_reduce
    h = h + ops._scaled_dot(attn.reshape(B, L, -1), lp["wo"], None, reduce).to(h.dtype)
    z = ops.rms_norm(h, lp["ffn_norm"], cfg.norm_eps)
    z = z if tp is None else tp.tp_copy(z)
    return h + ops.swiglu(z, lp["w_gate"], lp["w_up"], lp["w_down"], reduce=reduce)


def forward_train(params: Dict, input_ids: torch.Tensor, cos, sin,
                  cfg: StaticConfig, remat: bool = False) -> torch.Tensor:
    """Full-sequence logits [B, L, VS] in f32 over the split tree (no
    cache; causal within the block).  remat=True recomputes each layer's
    activations in the backward (`run_layers`)."""
    L = input_ids.shape[1]
    h = embed_tokens(params, input_ids.long(), cfg.mesh)
    ly = params["layers"]
    h = run_layers(lambda h, lp: _block(cfg, cos[:L], sin[:L], h, lp), h,
                   ly["wo"].shape[0], lambda i: ({n: w[i] for n, w in ly.items()},),
                   remat)
    h = ops.rms_norm(h, params["norm"], cfg.norm_eps)
    return lm_logits(params, h, cfg.mesh)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of f32 logits [..., VS] against integer labels
    (optax's softmax_cross_entropy_with_integer_labels, then the mean)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1))


def next_token_loss(params: Dict, batch: torch.Tensor, cos, sin,
                    cfg: StaticConfig, remat: bool = False) -> torch.Tensor:
    """Mean cross-entropy of predicting batch[:, 1:] from batch[:, :-1]."""
    logits = forward_train(params, batch[:, :-1], cos, sin, cfg, remat=remat)
    return cross_entropy(logits, batch[:, 1:])


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def optimizer_step(optimizer, tree, loss_fn, mesh=None) -> torch.Tensor:
    """One step of `optimizer` on the loss `loss_fn()` of the tensors of
    `tree`, which must be the ones the optimizer holds; returns the loss
    (detached).  Under a `mesh` with dp > 1 the gradients, and the loss
    returned, are averaged over "dp" first."""
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    if {id(t) for t in tree_leaves(tree)} != held:
        raise ValueError("the train step's tree is not the one the optimizer "
                         "holds (init_optimizer(tree))")
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    loss = loss.detach()
    if mesh is not None and mesh.size("dp") > 1:
        loss = loss.float().clone()
        mesh.dp_average_([t.grad for t in tree_leaves(tree) if t.grad is not None]
                         + [loss])
    optimizer.step()
    return loss


def make_train_step(optimizer, cfg: StaticConfig, remat: bool = False):
    """(params, opt_state, batch, cos, sin) -> (params, opt_state, loss):
    one AdamW step of every leaf of `params` (`optimizer` from
    `init_optimizer(params)`, which owns the tensors and updates them in
    place).  Under cfg.mesh: this rank's shards and dp rows, the gradients
    averaged over "dp" (module docstring)."""

    def train_step(params, opt_state, batch, cos, sin):
        loss = optimizer_step(optimizer, params, lambda: next_token_loss(
            params, batch, cos, sin, cfg, remat), cfg.mesh)
        return params, opt_state, loss

    return train_step


def init_optimizer(params, learning_rate: float = 1e-3):
    """(optimizer, opt_state) for every tensor of `params`, which start to
    require gradients: `torch.optim.AdamW` with optax.adamw's defaults
    (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every leaf; torch's
    own default decay is 1e-2).  opt_state is the optimizer's per-tensor
    state, filled in place by each step (zero moments at the start, as
    optax's init)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    return opt, opt.state
