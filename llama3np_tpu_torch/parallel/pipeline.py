"""Pipeline parallelism: layers stage-sharded over a ("pp",) mesh axis.

Counterpart of `llama3np_tpu.parallel.pipeline`.  Tensor parallelism
(sharding.py) splits every layer across ranks; pipeline parallelism gives
each rank a contiguous BLOCK of whole layers, the deployment shape for
models whose weights exceed one card but whose layers individually fit.

Design (greedy inference, single stream or batch):

  * Stage s holds layers [s*NL/S, (s+1)*NL/S) of the split tree and their
    KV cache; the embedding, final norm and lm_head are replicated
    (`pp_param_pspecs`).  On a ("pp", "tp") mesh each stage is a
    tensor-parallel group (`make_pp_tp_mesh`): its layers, the embedding
    and the head split over "tp" as `sharding.param_pspecs` splits them.
  * Every rank runs the same host loop of rounds.  In a round each stage
    that holds a packet (an activation on its way through the layers)
    runs its layers on it; then the packets hop one stage on, each hop a
    `broadcast` over the group of the two stages (s, s+1), and the last
    stage's token goes back to stage 0 over a group of its own.  The hops
    of a round go in one order on every rank (s = 0, 1, ..., then the
    token), so no rank waits on one that waits on it.  Unlike the JAX ring
    (a shard_map program, where every stage computes every round and
    masks its commits), only the stage that holds an activation runs its
    layers.
  * Prefill is one full-batch pass through the stages; the last stage
    takes the first token and broadcasts it to every stage.
  * Decode, single-microbatch (`pp_generate_fn`): one packet of the whole
    batch a token, S rounds a token.  Microbatched (`pp_generate_mb_fn`,
    B % S == 0): the batch splits into S microbatches of B/S rows that
    enter at rounds 0..S-1, so that after S fill rounds every stage works
    every round; packet (m, j) is at stage s in round m + S*j + s.  Each
    packet runs the solo decode math, so greedy streams equal the single
    device's either way.
  * The last stage holds every token and broadcasts them at the end: every
    rank returns the same [B, N] tokens.

On the card a stage's prefill runs the flash kernel on its layers (and,
under "tp", its heads); decode runs the split layout's plain forward, as
the JAX package's pipeline does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import (build_param_tree, load_parameters, params_to_device,
                          permute_rope_layout, quantize_param_tree)
from ..config import ModelArgs
from ..kvcache import init_cache
from ..models.llama import (StaticConfig, _layer_step, embed_tokens, lm_logits,
                            resolve_device)
from ..ops import core as ops
from .sharding import (Mesh, local_config, param_pspecs, shard_leaf, shard_tree,
                       validate_tp)


def make_pp_mesh(stages: int, *, backend: str, device) -> Mesh:
    """A ("pp",) mesh of `stages` ranks (rank s is stage s)."""
    return Mesh(("pp",), (stages,), backend, device)


def make_pp_tp_mesh(pp: int, tp: int, *, backend: str, device) -> Mesh:
    """2-D ("pp", "tp") mesh: the stages are tensor-parallel groups (rank =
    stage * tp + tp index), the 70B deployment shape: layers split across
    stage groups, each stage's layers tensor-parallel within its group."""
    return Mesh(("pp", "tp"), (pp, tp), backend, device)


def pp_param_pspecs(args: ModelArgs, quant: bool = False, tp: bool = False) -> Dict:
    """`sharding.param_pspecs` with each layer-stacked leaf's axis 0 over
    "pp"; without `tp` the "tp" entries are dropped (the embedding, final
    norm and head replicated)."""
    def spec(s, layer):
        axes = [a if tp else None for a in s]
        if layer:
            axes[0] = "pp"
        return tuple(axes)

    return {k: ({kk: spec(ss, True) for kk, ss in v.items()} if k == "layers"
                else spec(v, False))
            for k, v in param_pspecs(args, quant).items()}


def shard_params_pp(params: Dict, mesh: Mesh, args: ModelArgs, dtype=None) -> Dict:
    """This rank's stage (and "tp") shards of a split tree, copied onto
    mesh.device; float weights cast to `dtype` (default: kept)."""
    stages = mesh.size("pp")
    tp = mesh.size("tp")
    if args.n_layers % stages:
        raise ValueError(f"pp={stages} must divide n_layers {args.n_layers}")
    if tp > 1:
        validate_tp(args, mesh)
    specs = pp_param_pspecs(args, quant="wq_scale" in params["layers"], tp=tp > 1)
    return shard_tree(params, specs, mesh, dtype)


def shard_cache_pp(cache: Dict, mesh: Mesh) -> Dict:
    spec = ("pp", None, "tp", None, None) if mesh.size("tp") > 1 else ("pp",)
    return {name: shard_leaf(t, spec, mesh) for name, t in cache.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit float tensor as its bytes (a uint8 view): a broadcast
    copies bytes, and gloo takes no bf16 (nor int16) tensor."""
    return t.view(torch.uint8) if t.is_floating_point() and t.element_size() == 2 else t


class _Stages:
    """The ring of one pipelined engine: this rank's stage, its layers, and
    the hop groups (every rank makes every group, in one order)."""

    def __init__(self, engine: "PipelinedLlama"):
        mesh = engine.mesh
        self.e, self.mesh = engine, mesh
        self.S, self.stage = mesh.size("pp"), mesh.index("pp")
        self.hops = [mesh.new_pair_group("pp", s, s + 1) for s in range(self.S - 1)]
        self.back = mesh.new_pair_group("pp", self.S - 1, 0) if self.S > 1 else None

    def run(self, h, pos: int, cache, rows: slice, first_chunk: bool):
        """This stage's layers on h at `pos`, against its cache's `rows`."""
        e = self.e
        L = h.shape[1]
        cos, sin = e.cos[pos:pos + L], e.sin[pos:pos + L]
        layers = e.params["layers"]
        for i in range(layers["wo"].shape[0]):
            lp = {name: w[i] for name, w in layers.items()}
            h = _layer_step(e.cfg, first_chunk, pos, cos, sin, h, lp,
                            cache["k"][i][rows], cache["v"][i][rows])
        return h

    def token(self, h) -> torch.Tensor:
        """The last stage's greedy token of each row's last position."""
        e = self.e
        hn = ops.rms_norm(h[:, -1:, :], e.params["norm"], e.cfg.norm_eps)
        return torch.argmax(lm_logits(e.params, hn, e.cfg.mesh)[:, -1, :], dim=-1)

    def hop(self, s: int, t: torch.Tensor) -> None:
        """Stage s's t to stage s+1 (a no-op on the other stages)."""
        if self.stage in (s, s + 1):
            torch.distributed.broadcast(_bits(t), self.mesh.rank_at(pp=s),
                                        group=self.hops[s])

    def send_back(self, t: torch.Tensor) -> None:
        """The last stage's t to stage 0."""
        if self.stage in (0, self.S - 1):
            torch.distributed.broadcast(_bits(t), self.mesh.rank_at(pp=self.S - 1),
                                        group=self.back)

    def prefill(self, ids: torch.Tensor, cache) -> torch.Tensor:
        """One full-batch pass of the prompt; returns the first token [B] on
        every stage."""
        e, S = self.e, self.S
        B, L = ids.shape
        h = (embed_tokens(e.params, ids, e.cfg.mesh) if self.stage == 0 else
             torch.empty((B, L, e.args.dim), dtype=e.act_dtype, device=e.device))
        for s in range(S):
            if self.stage == s:
                h = self.run(h, 0, cache, slice(None), True)
            if s < S - 1:
                self.hop(s, h)
        tok = self.token(h) if self.stage == S - 1 else \
            torch.empty(B, dtype=torch.long, device=e.device)
        return self.mesh.broadcast(tok, "pp", S - 1)

    def decode(self, toks: torch.Tensor, L: int, cache, micro: int) -> None:
        """Tokens 1..N-1 of every row into toks [B, N] (column 0 holds the
        prefill's token), in `micro` microbatches (1 or S) of B / micro
        rows: round r, stage s holds packet (m, j) with r - s = m + S*j
        and m < micro, which turns token j of microbatch m into token j+1.
        The last stage's toks are complete; stage 0 holds the ones it took
        back to embed."""
        e, S, st = self.e, self.S, self.stage
        B, N = toks.shape
        R = B // micro
        shape = (R, 1, e.args.dim)
        inbox = torch.empty(shape, dtype=e.act_dtype, device=e.device)

        def packet(r: int, s: int):
            q = r - s
            if q < 0 or q % S >= micro or q // S > N - 2:
                return None
            return q % S, q // S

        for r in range(S * (N - 1) + S - 1):
            p, out = packet(r, st), None
            if p is not None:  # this stage's work this round
                m, j = p
                rows = slice(m * R, (m + 1) * R)
                h = (embed_tokens(e.params, toks[rows, j:j + 1], e.cfg.mesh)
                     if st == 0 else inbox)
                out = self.run(h, L + j, cache, rows, False)
                if st == S - 1:
                    toks[rows, j + 1] = self.token(out)
            for s in range(S - 1):  # the hops, in one order on every rank
                if packet(r, s) is not None:
                    if st == s:
                        self.hop(s, out)
                    elif st == s + 1:
                        inbox = torch.empty(shape, dtype=e.act_dtype, device=e.device)
                        self.hop(s, inbox)
            last = packet(r, S - 1)
            if last is not None and S > 1:
                m, j = last
                col = toks[m * R:(m + 1) * R, j + 1].contiguous()
                self.send_back(col)
                toks[m * R:(m + 1) * R, j + 1] = col


def pp_generate_fn(engine: "PipelinedLlama", ids: torch.Tensor, num_tokens: int):
    """Greedy generation through the stages, one packet of the whole batch
    a token (the JAX package's `pp_generate_fn` schedule): [B, N] tokens
    on every rank."""
    return _generate(engine, ids, num_tokens, micro=1)


def pp_generate_mb_fn(engine: "PipelinedLlama", ids: torch.Tensor, num_tokens: int):
    """Greedy generation with the batch in S microbatches that keep every
    stage busy after S fill rounds (the JAX package's `pp_generate_mb_fn`);
    B % S == 0."""
    return _generate(engine, ids, num_tokens, micro=engine.stages)


def _generate(engine, ids: torch.Tensor, num_tokens: int, micro: int):
    ring = engine._ring
    B, L = ids.shape
    cache = engine.init_cache(B)
    toks = torch.zeros((B, max(num_tokens, 1)), dtype=torch.long, device=engine.device)
    toks[:, 0] = ring.prefill(ids, cache)
    if num_tokens > 1:
        ring.decode(toks, L, cache, micro)
    toks = engine.mesh.broadcast(toks, "pp", engine.stages - 1)
    return toks[:, :num_tokens]


class PipelinedLlama:
    """Greedy-inference engine with layers pipeline-sharded over `mesh`
    (`make_pp_mesh`, or `make_pp_tp_mesh` for stages that are
    tensor-parallel groups), one instance in every rank.

    Scope, as the JAX package's: the split-weight layout, greedy decode,
    the memory-capacity deployment shape.  Composes with int8 (and int4)
    weights: the whole split tree quantizes, then shards with its scales,
    as the JAX package's."""

    def __init__(self, model_source, args: ModelArgs, mesh: Mesh,
                 precision: Optional[str] = None):
        weights = (load_parameters(model_source)
                   if isinstance(model_source, str) else model_source)
        params = build_param_tree(weights, args)
        if args.rope_split_layout:
            params = permute_rope_layout(params, args)
        if args.quant:
            dev = resolve_device(mesh.device)
            params = quantize_param_tree(
                params, bits=4 if args.quant == "int4" else 8,
                device=dev if dev.type == "cuda" else None, dtype=args.dtype)
        self._init(params, args, mesh)

    @classmethod
    def from_param_tree(cls, params: Dict, args: ModelArgs,
                        mesh: Mesh) -> "PipelinedLlama":
        """Over a split tree already in the engine's layout (tensors on any
        device, or numpy): this rank's stage shards of it, copied."""
        self = cls.__new__(cls)
        self._init(params, args, mesh)
        return self

    def _init(self, params, args, mesh):
        """This rank's stage shards of `params`, a split tree already in the
        engine's layout (permuted where args.rope_split_layout, quantized
        or not)."""
        self.args = args.validate()
        self.mesh = mesh
        self.stages = mesh.size("pp")
        self.tp = mesh.size("tp")
        self.device = resolve_device(mesh.device)
        local = shard_params_pp(params, mesh, args)
        self.params = params_to_device(local, self.device, args.dtype)
        self.act_dtype = self.params["norm"].dtype
        self.cfg = local_config(StaticConfig.from_args(args, self.device)._replace(
            fused=False), mesh)
        self.cos, self.sin = ops.rope_tables(
            args.head_dim, args.max_seq_len, args.rope_theta, torch.float32,
            scaling=args.rope_scaling, device=self.device)
        self._ring = _Stages(self)

    def init_cache(self, batch_size: int) -> Dict:
        """This stage's cache: its layers (and, under "tp", its KV heads)."""
        return init_cache(self.args, batch_size, device=self.device,
                          kv_heads=self.cfg.kv_heads,
                          n_layers=self.args.n_layers // self.stages)

    def generate_tokens(self, input_ids, num_tokens: int,
                        microbatched: bool = False) -> torch.Tensor:
        """Greedy decode: [B, num_tokens] on every rank.  `microbatched=True`
        uses the bubble-filling schedule (`pp_generate_mb_fn`) and requires
        B % stages == 0."""
        ids = np.asarray(input_ids)
        B, L = ids.shape
        if microbatched and B % self.stages:
            raise ValueError(
                f"microbatched pipeline needs batch ({B}) divisible by "
                f"stages ({self.stages})")
        if L + num_tokens > self.args.max_seq_len:
            raise ValueError(f"prompt ({L}) + num_tokens ({num_tokens}) exceeds "
                             f"max_seq_len ({self.args.max_seq_len})")
        t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        fn = pp_generate_mb_fn if microbatched else pp_generate_fn
        return fn(self, t, num_tokens)

    def stage_param_bytes(self) -> int:
        """This rank's weight bytes (the memory-capacity point of PP)."""
        return sum(t.numel() * t.element_size()
                   for v in self.params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
