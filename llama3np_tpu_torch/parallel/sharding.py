"""Meshes of ranks, and the tensor- and data-parallel layout of the
parameter tree and the caches.

Counterpart of `llama3np_tpu.parallel.sharding`.  The JAX package lays a
`jax.sharding.Mesh` over devices and lets GSPMD insert the collectives.
Here one process runs per rank under `torch.distributed`, as Megatron-LM
and vLLM run: each rank holds plain local tensors (its shards, which the
hand-written kernels read as they are), and the collectives are explicit
calls at the few points where a sharded product needs them (`Mesh`).  No
DTensor: its per-op dispatch would add host time to every serving step.

Layout rules (per stacked weight; the leading layers axis is never split),
as the JAX package's:

    wq/wk/wv  [NL, D, H*HD]  -> shard out-columns (heads) over "tp"
    wo        [NL, H*HD, D]  -> shard in-rows   (heads) over "tp"
    w_gate/up [NL, D, FD]    -> shard out-columns over "tp"
    w_down    [NL, FD, D]    -> shard in-rows over "tp"
    lm_head   [D, VS]        -> shard vocab over "tp"
    embedding [VS, D]        -> shard vocab over "tp"
    norms     [NL, D] / [D]  -> replicated
    cache k/v [NL, B, KVH, M, HD] -> B over "dp", KVH over "tp"

A spec is a tuple with one entry a tensor axis: the mesh axis it is split
over, or None.  "tp" must divide kv_heads (each rank owns whole KV-head
groups, so grouped attention stays local) and vocab_size.  int8 scales
follow their weights: column-sharded weights split their per-column
scales, row-sharded weights (wo, w_down) keep theirs whole.  int4 weights
pack two columns a byte along the last axis, so a column shard must hold
an even number of columns.

Where the partial products meet (`Mesh.tp_reduce`): the row-sharded wo and
w_down give each rank an f32 partial product; it is summed over "tp" in
f32, then post-scaled (int8, int4) and rounded to the activation dtype,
as GSPMD sums the f32 dot before the cast.  The vocabulary-sharded
embedding is a masked local gather summed over "tp", and the
vocabulary-sharded logits are gathered to the full vocabulary on every
rank (`Mesh.tp_gather`); both are exact, so every rank holds the same
logits and picks the same token.

Collectives are `all_reduce` and `broadcast` only, which take CUDA tensors
under NCCL and under gloo alike.  The backend is the caller's choice and
never picked here: "nccl" where each rank has its own GPU, "gloo" on the
CPU, and "gloo" where several ranks share one GPU (NCCL refuses two ranks
on one device).
"""

from __future__ import annotations

import math
import os
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import _to_tensor, torch_dtype
from ..config import ModelArgs


class Mesh:
    """A grid of the ranks of the default process group, with named axes.

    Rank r sits at the row-major coordinates of r in `shape` (rank = dp_i *
    tp + tp_j for ("dp", "tp")), as the JAX package reshapes its device
    list.  Each axis has one process group per line of the grid through
    it (`dist.new_group`, made by every rank in the same order); a rank
    keeps the ones it belongs to.  `device` is this rank's device, where
    its shards live."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 backend: str, device):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a Mesh needs torch.distributed's default process group: call "
                "dist.init_process_group(backend, init_method=..., rank=..., "
                "world_size=...) in every rank first (parallel.launch does)")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        n = math.prod(self.shape.values())
        world = dist.get_world_size()
        if n != world:
            dims = "x".join(str(s) for s in self.shape.values())
            raise ValueError(f"mesh {dims} needs {n} ranks, the process group "
                             f"has {world}")
        if backend != dist.get_backend():
            raise ValueError(f"the mesh was asked for backend {backend!r}; the "
                             f"default process group runs {dist.get_backend()!r}")
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        grid = np.arange(n).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, grid.shape))))
        self._grid = grid
        self.groups: Dict[str, object] = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[name] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def rank_at(self, **coords) -> int:
        """The global rank at this rank's coordinates with `coords` replaced."""
        c = {**self.coords, **coords}
        return int(self._grid[tuple(c[a] for a in self.axis_names)])

    def new_pair_group(self, axis: str, a: int, b: int):
        """Groups of the two ranks at coordinates a and b of `axis`, one for
        each line of the grid along it (every rank makes them all, in one
        order); returns the one on this rank's line, or None if this rank
        is at neither coordinate."""
        mine = None
        others = [n for n in self.axis_names if n != axis]
        for idx in np.ndindex(*(self.shape[n] for n in others)):
            fixed = dict(zip(others, idx))
            ranks = [int(self._grid[tuple({**fixed, axis: s}[n] for n in self.axis_names)])
                     for s in (a, b)]
            g = dist.new_group(sorted(ranks))
            if self.rank in ranks:
                mine = g
        return mine

    # -- collectives ------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` over `axis`, in place; returns it (a no-op on an axis of
        size 1)."""
        if self.size(axis) > 1:
            dist.all_reduce(t, group=self.groups[axis])
        return t

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """`t` of the rank at coordinate `src` of `axis`, in place on every
        rank of this rank's line along it."""
        if self.size(axis) > 1:
            dist.broadcast(t, self.rank_at(**{axis: src}), group=self.groups[axis])
        return t

    def tp_range(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of an axis of n entries split over "tp"."""
        tp = self.size("tp")
        if n % tp:
            raise ValueError(f"tp={tp} must divide an axis of {n}")
        i = self.index("tp")
        return i * n // tp, (i + 1) * n // tp

    def tp_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a partial product over "tp" in float32 (Megatron's "reduce":
        identity in the backward); the result keeps t's dtype."""
        if self.size("tp") == 1:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _Reduce.apply(t, self)
        r = t if t.dtype == torch.float32 else t.float()
        self.all_reduce(r, "tp")
        return r if r.dtype == t.dtype else r.to(t.dtype)

    def tp_copy(self, t: torch.Tensor) -> torch.Tensor:
        """The input of a column-sharded region (Megatron's "copy"): the
        identity, whose backward sums the gradient over "tp"."""
        if self.size("tp") == 1 or not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _Copy.apply(t, self)

    def tp_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Float32 [..., n] shards of the last axis -> the whole [..., n *
        tp] on every rank (zeros but this rank's slice, summed: exact).
        Its backward keeps this rank's slice of the gradient."""
        if self.size("tp") == 1:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _Gather.apply(t, self)
        return self.gather_dim(t, -1, "tp")

    def dp_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows [b, ...] -> every dp rank's rows [b * dp, ...],
        in dp order, on every rank (exact)."""
        return self.gather_dim(t, 0, "dp")

    def gather_dim(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The shards of `t` along tensor axis `dim` over mesh `axis`,
        concatenated in rank order, on every rank (zeros but this rank's
        slice, summed in f32 or int64: exact)."""
        size = self.size(axis)
        if size == 1:
            return t
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * size
        wide = torch.float32 if t.is_floating_point() else torch.int64
        full = torch.zeros(shape, dtype=wide, device=t.device)
        i = self.index(axis)
        full.narrow(dim, i * n, n).copy_(t)
        return self.all_reduce(full, axis).to(t.dtype)

    def barrier(self) -> None:
        """Every rank of the mesh has reached this point (an all-reduce of
        one value over the default group)."""
        dist.all_reduce(torch.zeros(1, device=self.device))

    def dp_rows(self, t, n: Optional[int] = None):
        """This rank's dp rows of a [B, ...] array or tensor (B % dp == 0)."""
        dp = self.size("dp")
        B = t.shape[0] if n is None else n
        if B % dp:
            raise ValueError(f"batch {B} must divide over dp={dp}")
        i = self.index("dp")
        return t[i * B // dp:(i + 1) * B // dp]

    def dp_average_(self, tensors) -> None:
        """Average each tensor over "dp", in place (the gradients of a
        data-parallel step)."""
        dp = self.size("dp")
        if dp == 1:
            return
        for t in tensors:  # summed in f32 (16-bit adapters' gradients too)
            r = t.float() if t.dtype != torch.float32 else t
            self.all_reduce(r, "dp").div_(dp)
            if r is not t:
                t.copy_(r)

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend}, {self.device})")


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (the output of a row-sharded
    product; `torch.distributed.nn`'s all_reduce would sum the gradient
    again, which is wrong here)."""

    @staticmethod
    def forward(ctx, t, mesh):
        r = t.float().clone()
        mesh.all_reduce(r, "tp")
        return r.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (the input of a column-sharded
    product)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        r = g.float().clone()
        ctx.mesh.all_reduce(r, "tp")
        return r.to(g.dtype), None


class _Gather(torch.autograd.Function):
    """Gather the last axis forward; keep this rank's slice backward."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.lo, ctx.n = mesh.index("tp") * t.shape[-1], t.shape[-1]
        return mesh.gather_dim(t.detach(), -1, "tp")

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n], None


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------

def make_mesh(dp: int = 1, tp: int = 1, *, backend: str, device) -> Mesh:
    """A ("dp", "tp") mesh over the dp * tp ranks of the default process
    group.  `backend` is the group's backend, said again ("nccl" where each
    rank has its own GPU, "gloo" on the CPU or for ranks that share one
    GPU): the mesh checks it and never picks one.  `device` is this rank's
    device ("cuda:<local rank>" under NCCL)."""
    return Mesh(("dp", "tp"), (dp, tp), backend, device)


def mesh_from_args(args: ModelArgs, *, backend: str, device) -> Optional[Mesh]:
    if args.mesh_dp * args.mesh_tp <= 1:
        return None
    return make_mesh(args.mesh_dp, args.mesh_tp, backend=backend, device=device)


def make_multihost_mesh(dp: int = 1, tp: int = 1, *, backend: str,
                        device) -> Mesh:
    """Multi-node mesh: tensor parallelism stays inside one node (its
    NVLink domain: the all-reduce after wo/w_down rides it) and data
    parallelism spans nodes.  The node size is torchrun's LOCAL_WORLD_SIZE
    (default: the whole group, one node); torchrun numbers ranks node by
    node, so the row-major ("dp", "tp") grid puts each tp group inside one
    node when the checks below pass.  One node is the flat mesh."""
    world = dist.get_world_size() if dist.is_initialized() else dp * tp
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_hosts = max(world // per_host, 1)
    if n_hosts > 1:
        if tp > per_host:
            raise ValueError(
                f"tp={tp} exceeds local devices ({per_host}); "
                f"TP must stay inside one host's ICI domain"
            )
        if dp % n_hosts:
            raise ValueError(
                f"dp={dp} must be a multiple of the host count ({n_hosts}): "
                f"data parallelism is what spans hosts over DCN"
            )
        if (dp // n_hosts) * tp != per_host:
            raise ValueError(
                f"per-host mesh ({dp // n_hosts} x {tp}) must cover the "
                f"{per_host} local devices"
            )
    return make_mesh(dp, tp, backend=backend, device=device)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def param_pspecs(args: ModelArgs, quant: bool = False) -> Dict:
    """Spec tree matching `checkpoint.build_param_tree`'s split tree; with
    `quant`, the int8/int4 scale leaves too (column-sharded weights split
    their per-column scales, row-sharded ones replicate theirs: the sum
    over "tp" of the partial products is post-scaled once)."""
    specs = {
        "tok_embedding": ("tp", None),
        "layers": {
            "wq": (None, None, "tp"),
            "wk": (None, None, "tp"),
            "wv": (None, None, "tp"),
            "wo": (None, "tp", None),
            "w_gate": (None, None, "tp"),
            "w_up": (None, None, "tp"),
            "w_down": (None, "tp", None),
            "attn_norm": (None, None),
            "ffn_norm": (None, None),
        },
        "norm": (None,),
        "lm_head": (None, "tp"),
    }
    if quant:
        specs["layers"].update({
            "wq_scale": (None, None, "tp"),
            "wk_scale": (None, None, "tp"),
            "wv_scale": (None, None, "tp"),
            "wo_scale": (None, None, None),
            "w_gate_scale": (None, None, "tp"),
            "w_up_scale": (None, None, "tp"),
            "w_down_scale": (None, None, None),
        })
        specs["tok_embedding_scale"] = ("tp", None)
        specs["lm_head_scale"] = (None, "tp")
    return specs


def cache_pspecs() -> Dict:
    return {
        "k": (None, "dp", "tp", None, None),
        "v": (None, "dp", "tp", None, None),
    }


def serving_cache_pspecs(cache: Dict) -> Dict:
    """Specs for a `BatchEngine` cache (dense slots or page pool).

    Both layouts are [NL, B-or-P, KVH, M-or-page, HD] with KVH at axis 2,
    and the int8 scale leaves drop the trailing HD, so one rule covers all
    four: shard KVH over "tp", replicate everything else.  The slot/page
    axis deliberately does NOT shard over "dp": admissions scatter into a
    single slot's rows and the block tables are host-side, so the engine's
    unit of data parallelism is a whole engine replica, not a slot split.
    """
    return {name: (None, None, "tp", *(None,) * (len(arr.shape) - 3))
            for name, arr in cache.items()}


def activation_pspec() -> tuple:
    return ("dp", None, None)


def local_config(cfg, mesh: Mesh):
    """A `models.llama.StaticConfig` of the whole model -> this rank's under
    `mesh`: its query and KV heads, and the mesh the forward reads for its
    collectives (the caller has run `validate_tp`)."""
    tp = mesh.size("tp")
    return cfg._replace(n_heads=cfg.n_heads // tp, kv_heads=cfg.kv_heads // tp,
                        mesh=mesh)


def validate_tp(args: ModelArgs, mesh: Mesh):
    tp = mesh.size("tp")
    if args.kv_heads % tp:
        raise ValueError(
            f"tensor-parallel degree {tp} must divide kv_heads {args.kv_heads} "
            f"(each shard owns whole KV-head groups)"
        )
    if args.vocab_size % tp:
        raise ValueError(f"tp={tp} must divide vocab_size {args.vocab_size}")


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

def _index(shape, spec, mesh: Mesh, packed: bool = False):
    """The slices of this rank's shard of a leaf of `shape` under `spec`.
    `packed`: the leaf is int4, two columns a byte along its last axis, so
    a split of that axis must leave an even number of columns a shard."""
    idx = []
    for ax, (n, name) in enumerate(zip(shape, tuple(spec) + (None,) * len(shape))):
        size = 1 if name is None else mesh.size(name)
        if size == 1:
            idx.append(slice(None))
            continue
        if n % size:
            raise ValueError(f"{name}={size} must divide an axis of {n}")
        if packed and ax == len(shape) - 1 and (2 * n // size) % 2:
            raise ValueError(f"int4 packs two columns a byte: {2 * n} columns over "
                             f"{name}={size} leave an odd shard")
        i = mesh.index(name)
        idx.append(slice(i * n // size, (i + 1) * n // size))
    return tuple(idx)


def shard_leaf(x, spec, mesh: Mesh, dtype=None) -> torch.Tensor:
    """This rank's shard of one leaf (a numpy array, or a tensor on any
    device) as its own tensor on `mesh.device`: copied, so that no view
    pins the whole leaf."""
    packed = x.dtype in (np.uint8, torch.uint8)
    part = x[_index(x.shape, spec, mesh, packed)]
    if isinstance(part, torch.Tensor):
        part = part.to(mesh.device)
        if dtype is not None and part.dtype.is_floating_point:
            part = part.to(dtype)
        return part.clone(memory_format=torch.contiguous_format)
    return _to_tensor(np.array(part), mesh.device, dtype)


def _leaf_dtype(name: str, x, dtype):
    """`dtype` for float weights; scales float32; int8/int4 codes their own."""
    if x.dtype in (np.int8, np.uint8, torch.int8, torch.uint8):
        return None
    return torch.float32 if name.endswith("_scale") else dtype


def shard_params(params: Dict, mesh: Mesh, args: ModelArgs, dtype=None) -> Dict:
    """This rank's shards of a split parameter tree (numpy leaves, or
    tensors on any device) under `param_pspecs`, each copied onto
    `mesh.device`; float weights cast to `dtype` (default: kept)."""
    validate_tp(args, mesh)
    if "wqkv" in params["layers"]:
        raise ValueError("tensor parallelism runs the split layout "
                         "(fuse_matmuls=False)")
    return shard_tree(params, param_pspecs(args, quant="wq_scale" in params["layers"]),
                      mesh, dtype)


def shard_tree(params: Dict, specs: Dict, mesh: Mesh, dtype=None) -> Dict:
    """This rank's shards of every leaf of `params` under the spec tree
    `specs`, each copied onto `mesh.device`; float weights cast to `dtype`
    (default: kept), scales float32, integer codes their own."""
    dt = None if dtype is None else torch_dtype(dtype)
    return {k: ({kk: shard_leaf(vv, specs[k][kk], mesh, _leaf_dtype(kk, vv, dt))
                 for kk, vv in v.items()} if isinstance(v, dict)
                else shard_leaf(v, specs[k], mesh, _leaf_dtype(k, v, dt)))
            for k, v in params.items()}


def shard_cache(cache: Dict, mesh: Mesh) -> Dict:
    specs = cache_pspecs()
    return {name: shard_leaf(arr, specs[name], mesh) for name, arr in cache.items()}


def shard_serving_cache(cache: Dict, mesh: Mesh) -> Dict:
    specs = serving_cache_pspecs(cache)
    return {name: shard_leaf(arr, specs[name], mesh) for name, arr in cache.items()}


# ---------------------------------------------------------------------------
# Streaming sharded checkpoint load (70B-class)
# ---------------------------------------------------------------------------

def _npz_arrays(path: str) -> Dict:
    """Each member of an .npz as an array that reads from the file on
    demand: a read-only memmap of the member's bytes in the archive where
    it is stored uncompressed (`np.savez`, `checkpoint.save_npz`), so a
    slice of it reads only the pages under the slice; a compressed member
    (`np.savez_compressed`) has no such view and is decompressed whole
    when it is first read."""
    out, npz = {}, None
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            if info.compress_type != zipfile.ZIP_STORED:
                npz = npz or np.load(path)
                out[key] = _Lazy(npz, key)
                continue
            f.seek(info.header_offset)
            local = f.read(30)
            name_len = int.from_bytes(local[26:28], "little")
            extra_len = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + name_len + extra_len)
            fmt = np.lib.format
            read = (fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0)
                    else fmt.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            out[key] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                                 shape=shape, order="F" if fortran else "C")
    return out


class _Lazy:
    """A compressed .npz member, decompressed at its first slice."""

    def __init__(self, npz, key):
        self.npz, self.key, self._a = npz, key, None

    def _arr(self):
        if self._a is None:
            self._a = self.npz[self.key]
        return self._a

    @property
    def shape(self):
        return self._arr().shape

    @property
    def T(self):
        return self._arr().T

    def __getitem__(self, idx):
        return self._arr()[idx]


def load_param_tree_sharded(model_path: str, args: ModelArgs, mesh: Mesh,
                            dtype=None) -> Dict:
    """This rank's shards of a reference-schema .npz's split tree, read
    straight from the file onto `mesh.device` without ever holding a whole
    weight: each stacked leaf is made layer by layer from the slice of the
    member this rank owns (`_npz_arrays`), so host memory peaks at one
    layer's shard (a 70B tensor-parallel load reads 1/tp of the file per
    rank).  No RoPE permutation (as the JAX package's streaming load)."""
    validate_tp(args, mesh)
    dt = torch_dtype(dtype or args.dtype)
    arrays = _npz_arrays(model_path)
    specs = param_pspecs(args)

    def put(part):
        return _to_tensor(np.array(part, dtype=np.float32), mesh.device, dt)

    def stacked(fmt, transpose, spec):
        first = arrays[fmt.format(i=0)]
        base = first.shape[::-1] if transpose else first.shape
        idx = _index((args.n_layers, *base), spec, mesh)[1:]
        parts = []
        for i in range(args.n_layers):
            w = arrays[fmt.format(i=i)]
            parts.append(put((w.T if transpose else w)[idx]))
        return torch.stack(parts)

    def plain(key, spec, transpose=False):
        w = arrays[key]
        shape = w.shape[::-1] if transpose else w.shape
        return put((w.T if transpose else w)[_index(shape, spec, mesh)])

    layer_fmts = {
        "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
        "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
        "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
        "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
        "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
        "w_up": ("model.layers.{i}.mlp.up_proj.weight", True),
        "w_down": ("model.layers.{i}.mlp.down_proj.weight", True),
        "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
        "ffn_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    }
    layers = {name: stacked(fmt, tr, specs["layers"][name])
              for name, (fmt, tr) in layer_fmts.items()}
    head_key = ("lm_head.weight" if "lm_head.weight" in arrays
                and not args.tie_word_embeddings else "model.embed_tokens.weight")
    return {
        "tok_embedding": plain("model.embed_tokens.weight", specs["tok_embedding"]),
        "layers": layers,
        "norm": plain("model.norm.weight", specs["norm"]),
        "lm_head": plain(head_key, specs["lm_head"], transpose=True),
    }
