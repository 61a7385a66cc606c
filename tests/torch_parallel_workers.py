"""Rank functions of the port's multi-process tests (`test_torch_sharding`,
`test_torch_serving_tp`, `test_torch_pipeline`, the sharded LoRA step and
prefetch, and the card's two-rank tests).

The tests spawn ranks with `llama3np_tpu_torch.parallel.launch.launch`,
and each spawned rank imports this module to find its function, so it
imports torch, numpy and the port only, never jax or the JAX package
(`test_torch_host.py` checks).  Every function runs many scenarios in one
world and returns plain Python / numpy results for the parent to hold
against the JAX package.  Each rank runs one CPU thread: the test suite
runs several workers at once.
"""

from __future__ import annotations

import numpy as np
import torch

from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.parallel.sharding import make_mesh, validate_tp
from llama3np_tpu_torch.serving import BatchEngine


def _setup(device: str):
    if device == "cpu":
        torch.set_num_threads(1)
    return torch.distributed.get_backend()


def _shapes(tree) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": (tuple(vv.shape), str(vv.dtype)) for kk, vv in v.items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype))
    return out


class KernelCalls:
    """Records the heads each kernel wrapper of the model is called on
    (the wrappers run their plain twins on CPU tensors)."""

    def __init__(self):
        import llama3np_tpu_torch.models.llama as M
        self.M, self.calls = M, []
        self.flash, self.paged = M.flash_prefill, M.paged_attention

        def flash(q, k, v):
            self.calls.append(("flash_prefill", q.shape[2], k.shape[2]))
            return self.flash(q, k, v)

        def paged(q, k_pages, *a, **kw):
            self.calls.append(("paged_attention", q.shape[2], k_pages.shape[2]))
            return self.paged(q, k_pages, *a, **kw)

        M.flash_prefill, M.paged_attention = flash, paged

    def close(self):
        self.M.flash_prefill, self.M.paged_attention = self.flash, self.paged
        return sorted(set(self.calls))


# ---------------------------------------------------------------------------
# engines over a ("dp", "tp") mesh
# ---------------------------------------------------------------------------

def engine_ranks(rank: int, device: str, scenarios, refusals=()):
    """scenarios: dicts with name, dp, tp, args, and one source: weights
    (`Llama(mesh=)`), quantized (a `from_quantized` path) or streamed (a
    `from_sharded_checkpoint` path, read with the .npz members' whole reads
    barred); optional ids (a reference forward at 0), gen (ids, n), state
    (a path: the generation's state saved there and 4 tokens resumed) and
    kernels (the kernel wrappers on, recording their heads).  refusals:
    (args, dp, tp) whose `validate_tp` message is returned."""
    backend = _setup(device)
    out = {}
    for sc in scenarios:
        mesh = make_mesh(sc["dp"], sc["tp"], backend=backend, device=device)
        if "weights" in sc:
            eng = Llama(sc["weights"], sc["args"], mesh=mesh)
        elif "quantized" in sc:
            eng = Llama.from_quantized(sc["quantized"], sc["args"], mesh=mesh)
        else:
            npz_file = np.lib.npyio.NpzFile

            def whole_read(self, key):
                raise AssertionError(f"read the whole member {key!r}")

            getitem, npz_file.__getitem__ = npz_file.__getitem__, whole_read
            try:
                eng = Llama.from_sharded_checkpoint(sc["streamed"], sc["args"], mesh)
            finally:
                npz_file.__getitem__ = getitem
        res = {"shapes": _shapes(eng.params), "coords": mesh.coords,
               "cache": tuple(eng.init_cache(sc["args"].max_batch_size)["k"].shape)}
        rec = None
        if sc.get("kernels"):
            eng.cfg = eng.cfg._replace(kernels=True)
            rec = KernelCalls()
        try:
            if "ids" in sc:
                res["logits"] = eng(sc["ids"], 0)
                eng.reset()
            if "gen" in sc:
                ids, n = sc["gen"]
                res["tokens"] = eng.generate_tokens(ids, n).tolist()
            if "state" in sc:  # the generation's state, saved and resumed
                eng.save_generation_state(sc["state"])
                res["resumed"] = eng.resume_generate(sc["state"], 4).tolist()
            if sc.get("kernels"):
                be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
                req = be.submit([1, 5, 9, 14, 3], 4, stop_ids=())
                be.run_to_completion()
                res["served"] = req.generated
        finally:
            if rec is not None:
                res["kernel_calls"] = rec.close()
        if "streamed" in sc:
            res["wq"] = eng.params["layers"]["wq"].numpy()
        out[sc["name"]] = res
    msgs = []
    for args, dp, tp in refusals:
        try:
            validate_tp(args, make_mesh(dp, tp, backend=backend, device=device))
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    out["refusals"] = msgs
    return out


# ---------------------------------------------------------------------------
# serving over a tensor-parallel engine
# ---------------------------------------------------------------------------

def drain(be, reqs):
    while be.num_active or be._queue:
        be.step(quantum=4)
    return [r.generated for r in reqs]


def mixed_workload(be):
    """Mixed greedy/sampled requests admitted at staggered times
    (tests/test_serving_tp.py's workload)."""
    reqs = [be.submit([1, 5, 9, 14], 12),
            be.submit([1, 7], 10, temperature=0.8),
            be.submit([1, 3, 3, 8, 2, 9], 8)]
    be.step(quantum=2)
    reqs.append(be.submit([1, 11, 4], 9, temperature=1.1))
    return drain(be, reqs)


def prefix_workload(engine, engine_cls=BatchEngine):
    """Chunked admission and the prefix cache (tests/test_serving_tp.py):
    the streams and the prefix hits of `engine_cls` (either package's
    BatchEngine) over `engine`."""
    common = [1, 4, 6, 2, 9, 3, 5, 7, 8, 10, 12, 11, 13, 14, 15, 16, 17]
    be = engine_cls(engine, capacity=4, paged=True, page_size=8,
                    admit_chunk=8, prefix_cache=True)
    r1 = be.submit(common + [20, 21], 8)
    drain(be, [r1])
    r2 = be.submit(common + [30], 8)
    r3 = be.submit([1, 2] * 12, 6)
    out = drain(be, [r1, r2, r3])
    return out, be.prefix_stats["hit_tokens"]


def soak(engine, vocab_size: int, seed: int = 77):
    """tests/test_serving_soak.py's tensor-parallel soak: 16 random requests,
    staggered admissions, random quanta, over a 40-page pool."""
    rng = np.random.default_rng(seed)
    be = BatchEngine(engine, capacity=3, paged=True, page_size=8,
                     num_pages=40, kv_quant=None)
    pending = []
    for _ in range(16):
        L = int(rng.integers(2, 12))
        budget = int(rng.integers(2, 14))
        pending.append((rng.integers(3, vocab_size, size=L).tolist(), budget))
    reqs, submitted = [], 0
    for _ in range(600):
        while submitted < len(pending) and rng.random() < 0.5:
            p, b = pending[submitted]
            reqs.append(be.submit(p, b))
            submitted += 1
        if be.num_active == 0 and not be._queue and submitted == len(pending):
            break
        be.step(int(rng.integers(1, 5)))
    else:
        raise AssertionError("tp soak did not drain")
    return pending, [r.generated for r in reqs], be.allocator.available


def serving_ranks(rank: int, device: str, w, args, qargs, soak_w, soak_args,
                  ml_w, ml_args, adapters):
    """Every tests/test_serving_tp.py scenario (tp=2), the tp=2 soak, and
    multi-LoRA serving over a tp=2 engine; each stream as the rank saw it."""
    from llama3np_tpu_torch.lora import lora_from_jax
    backend = _setup(device)
    mesh = make_mesh(1, 2, backend=backend, device=device)
    tp = Llama(w, args, mesh=mesh)
    out = {"dense": mixed_workload(BatchEngine(tp, capacity=4, paged=False, page_size=8)),
           "paged": mixed_workload(BatchEngine(tp, capacity=4, paged=True, page_size=8)),
           "int8_kv": mixed_workload(BatchEngine(tp, capacity=4, paged=True,
                                                 page_size=8, kv_quant="int8"))}
    be = BatchEngine(tp, capacity=4, paged=True, page_size=8, kv_quant="int8")
    layout = {name: tuple(t.shape) for name, t in be.cache.items()}
    be.submit([1, 5, 9], 6)
    be.step(quantum=2)
    out["pool_layout"] = (layout, {name: tuple(t.shape) for name, t in be.cache.items()})
    out["int8_weights"] = mixed_workload(BatchEngine(
        Llama(w, qargs, mesh=mesh), capacity=4, paged=True, page_size=8, kv_quant="int8"))
    out["prefix"] = prefix_workload(tp)
    be = BatchEngine(tp, capacity=2, paged=True, page_size=8)
    r1 = be.submit([1, 5, 9], 16)
    r2 = be.submit([1, 7, 2], 16)
    be.step(quantum=2)
    cancelled = be.cancel(r1)
    free_after = be.allocator.available
    drain(be, [r2])
    out["cancel"] = (cancelled, free_after, be.allocator.available,
                     be.allocator.num_pages - 1, r2.generated)
    out["soak"] = soak(Llama(soak_w, soak_args, mesh=mesh), soak_args.vocab_size)
    bank = [lora_from_jax(a, device) for a in adapters]
    ml = Llama(ml_w, ml_args, mesh=mesh)
    be = BatchEngine(ml, capacity=3, paged=True, page_size=8, adapters=bank)
    reqs = [be.submit([1, 5, 9, 14], 8, stop_ids=()),
            be.submit([1, 7, 2], 8, stop_ids=(), adapter=0),
            be.submit([1, 3, 8], 8, stop_ids=(), adapter=1)]
    while be.num_active:
        be.step(quantum=4)
    out["multilora"] = [r.generated for r in reqs]
    out["bank_whole"] = {k: tuple(v.shape) for k, v in be.lora_bank["layers"].items()}
    rec = KernelCalls()
    tp.cfg = tp.cfg._replace(kernels=True)
    try:
        out["kernel_path"] = mixed_workload(BatchEngine(tp, capacity=4, paged=True,
                                                        page_size=8))
    finally:
        out["kernel_calls"] = rec.close()
    return out


def serving_dp_ranks(rank: int, device: str, w, args):
    """A ("dp", "tp") = (2, 2) engine under BatchEngine: the pools replicate
    over "dp" (a whole engine is the dp unit)."""
    backend = _setup(device)
    eng = Llama(w, args, mesh=make_mesh(2, 2, backend=backend, device=device))
    be = BatchEngine(eng, capacity=4, paged=True, page_size=8)
    return {"streams": mixed_workload(be),
            "pool": tuple(be.cache["k"].shape)}


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def pipeline_ranks(rank: int, device: str, pp: int, tp: int, w, args, runs,
                   args_q=None, refusals=()):
    """PipelinedLlama over a pp (x tp) mesh: runs = [(name, ids, n,
    microbatched)], twice each where the name ends in "*2"; with args_q the
    int8 engine's runs too; the stage's weight bytes and shapes; refusals:
    (kind, args, weights or ids) whose error messages are returned."""
    from llama3np_tpu_torch.parallel.pipeline import (PipelinedLlama, make_pp_mesh,
                                                      make_pp_tp_mesh)
    backend = _setup(device)
    mesh = (make_pp_mesh(pp, backend=backend, device=device) if tp == 1 else
            make_pp_tp_mesh(pp, tp, backend=backend, device=device))
    eng = PipelinedLlama(w, args, mesh)
    out = {"bytes": eng.stage_param_bytes(), "shapes": _shapes(eng.params),
           "layer_bytes": sum(t.numel() * t.element_size()
                              for t in eng.params["layers"].values())}
    for name, ids, n, mb in runs:
        out[name] = [eng.generate_tokens(ids, n, microbatched=mb).tolist()
                     for _ in range(2 if name.endswith("*2") else 1)]
    if args_q is not None:
        q = PipelinedLlama(w, args_q, mesh)
        out["int8_dtype"] = str(q.params["layers"]["wq"].dtype)
        out["int8_shapes"] = _shapes(q.params)
        out["int8"] = [q.generate_tokens(ids, n, microbatched=mb).tolist()
                       for _, ids, n, mb in runs[:1]]
    msgs = []
    for kind, a, x in refusals:
        try:
            if kind == "layers":
                PipelinedLlama(x, a, mesh)
            else:
                eng.generate_tokens(x, 4, microbatched=True)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    out["refusals"] = msgs
    return out


# ---------------------------------------------------------------------------
# training and data over a mesh
# ---------------------------------------------------------------------------

def lora_train_ranks(rank: int, device: str, weights, args, batch, steps: int,
                     lr: float):
    """The dp x tp = 2 x 2 LoRA train step (tests/test_lora.py's sharded
    scenario): this rank's shards of the base and of init_lora(rank=4,
    seed=1), its dp rows of the batch; the losses and this rank's trained
    wq_b / wo_a shards."""
    from llama3np_tpu_torch import lora as tlora
    from llama3np_tpu_torch import train as ttrain
    from llama3np_tpu_torch.checkpoint import build_param_tree
    from llama3np_tpu_torch.models.llama import StaticConfig
    from llama3np_tpu_torch.ops.core import rope_tables
    from llama3np_tpu_torch.parallel.sharding import local_config, shard_params
    backend = _setup(device)
    mesh = make_mesh(2, 2, backend=backend, device=device)
    params = shard_params(build_param_tree(weights, args), mesh, args)
    cfg = local_config(StaticConfig(args.n_heads, args.kv_heads, args.head_dim,
                                    args.norm_eps, rope_split=False, fused=False), mesh)
    lora = tlora.shard_lora(tlora.init_lora(args, rank=4, seed=1, device=device), mesh)
    opt, st = ttrain.init_optimizer(lora["layers"], learning_rate=lr)
    step = tlora.make_lora_train_step(opt, cfg, lora["alpha"] / lora["rank"])
    cos, sin = rope_tables(args.head_dim, args.max_seq_len, args.rope_theta,
                           device=device)
    local = torch.as_tensor(mesh.dp_rows(batch), device=device)
    ly, losses = lora["layers"], []
    for _ in range(steps):
        ly, st, loss = step(ly, st, params, local, cos, sin)
        losses.append(float(loss))
    return {"losses": losses, "coords": mesh.coords,
            "wq_b": ly["wq_b"].detach().numpy(), "wo_a": ly["wo_a"].detach().numpy(),
            "specs": tlora.lora_pspecs(lora)}


def prefetch_ranks(rank: int, device: str, path: str):
    """`prefetch_to_device(mesh=)` over a dp=2 mesh: this rank's rows of
    each batch."""
    from llama3np_tpu_torch.data import TokenDataset, prefetch_to_device
    backend = _setup(device)
    mesh = make_mesh(2, 1, backend=backend, device=device)
    ds = TokenDataset(path)
    return [b.numpy() for b in prefetch_to_device(
        ds.batches(2, 5, shuffle=False, epochs=1), mesh=mesh)]


# ---------------------------------------------------------------------------
# the card: two ranks on one GPU
# ---------------------------------------------------------------------------

def card_ranks(rank: int, device: str, tree, args, prompt, n: int, workload):
    """Two ranks on one card (gloo): a tp=2 engine's greedy tokens and
    paged serving streams, and a pp=2 pipeline's tokens in both schedules,
    over the same split tree (the parent's, through CUDA IPC); each
    kernel's launches on this rank."""
    from llama3np_tpu_torch.ops.kernels.flash_prefill import flash_prefill
    from llama3np_tpu_torch.ops.kernels.paged_attention import paged_attention
    from llama3np_tpu_torch.parallel.pipeline import PipelinedLlama, make_pp_mesh
    backend = _setup(device)
    out = {}
    eng = Llama.from_param_tree(tree, args, mesh=make_mesh(1, 2, backend=backend,
                                                           device=device))
    flash_prefill.launches = paged_attention.launches = 0
    out["tp_tokens"] = eng.generate_tokens(prompt, n).tolist()
    be = BatchEngine(eng, capacity=4, paged=True, page_size=16)
    steps, step = [0], be.step

    def counted_step(quantum=1):  # a step with active rows decodes
        steps[0] += quantum if be.num_active else 0
        return step(quantum)

    be.step = counted_step
    reqs = [be.submit(p, b, stop_ids=()) for p, b in workload]
    be.run_to_completion()
    out["tp_served"] = [r.generated for r in reqs]
    out["tp_decode_steps"] = steps[0]
    out["tp_launches"] = {"flash_prefill": flash_prefill.launches,
                          "paged_attention": paged_attention.launches}
    del eng, be
    pp = PipelinedLlama.from_param_tree(tree, args, make_pp_mesh(2, backend=backend,
                                                                 device=device))
    flash_prefill.launches = 0  # both schedules' prefills
    batch = np.concatenate([prompt, prompt[:, ::-1]])
    out["pp_tokens"] = pp.generate_tokens(batch, n).tolist()
    out["pp_mb_tokens"] = pp.generate_tokens(batch, n, microbatched=True).tolist()
    out["pp_launches"] = {"flash_prefill": flash_prefill.launches}
    out["pp_bytes"] = pp.stage_param_bytes()
    return out
