"""Tensor-parallel serving in the port: `serving.BatchEngine` over a tp=2
`Llama(mesh=)`, against the JAX package's tp=2 `BatchEngine` and its
single-chip engine: every tests/test_serving_tp.py scenario (dense and
paged, int8 KV, int8 weights, chunked admission with the prefix cache, a
dp axis present, cancel, the pool's layout), tests/test_serving_soak.py's
tp=2 soak and tests/test_multilora.py's tp=2 multi-LoRA serving.

The port's ranks are spawned under gloo on the CPU (two for tp=2, four for
the (2, 2) mesh), once each for the module
(`torch_parallel_workers.serving_ranks`, `serving_dp_ranks`).  Every rank
runs the same scheduler and must give the same tokens; sampled requests
draw the JAX engine's tokens for the same seed.
"""

import numpy as np
import pytest

import jax

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu.lora import init_lora
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.parallel.sharding import make_mesh as jmesh
from llama3np_tpu.serving import BatchEngine as JBatch
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.parallel.launch import launch

import torch_parallel_workers as W


def make_adapter(args, seed, rank=4):
    """tests/test_multilora.py's adapter: non-zero B factors."""
    lora = init_lora(args, rank=rank, alpha=8.0, seed=seed,
                     targets=("wq", "wv", "w_gate", "w_down"))
    key = jax.random.PRNGKey(seed + 100)
    ly = dict(lora["layers"])
    for name in list(ly):
        if name.endswith("_b"):
            key, sub = jax.random.split(key)
            ly[name] = 0.05 * jax.random.normal(sub, ly[name].shape, ly[name].dtype)
    return {**lora, "layers": ly}


@pytest.fixture(scope="module")
def setup():
    args = jpreset("test-tiny")
    w = synthetic_weights(args, seed=7)
    soak_args = jpreset("test-tiny", max_seq_len=64)
    soak_w = synthetic_weights(soak_args, seed=31)
    ml_args = jpreset("test-tiny", fuse_matmuls=False, dtype="float32")
    adapters = [make_adapter(ml_args, seed=1), make_adapter(ml_args, seed=2)]
    return dict(args=args, w=w, soak_args=soak_args, soak_w=soak_w,
                ml_args=ml_args, adapters=adapters)


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    bank = [{**a, "layers": {k: np.asarray(v) for k, v in a["layers"].items()}}
            for a in s["adapters"]]
    tp2 = launch(W.serving_ranks, 2,
                 (s["w"], tpreset("test-tiny"), tpreset("test-tiny", quant="int8"),
                  s["soak_w"], tpreset("test-tiny", max_seq_len=64),
                  s["w"], tpreset("test-tiny", fuse_matmuls=False, dtype="float32"), bank),
                 backend="gloo", devices=["cpu"] * 2, timeout_s=300)
    dp = launch(W.serving_dp_ranks, 4, (s["w"], tpreset("test-tiny", max_batch_size=2)),
                backend="gloo", devices=["cpu"] * 4, timeout_s=300)
    return tp2, dp


@pytest.fixture(scope="module")
def jax_engines(setup):
    return JLlama(setup["w"], setup["args"]), \
        JLlama(setup["w"], setup["args"], mesh=jmesh(dp=1, tp=2))


mixed_workload = W.mixed_workload


def _every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        assert r[key] == first
    return first


@pytest.mark.parametrize("paged", [False, True])
def test_tp_stream_identity(ranks, jax_engines, paged):
    solo, tp = jax_engines
    want = mixed_workload(JBatch(solo, capacity=4, paged=paged, page_size=8))
    assert mixed_workload(JBatch(tp, capacity=4, paged=paged, page_size=8)) == want
    assert _every_rank(ranks[0], "paged" if paged else "dense") == want


def test_tp_int8_kv_pool_identity(ranks, jax_engines):
    solo, tp = jax_engines
    want = mixed_workload(JBatch(solo, capacity=4, paged=True, page_size=8,
                                 kv_quant="int8"))
    assert mixed_workload(JBatch(tp, capacity=4, paged=True, page_size=8,
                                 kv_quant="int8")) == want
    assert _every_rank(ranks[0], "int8_kv") == want


def test_tp_pool_layout(ranks, jax_engines, setup):
    """Each rank's pools (values and int8 scales) hold its own KV heads,
    the JAX pool's shards over "tp", before and after a step."""
    _, tp = jax_engines
    be = JBatch(tp, capacity=4, paged=True, page_size=8, kv_quant="int8")
    want = {name: {s.data.shape for s in arr.addressable_shards}.pop()
            for name, arr in be.cache.items()}
    for r in ranks[0]:
        before, after = r["pool_layout"]
        assert before == after == want
        assert before["k"][2] == setup["args"].kv_heads // 2


def test_tp_int8_weights_serving(ranks, setup):
    qargs = jpreset("test-tiny", quant="int8")
    want = mixed_workload(JBatch(JLlama(setup["w"], qargs), capacity=4, paged=True,
                                 page_size=8, kv_quant="int8"))
    got = mixed_workload(JBatch(JLlama(setup["w"], qargs, mesh=jmesh(dp=1, tp=2)),
                                capacity=4, paged=True, page_size=8, kv_quant="int8"))
    assert got == want
    assert _every_rank(ranks[0], "int8_weights") == want


def test_tp_chunked_admission_and_prefix_cache(ranks, jax_engines):
    solo, tp = jax_engines
    want, hits = W.prefix_workload(solo, JBatch)
    assert W.prefix_workload(tp, JBatch) == (want, hits)
    out, port_hits = _every_rank(ranks[0], "prefix")
    assert out == want and port_hits == hits > 0


def test_tp_on_dp_mesh_axis_present(ranks, setup, jax_engines):
    """A (dp, tp) = (2, 2) engine: the pools replicate over "dp" (a whole
    engine is the dp unit) and hold KVH / 2 heads; streams identical."""
    solo, _ = jax_engines
    eng = JLlama(setup["w"], jpreset("test-tiny", max_batch_size=2),
                 mesh=jmesh(dp=2, tp=2))
    want = mixed_workload(JBatch(solo, capacity=4, paged=True, page_size=8))
    assert mixed_workload(JBatch(eng, capacity=4, paged=True, page_size=8)) == want
    assert _every_rank(ranks[1], "streams") == want
    for r in ranks[1]:
        assert r["pool"][2] == setup["args"].kv_heads // 2


def test_tp_cancel_frees_pages(ranks, jax_engines):
    _, tp = jax_engines
    be = JBatch(tp, capacity=2, paged=True, page_size=8)
    r1 = be.submit([1, 5, 9], 16)
    r2 = be.submit([1, 7, 2], 16)
    be.step(quantum=2)
    assert be.cancel(r1)
    W.drain(be, [r2])
    cancelled, free_after, free_end, total, stream = _every_rank(ranks[0], "cancel")
    assert cancelled and free_end > free_after and free_end == total
    assert stream == r2.generated


def test_randomized_soak_tensor_parallel(ranks, setup):
    """tests/test_serving_soak.py's tp=2 soak: every stream equals the
    single-chip solo oracle, and no page leaks."""
    a, w = setup["soak_args"], setup["soak_w"]
    pending, streams, free = _every_rank(ranks[0], "soak")
    assert len(streams) == len(pending) == 16
    solo = JLlama(w, a)  # each generate_tokens call starts from a fresh cache
    for (p, b), got in zip(pending, streams):
        toks = np.asarray(solo.generate_tokens(np.array([p], np.int32), b))[0]
        want = []
        for t in toks.tolist():
            if t in (1, 2):
                break
            want.append(t)
        assert got == want[:b]
    assert free == 39


def test_tp_multilora_matches_single_chip(ranks, setup):
    """tests/test_multilora.py's tp=2 scenario: the adapter bank is held
    whole on every rank (each reads its slices of it) and the streams are
    the single-chip multi-LoRA engine's."""
    base = JLlama(setup["w"], setup["ml_args"])
    be = JBatch(base, capacity=3, paged=True, page_size=8, adapters=setup["adapters"])
    reqs = [be.submit([1, 5, 9, 14], 8, stop_ids=()),
            be.submit([1, 7, 2], 8, stop_ids=(), adapter=0),
            be.submit([1, 3, 8], 8, stop_ids=(), adapter=1)]
    while be.num_active:
        be.step(quantum=4)
    assert _every_rank(ranks[0], "multilora") == [r.generated for r in reqs]
    whole = {k: tuple(v.shape) for k, v in be.lora_bank["layers"].items()}
    for r in ranks[0]:
        assert r["bank_whole"] == whole


def test_tp_serving_runs_the_kernels_on_local_heads(ranks, setup, jax_engines):
    """With the kernel path on (the wrappers' plain twins on the CPU), the
    admissions call flash prefill and the steps the paged wrapper, each on
    this rank's heads, and the streams stay the JAX engine's."""
    solo, _ = jax_engines
    a = setup["args"]
    want = mixed_workload(JBatch(solo, capacity=4, paged=True, page_size=8))
    assert _every_rank(ranks[0], "kernel_path") == want
    for r in ranks[0]:
        assert r["kernel_calls"] == [("flash_prefill", a.n_heads // 2, a.kv_heads // 2),
                                     ("paged_attention", a.n_heads // 2, a.kv_heads // 2)]
