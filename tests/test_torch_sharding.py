"""The port's tensor- and data-parallel engine (`llama3np_tpu_torch.
parallel.sharding`, `Llama(mesh=)`) against the JAX package's sharded
engine: every scenario of tests/test_sharding.py, tests/test_quant.py's
int8 and `from_quantized` over a mesh, and tests/test_int4.py's int4 over
tp=2.

The JAX side runs on the 8 virtual CPU devices of conftest.py; the port's
ranks are spawned processes under gloo on the CPU (`parallel.launch`),
two and four of them, each world spawned once for the module and running
every scenario (`torch_parallel_workers.engine_ranks`).  The same numpy
weights from a seed go to both.  fp32 logits match to rtol 2e-4 / atol
1e-4, greedy tokens are identical to the JAX sharded engine's and the
single device's, and every rank returns the same results.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu.checkpoint import (build_param_tree, permute_rope_layout,
                                     quantize_param_tree, save_quantized_npz)
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.parallel import make_mesh as jmesh
from llama3np_tpu.parallel import sharding as jsh
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.checkpoint import save_npz
from llama3np_tpu_torch.ops import core as tops
from llama3np_tpu_torch.parallel import sharding as tsh
from llama3np_tpu_torch.parallel.launch import launch

import torch_parallel_workers as W

ATOL, RTOL = 1e-4, 2e-4
MESHES = [(1, 2), (2, 1), (2, 2)]
SHARD = dict(dim=128, n_heads=8, n_kv_heads=8, vocab_size=512, max_batch_size=2)
QUANT = dict(attn_impl="xla", quant="int8", fuse_matmuls=False, max_batch_size=2)
INT4 = dict(fuse_matmuls=False, quant="int4")


def grid_weights(args, seed, qmax):
    """Synthetic weights on the int8 (qmax 127) or int4 (qmax 7) lattice
    per output channel (tests/test_quant.py, tests/test_int4.py)."""
    out = {}
    for k, v in synthetic_weights(args, seed).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 2:
            s = np.maximum(np.max(np.abs(v), axis=-1, keepdims=True) / qmax, 1e-12)
            v = (np.clip(np.rint(v / s), -qmax, qmax) * s).astype(np.float32)
        out[k] = v
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharding")
    args = jpreset("test-tiny", **SHARD)
    w = synthetic_weights(args, seed=5)
    rng = np.random.default_rng(42)
    ids = rng.integers(3, args.vocab_size, size=(2, 8)).astype(np.int32)
    gen = rng.integers(3, args.vocab_size, size=(2, 6)).astype(np.int32)
    state = str(d / "state.npz")
    ckpt = str(d / "ckpt.npz")
    save_npz(w, ckpt)
    qargs = jpreset("test-tiny", **QUANT)
    wq = grid_weights(qargs, 5, 127)
    qids = rng.integers(3, qargs.vocab_size, size=(2, 5)).astype(np.int32)
    qpath = str(d / "q8.npz")
    save_quantized_npz(quantize_param_tree(
        permute_rope_layout(build_param_tree(wq, qargs), qargs)), qpath)
    args4 = jpreset("test-tiny", **INT4)
    w4 = grid_weights(args4, 7, 7)
    ids4 = rng.integers(3, args4.vocab_size, size=(1, 6)).astype(np.int32)
    return dict(args=args, w=w, ids=ids, gen=gen, ckpt=ckpt, state=state, qargs=qargs, wq=wq,
                qids=qids, qpath=qpath, args4=args4, w4=w4, ids4=ids4)


def _scenarios(s, world):
    targs = tpreset("test-tiny", **SHARD)
    tq = tpreset("test-tiny", **QUANT)
    if world == 2:
        return [
            dict(name="1x2", dp=1, tp=2, args=targs, weights=s["w"], ids=s["ids"],
                 gen=(s["gen"], 8)),
            dict(name="2x1", dp=2, tp=1, args=targs, weights=s["w"], ids=s["ids"],
                 gen=(s["gen"], 8)),
            dict(name="stream_1x2", dp=1, tp=2, args=targs, streamed=s["ckpt"],
                 ids=s["ids"]),
            dict(name="int4_1x2", dp=1, tp=2, args=tpreset("test-tiny", **INT4),
                 weights=s["w4"], gen=(s["ids4"], 8)),
            dict(name="kernels_1x2", dp=1, tp=2, args=targs, weights=s["w"],
                 ids=s["ids"], gen=(s["gen"], 4), kernels=True),
        ]
    return [
        dict(name="2x2", dp=2, tp=2, args=targs, weights=s["w"], ids=s["ids"],
             gen=(s["gen"], 8), state=s["state"]),
        dict(name="stream_2x2", dp=2, tp=2, args=targs, streamed=s["ckpt"], ids=s["ids"]),
        dict(name="int8_2x2", dp=2, tp=2, args=tq, weights=s["wq"], ids=s["qids"],
             gen=(s["qids"], 8)),
        dict(name="qckpt_2x2", dp=2, tp=2, args=tq, quantized=s["qpath"],
             gen=(s["qids"], 8)),
    ]


def _spawn(setup, world):
    refusals = []
    if world == 2:
        refusals = [(tpreset("test-tiny-mha"), 1, 2),              # kv_heads 3
                    (tpreset("test-tiny", vocab_size=511), 1, 2)]  # vocab 511
    return launch(W.engine_ranks, world, (_scenarios(setup, world), refusals),
                  backend="gloo", devices=["cpu"] * world, timeout_s=300)


@pytest.fixture(scope="module")
def ranks(setup):
    """{world: [rank 0's results, rank 1's, ...]}: one spawn a world."""
    return {2: _spawn(setup, 2), 4: _spawn(setup, 4)}


def _same_on_every_rank(results, name, key):
    first = results[0][name][key]
    for r in results[1:]:
        np.testing.assert_array_equal(np.asarray(r[name][key]), np.asarray(first))
    return first


def _jax_shard_shapes(engine) -> dict:
    out = {}
    for k, v in engine.params.items():
        leaves = v.items() if isinstance(v, dict) else [(None, v)]
        for kk, leaf in leaves:
            shapes = {s.data.shape for s in leaf.addressable_shards}
            assert len(shapes) == 1
            out[k if kk is None else f"{k}.{kk}"] = shapes.pop()
    return out


def test_validate_tp(setup, ranks):
    jsh.validate_tp(setup["args"], jmesh(1, 4))
    want = []
    for bad in (jpreset("test-tiny-mha"), jpreset("test-tiny", vocab_size=511)):
        with pytest.raises(ValueError) as e:
            jsh.validate_tp(bad, jmesh(1, 2))
        want.append(str(e.value))
    for r in ranks[2]:
        assert r["refusals"] == want


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_forward_matches_jax(setup, ranks, dp, tp):
    name = f"{dp}x{tp}"
    got = _same_on_every_rank(ranks[dp * tp], name, "logits")
    want = JLlama(setup["w"], setup["args"], mesh=jmesh(dp, tp))(setup["ids"], 0)
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert_allclose(got, JLlama(setup["w"], setup["args"])(setup["ids"], 0),
                    rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_sharded_generate_token_identity(setup, ranks, dp, tp):
    got = _same_on_every_rank(ranks[dp * tp], f"{dp}x{tp}", "tokens")
    single = np.asarray(JLlama(setup["w"], setup["args"]).generate_tokens(setup["gen"], 8))
    sharded = JLlama(setup["w"], setup["args"], mesh=jmesh(dp, tp))
    assert got == np.asarray(sharded.generate_tokens(setup["gen"], 8)).tolist()
    assert got == single.tolist()


def test_generation_state_over_a_mesh(setup, ranks, tmp_path):
    """A (2, 2) engine saves the whole cache of its generation (rank 0
    writes it) and resumes from it: the file is the JAX single-device
    engine's, and the resumed tokens are that engine's."""
    solo = JLlama(setup["w"], setup["args"])
    solo.generate_tokens(setup["gen"], 8)
    path = str(tmp_path / "jax_state.npz")
    solo.save_generation_state(path)
    want = np.asarray(solo.resume_generate(path, 4)).tolist()
    assert _same_on_every_rank(ranks[4], "2x2", "resumed") == want
    ours, theirs = np.load(setup["state"]), np.load(path)
    assert int(ours["pos"]) == int(theirs["pos"])
    np.testing.assert_array_equal(ours["last_tokens"], theirs["last_tokens"])
    pos = int(ours["pos"])  # rows past it were never attended (nor are alike)
    for k in ("cache_k", "cache_v"):
        assert_allclose(ours[k][..., :pos, :], theirs[k][..., :pos, :], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_param_layout(setup, ranks, dp, tp):
    """Every leaf's shard shape on every rank is the JAX shard's; the
    dense cache holds this rank's dp rows and KV heads."""
    want = _jax_shard_shapes(JLlama(setup["w"], setup["args"], mesh=jmesh(dp, tp)))
    a = setup["args"]
    for r in ranks[dp * tp]:
        res = r[f"{dp}x{tp}"]
        assert {k: s for k, (s, _) in res["shapes"].items()} == want
        assert res["cache"] == (a.n_layers, a.max_batch_size // dp, a.kv_heads // tp,
                                a.max_seq_len, a.head_dim)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_streaming_sharded_load_matches_dense(setup, ranks, dp, tp):
    """from_sharded_checkpoint reads each rank's slices (the ranks bar
    whole-member reads of the .npz) and equals the in-memory load."""
    a, w = setup["args"], setup["w"]
    res = ranks[dp * tp]
    np_wq = np.stack([w[f"model.layers.{i}.self_attn.q_proj.weight"].T
                      for i in range(a.n_layers)])
    for r in res:
        t = r["stream_" + f"{dp}x{tp}"]
        j = r["stream_" + f"{dp}x{tp}"]["coords"]["tp"]
        n = np_wq.shape[-1] // tp
        assert_allclose(t["wq"], np_wq[..., j * n:(j + 1) * n])
    got = _same_on_every_rank(res, f"stream_{dp}x{tp}", "logits")
    want = JLlama.from_sharded_checkpoint(setup["ckpt"], a, jmesh(dp, tp))(setup["ids"], 0)
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert_allclose(got, JLlama(w, a)(setup["ids"], 0), rtol=RTOL, atol=ATOL)


def test_sharded_load_reads_compressed_members(setup, tmp_path):
    """A compressed .npz has no memmap view: its members are decompressed
    when first read, and the shards are the same."""
    from llama3np_tpu_torch.checkpoint import save_npz as tsave

    class Rank1of2:  # tensor-parallel rank 1 of 2, without a process group
        device = torch.device("cpu")

        def size(self, axis):
            return 2 if axis == "tp" else 1

        def index(self, axis):
            return 1 if axis == "tp" else 0

    path = str(tmp_path / "z.npz")
    tsave(setup["w"], path, compressed=True)
    args = tpreset("test-tiny", **SHARD)
    plain = tsh.load_param_tree_sharded(setup["ckpt"], args, Rank1of2())
    packed = tsh.load_param_tree_sharded(path, args, Rank1of2())
    for k in ("tok_embedding", "lm_head", "norm"):
        assert torch.equal(plain[k], packed[k])
    for k, v in plain["layers"].items():
        assert torch.equal(v, packed["layers"][k])
    n = args.vocab_size // 2
    np.testing.assert_array_equal(plain["tok_embedding"].numpy(),
                                  setup["w"]["model.embed_tokens.weight"][n:])


def test_int8_tensor_parallel_matches_single_chip(setup, ranks):
    """int8 on a (2, 2) mesh: scale leaves shard with their weights, logits
    and greedy tokens are the JAX sharded and single-device engines'."""
    qargs, wq, ids = setup["qargs"], setup["wq"], setup["qids"]
    res = ranks[4]
    solo = JLlama(wq, qargs)
    tp = JLlama(wq, qargs, mesh=jmesh(2, 2))
    got = _same_on_every_rank(res, "int8_2x2", "logits")
    assert_allclose(got, tp(ids, 0), rtol=RTOL, atol=ATOL)
    assert_allclose(got, solo(ids, 0), rtol=RTOL, atol=ATOL)
    solo.reset(), tp.reset()
    toks = _same_on_every_rank(res, "int8_2x2", "tokens")
    assert toks == np.asarray(solo.generate_tokens(ids, 8)).tolist()
    assert toks == np.asarray(tp.generate_tokens(ids, 8)).tolist()
    want = _jax_shard_shapes(tp)
    for r in res:
        shapes = r["int8_2x2"]["shapes"]
        assert {k: s for k, (s, _) in shapes.items()} == want
        assert shapes["layers.wq"][1] == "torch.int8"
        assert shapes["layers.wq_scale"][0][-1] == want["layers.wq_scale"][-1]


def test_quantized_checkpoint_over_mesh(setup, ranks):
    qargs, ids = setup["qargs"], setup["qids"]
    want = np.asarray(JLlama(setup["wq"], qargs).generate_tokens(ids, 8)).tolist()
    jtp = JLlama.from_quantized(setup["qpath"], qargs, mesh=jmesh(2, 2))
    assert np.asarray(jtp.generate_tokens(ids, 8)).tolist() == want
    assert _same_on_every_rank(ranks[4], "qckpt_2x2", "tokens") == want


def test_int4_tensor_parallel_matches_single_chip(setup, ranks):
    """int4 over tp=2: codes packed two a byte along each column shard."""
    a4, w4, ids = setup["args4"], setup["w4"], setup["ids4"]
    want = np.asarray(JLlama(w4, a4).generate_tokens(ids, 8)).tolist()
    jtp = JLlama(w4, a4, mesh=jmesh(1, 2))
    assert np.asarray(jtp.generate_tokens(ids, 8)).tolist() == want
    assert _same_on_every_rank(ranks[2], "int4_1x2", "tokens") == want
    jshapes = _jax_shard_shapes(jtp)
    for r in ranks[2]:
        shapes = r["int4_1x2"]["shapes"]
        for name in ("layers.wq", "layers.w_gate", "lm_head"):  # column shards
            assert shapes[name] == ((*jshapes[name][:-1], jshapes[name][-1] // 2),
                                    "torch.uint8")
        for name in ("layers.wo", "layers.w_down"):  # row shards
            assert shapes[name][0] == (*jshapes[name][:-1], jshapes[name][-1] // 2)


def test_sharded_engines_run_the_kernels_on_local_heads(setup, ranks):
    """The JAX sharded engine turns its Pallas kernels off (GSPMD cannot
    split a pallas_call); the port's ranks call the flash and paged
    wrappers (their plain twins on the CPU) on their own heads: NH/tp
    query heads over KVH/tp KV heads, the GQA group unchanged."""
    a = setup["args"]
    for r in ranks[2]:
        res = r["kernels_1x2"]
        assert res["kernel_calls"] == [("flash_prefill", a.n_heads // 2, a.kv_heads // 2),
                                       ("paged_attention", a.n_heads // 2, a.kv_heads // 2)]
        assert_allclose(res["logits"], r["1x2"]["logits"], rtol=RTOL, atol=ATOL)
        assert res["tokens"] == [t[:4] for t in r["1x2"]["tokens"]]
    assert ranks[2][0]["kernels_1x2"]["served"] == ranks[2][1]["kernels_1x2"]["served"]


def test_specs_match_jax(setup):
    def tup(p):
        return tuple(p)

    for quant in (False, True):
        jspecs = jsh.param_pspecs(setup["args"], quant=quant)
        tspecs = tsh.param_pspecs(tpreset("test-tiny", **SHARD), quant=quant)
        assert set(tspecs) == set(jspecs)
        for k, v in jspecs.items():
            if isinstance(v, dict):
                assert {kk: tup(vv) for kk, vv in v.items()} == tspecs[k]
            else:
                assert tup(v) == tspecs[k]
    assert {k: tup(v) for k, v in jsh.cache_pspecs().items()} == tsh.cache_pspecs()
    assert tup(jsh.activation_pspec()) == tsh.activation_pspec()
    cache = {"k": np.zeros((2, 3, 4, 8, 16)), "k_s": np.zeros((2, 3, 4, 8))}
    assert {k: tup(v) for k, v in jsh.serving_cache_pspecs(cache).items()} == \
        tsh.serving_cache_pspecs(cache)


def test_row_sharded_products_reduce_before_the_scale():
    """The rounding point: a row-sharded int8 product sums its f32 partial
    over "tp" first, then post-scales (reduce, then scale), then the
    caller rounds; the hook sees the unscaled f32 partial."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 3, 8, generator=g)
    w8 = torch.randint(-127, 128, (8, 5), generator=g, dtype=torch.int8)
    s = torch.rand(1, 5, generator=g)
    seen = []

    def reduce(t):
        seen.append(t.clone())
        return t * 2.0  # stands for the sum over two ranks of equal partials

    out = tops._scaled_dot(a, w8, s, reduce)
    partial = torch.matmul(a, w8.float())
    assert torch.equal(seen[0], partial)
    assert torch.equal(out, (partial * 2.0) * s)
    w_down = torch.randint(-127, 128, (5, 8), generator=g, dtype=torch.int8)
    swi = tops.swiglu(a, w8, w8, w_down, s, s, torch.rand(1, 8, generator=g),
                      reduce=reduce)
    assert swi.dtype == a.dtype and len(seen) == 2 and seen[1].dtype == torch.float32


def test_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="default process group"):
        tsh.make_mesh(1, 2, backend="gloo", device="cpu")


def test_multihost_mesh_branches(monkeypatch):
    """make_multihost_mesh's rules with the JAX package's messages (TP
    inside one node, DP across nodes, each node covered), faking a group of
    8 ranks in 2 nodes of 4 (torchrun's LOCAL_WORLD_SIZE)."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    calls = []
    monkeypatch.setattr(tsh, "make_mesh",
                        lambda dp, tp, backend, device: calls.append((dp, tp)) or "mesh")
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "local_device_count", lambda: 4)
    for dp, tp in ((1, 8), (3, 2), (2, 2)):
        with pytest.raises(ValueError) as want:
            jsh.make_multihost_mesh(dp=dp, tp=tp)
        with pytest.raises(ValueError) as got:
            tsh.make_multihost_mesh(dp=dp, tp=tp, backend="nccl", device="cuda:0")
        assert str(got.value) == str(want.value)
    assert tsh.make_multihost_mesh(dp=4, tp=2, backend="nccl", device="cuda:0") == "mesh"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")  # one node: the flat mesh
    assert tsh.make_multihost_mesh(dp=2, tp=4, backend="nccl", device="cuda:0") == "mesh"
    assert calls == [(4, 2), (2, 4)]
