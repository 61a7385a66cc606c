"""Multi-LoRA serving: the port's `BatchEngine(adapters=...)` against the
JAX package's (CPU).

Every single-device scenario of tests/test_multilora.py runs through both
engines on the same weights with the same adapters (the JAX trees carried
across with `lora_from_jax`): the served greedy streams must be equal to
the JAX engine's and to a solo engine over `merge_lora(base, adapter)`;
co-tenants with different adapters stay isolated in one ragged step; a
slot keeps no adapter across requests; chunked admission prefills through
the adapter; sampled adapter streams equal JAX's for the same seed;
adapters serve over an int4 base.  Then the server's adapter routing
against the JAX server's answers, and the fused-to-split view that
`chip_smoke.py` serves adapters over.
"""

import dataclasses
import http.client
import json

import jax
import numpy as np
import pytest
import torch

from llama3np_tpu import lora as jlora
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu.checkpoint import build_param_tree as jbuild
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.server import serve as jserve
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import lora as tlora
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.checkpoint import param_tree_to_weights
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.server import serve
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)

TARGETS = ("wq", "wv", "w_gate", "w_down")  # attention and FFN callbacks both


def make_adapter(args, seed, rank=4):
    """tests/test_multilora.py's adapter: init_lora with B redrawn
    non-zero (B = 0 would make the adapted model the base)."""
    lora = jlora.init_lora(args, rank=rank, alpha=8.0, seed=seed, targets=TARGETS)
    key = jax.random.PRNGKey(seed + 100)
    ly = dict(lora["layers"])
    for name in list(ly):
        if name.endswith("_b"):
            key, sub = jax.random.split(key)
            ly[name] = 0.05 * jax.random.normal(sub, ly[name].shape, ly[name].dtype)
    return {**lora, "layers": ly}


class Setup:
    def __init__(self, name):
        self.args = jpreset(name, fuse_matmuls=False, dtype="float32")
        self.targs = tpreset(name, fuse_matmuls=False, dtype="float32")
        self.weights = synthetic_weights(self.args, seed=7)
        self.jads = [make_adapter(self.args, seed=1), make_adapter(self.args, seed=2)]
        self.tads = [tlora.lora_from_jax(a, "cpu") for a in self.jads]
        self.jbase = JLlama(self.weights, self.args)
        self.tbase = Llama(self.weights, self.targs, device="cpu")
        # Solo oracles: each adapter merged into the base tree, round-tripped
        # to the HF schema, booted fresh.
        tree = jbuild(self.weights, self.args)
        self.merged = [Llama(param_tree_to_weights(tlora.merge_lora(tree, ad), self.targs),
                             self.targs, device="cpu") for ad in self.tads]

    def both(self):
        """(BatchEngine, engine, adapters) of each package."""
        return ((JBatchEngine, self.jbase, self.jads), (BatchEngine, self.tbase, self.tads))


@pytest.fixture(scope="module")
def ml():
    return Setup("test-tiny")


@pytest.fixture(scope="module")
def ml_mha():
    return Setup("test-tiny-mha")


@pytest.fixture(params=["ml", "ml_mha"])
def each(request):
    """Both presets (GQA and MHA), for the scenarios that carry the rest."""
    return request.getfixturevalue(request.param)


def solo(engine, prompt, n):
    return np.asarray(engine.generate_tokens(np.asarray([prompt]), n))[0].tolist()


def serve_stream(BE, engine, adapters, prompt, n, adapter, quantum=4, **kw):
    be = BE(engine, capacity=4, paged=True, page_size=8, adapters=adapters, **kw)
    req = be.submit(prompt, n, stop_ids=(), adapter=adapter)
    while not req.done:
        be.step(quantum=quantum)
    return req.generated


@pytest.mark.parametrize("quantum", [1, 4])
def test_adapter_matches_jax_and_merged_solo(each, quantum):
    prompt = [1, 5, 9, 14]
    for i in (0, 1):
        want = solo(each.merged[i], prompt, 10)
        got = [serve_stream(BE, eng, ads, prompt, 10, i, quantum)
               for BE, eng, ads in each.both()]
        assert got[1] == got[0] == want, i


def test_no_adapter_matches_base(ml):
    prompt = [1, 5, 9, 14]
    got = [serve_stream(BE, eng, ads, prompt, 10, None) for BE, eng, ads in ml.both()]
    assert got[1] == got[0] == solo(ml.tbase, prompt, 10)


@pytest.mark.parametrize("paged", [False, True])
def test_mixed_adapters_one_batch_isolated(each, paged):
    """Three co-tenants (base, adapter 0, adapter 1) decode in one ragged
    step each quantum; each stream equals its solo oracle and JAX's."""
    ml = each
    prompts = [[1, 5, 9, 14], [1, 7, 2], [1, 3, 3, 8, 2]]
    out = []
    for BE, eng, ads in ml.both():
        be = BE(eng, capacity=4, paged=paged, page_size=8, adapters=ads)
        reqs = [be.submit(prompts[0], 10, stop_ids=()),
                be.submit(prompts[1], 10, stop_ids=(), adapter=0),
                be.submit(prompts[2], 10, stop_ids=(), adapter=1)]
        while be.num_active:
            be.step(quantum=4)
        out.append([r.generated for r in reqs])
    assert out[1] == out[0]
    assert out[1] == [solo(ml.tbase, prompts[0], 10), solo(ml.merged[0], prompts[1], 10),
                      solo(ml.merged[1], prompts[2], 10)]


def test_slot_reuse_no_adapter_leak(ml):
    """A base request seated in the slot an adapter request just left must
    not decode through the stale adapter."""
    out = []
    for BE, eng, ads in ml.both():
        be = BE(eng, capacity=1, paged=True, page_size=8, adapters=ads)
        r1 = be.submit([1, 7, 2], 4, stop_ids=(), adapter=1)
        while not r1.done:
            be.step(quantum=2)
        assert be.adapter_ids.tolist() == [0]
        r2 = be.submit([1, 5, 9, 14], 10, stop_ids=())  # the same slot, base model
        while not r2.done:
            be.step(quantum=2)
        out.append((r1.generated, r2.generated))
    assert out[1] == out[0]
    assert out[1][1] == solo(ml.tbase, [1, 5, 9, 14], 10)


def test_chunked_admission_with_adapter(ml):
    prompt = [1] + list(range(3, 21))  # 19 tokens: three chunks of 8
    got = []
    for BE, eng, ads in ml.both():
        be = BE(eng, capacity=2, paged=True, page_size=8, admit_chunk=8, adapters=ads)
        other = be.submit([1, 5, 9], 12, stop_ids=(), adapter=1)  # a co-tenant decodes
        req = be.submit(prompt, 8, stop_ids=(), adapter=0)        # between the chunks
        while not (req.done and other.done):
            be.step(quantum=2)
        got.append((req.generated, other.generated))
    assert got[1] == got[0]
    assert got[1][0] == solo(ml.merged[0], prompt, 8)
    assert got[1][1] == solo(ml.merged[1], [1, 5, 9], 12)


def test_validation(ml):
    """The same refusals, with the same messages, in both packages."""
    def errors(BE, eng, ads, bad):
        out = []
        be = BE(eng, capacity=2, adapters=ads)
        for call in (lambda: be.submit([1, 2], 4, adapter=2),
                     lambda: be.submit([1, 2], 4, adapter=-1),
                     lambda: BE(eng, capacity=2).submit([1, 2], 4, adapter=0),
                     lambda: BE(eng, capacity=2, paged=True, page_size=8,
                                prefix_cache=True, adapters=ads),
                     lambda: BE(eng, capacity=2, adapters=[ads[0], bad])):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        return out

    jbad = jlora.init_lora(ml.args, rank=2, alpha=4.0)
    tbad = tlora.lora_from_jax(jbad, "cpu")
    want = errors(JBatchEngine, ml.jbase, ml.jads, jbad)
    got = errors(BatchEngine, ml.tbase, ml.tads, tbad)
    assert got == want
    assert "adapter must be in" in got[0] and "without adapters" in got[2]
    assert "prefix_cache" in got[3] and "rank" in got[4]
    fused = Llama(ml.weights, ml.targs.replace(fuse_matmuls=True), device="cpu")
    with pytest.raises(ValueError, match="split layout"):
        BatchEngine(fused, capacity=2, adapters=ml.tads)


@pytest.mark.parametrize("quantum", [1, 2])
def test_sampled_adapter_stream_matches_jax(ml, quantum):
    """Sampling composes with adapters: the port's stream is the JAX
    engine's for the same seed, whatever the quantum."""
    out = []
    for BE, eng, ads in ml.both():
        be = BE(eng, capacity=2, adapters=ads, sampling_seed=5)
        r = be.submit([1, 5, 9], 8, stop_ids=(), temperature=0.9, adapter=1)
        while not r.done:
            be.step(quantum=quantum)
        out.append(r.generated)
    assert out[1] == out[0]


def test_adapters_over_int4_base(ml):
    """Adapters compose with an int4 base (deltas add after the dequantizing
    post-scale): the streams equal the JAX int4 engine's, and the adapter
    shows."""
    q = {"j": JLlama(ml.weights, dataclasses.replace(ml.args, quant="int4")),
         "t": Llama(ml.weights, ml.targs.replace(quant="int4"), device="cpu")}
    prompt = [1, 5, 9, 14]
    streams = {}
    for key, BE, ads in (("j", JBatchEngine, ml.jads), ("t", BatchEngine, ml.tads)):
        streams[key] = [serve_stream(BE, q[key], ads, prompt, 10, a) for a in (None, 0)]
    assert streams["t"] == streams["j"]
    assert streams["t"][1] != streams["t"][0]


def test_forward_ragged_decode_rows_through_the_bank(ml):
    """One ragged step with a row per bank slot: each row's logits equal
    that row's step through its merged solo engine's weights."""
    from llama3np_tpu_torch.kvcache import init_cache
    from llama3np_tpu_torch.models.llama import forward_ragged_decode
    bank = tlora.stack_adapters(ml.tads, ml.targs, rope_split=ml.tbase.cfg.rope_split)
    toks = torch.tensor([5, 9, 14], dtype=torch.int32)
    pos = torch.zeros(3, dtype=torch.int32)
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    got, _ = forward_ragged_decode(ml.tbase.params, toks, pos, init_cache(ml.targs, 3, device="cpu"),
                                   ml.tbase.cos, ml.tbase.sin, ml.tbase.cfg, lora=bank,
                                   adapter_ids=ids)
    for b, eng in enumerate([ml.tbase] + ml.merged):
        want, _ = forward_ragged_decode(eng.params, toks, pos, init_cache(ml.targs, 3, device="cpu"),
                                        eng.cos, eng.sin, eng.cfg)
        torch.testing.assert_close(got[b], want[b], rtol=2e-4, atol=1e-4)


def test_split_view_equals_a_split_build():
    """`Llama.split_view` (chip_smoke.py's multi-LoRA engine over the loaded
    fused tree): views of wqkv/wgu, no copy, the split build's tensors and
    streams, and adapters serve over it."""
    for dtype in ("float32", "bfloat16"):
        args = tpreset("test-tiny", dtype=dtype)
        w = synthetic_weights(jpreset("test-tiny"), seed=7)
        fused = Llama(w, args, device="cpu")
        view = fused.split_view()
        built = Llama(w, args.replace(fuse_matmuls=False), device="cpu")
        assert not view.cfg.fused and view.args.fuse_matmuls is False and fused.cfg.fused
        assert view.cfg == built.cfg
        for k, v in built.params["layers"].items():
            assert torch.equal(view.params["layers"][k], v), k
        assert view.params["layers"]["wq"].untyped_storage().data_ptr() == \
            fused.params["layers"]["wqkv"].untyped_storage().data_ptr()
        assert solo(view, [1, 5, 9, 14], 8) == solo(built, [1, 5, 9, 14], 8)
    ads = [tlora.lora_from_jax(make_adapter(jpreset("test-tiny"), seed=1), "cpu")]
    f32 = Llama(w, tpreset("test-tiny"), device="cpu")
    got = serve_stream(BatchEngine, f32.split_view(), ads, [1, 5, 9, 14], 8, 0)
    want = serve_stream(BatchEngine, Llama(w, tpreset("test-tiny", fuse_matmuls=False),
                                           device="cpu"), ads, [1, 5, 9, 14], 8, 0)
    assert got == want
    with pytest.raises(ValueError, match="fused float tree"):
        Llama(w, tpreset("test-tiny", quant="int8"), device="cpu").split_view()


# ---------------------------------------------------------------------------
# the server's adapter routing
# ---------------------------------------------------------------------------

def _post(srv, path, body):
    host, port = srv.server_address
    c = http.client.HTTPConnection(host, port, timeout=300)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    out.pop("id", None)
    return r.status, out


@pytest.fixture(scope="module")
def servers():
    ml = Setup("test-tiny")
    names = ["alpha", "beta"]
    kw = dict(capacity=4, paged=True, page_size=8)
    js = jserve(JBatchEngine(ml.jbase, adapters=ml.jads, **kw), port=0, quantum=2,
                adapter_names=names)
    ts = serve(BatchEngine(ml.tbase, adapters=ml.tads, **kw), port=0, quantum=2,
               adapter_names=names)
    yield ml, js, ts
    for s in (js, ts):
        s.shutdown()
        s.loop.shutdown()
        s.server_close()


@pytest.mark.parametrize("adapter", [None, 0, 1, "alpha", "beta", "gamma", 2, "1", [0]])
def test_server_adapter_routing_matches_jax(servers, adapter):
    """Completions naming an adapter by index or name get the JAX server's
    answers (a name it does not know, an index out of range and a value of
    neither kind a 400 with its error); the served ids are the merged solo
    engine's."""
    ml, js, ts = servers
    body = {"prompt_ids": [1, 5, 9, 14], "max_tokens": 6, "stop_ids": []}
    if adapter is not None:
        body["adapter"] = adapter
    want = _post(js, "/v1/completions", body)
    got = _post(ts, "/v1/completions", body)
    for out in (got[1], want[1]):
        out.pop("created", None)
    assert got == want
    idx = {None: None, 0: 0, 1: 1, "alpha": 0, "beta": 1}.get(
        adapter if not isinstance(adapter, list) else "x", "bad")
    if idx == "bad":
        assert got[0] == 400
    else:
        eng = ml.tbase if idx is None else ml.merged[idx]
        assert got[1]["choices"][0]["token_ids"] == solo(eng, [1, 5, 9, 14], 6)
