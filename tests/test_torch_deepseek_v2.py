"""DeepSeek-V2 (`llama3np_tpu_torch.models.deepseek_v2`) against the plain
float32 reference of `benchmark/reference/deepseek_v2.py` (torch alone,
outside both packages), at a small size on the CPU: D 64, 4 heads, nope 16,
rope 8, v 16, kv_lora_rank 32, 3 layers (the first dense), 8 routed experts
top-2 and 1 shared, YaRN.  Weights are seeded leaves
(`benchmark/families/deepseek_v2.py`), handed to the program fused and to
the reference split.

Tolerances.  float32: both sides compute in float32 and differ only in the
order of their sums (the absorbed decode associates the latent products
otherwise, the grouped expert product sums per expert); over 3 layers that
is a few 1e-7 of the logits' scale, so F32_TOL = 2e-5 x max(1, |logit|).
Products in bf16 move the logits by ~100x that (2e-3 over four seeds;
`test_f32_tolerance_rejects_bf16_products` asks for 20x).  bfloat16 (the served dtype):
BF16_TOL = 0.01 x max(1, |logit|), ~3x the bf16 program's widest reading
here (0.0031).  A position whose own router, in some layer, has its k-th
and (k+1)-th scores within ROUTER_TIE is held to FLIP_TOL instead: the
program rounds the router's input to bf16 (a score moves by ~4e-5 here),
so it may choose the other expert there, and that token's output then
takes another expert's share (`test_bf16_engine_within_envelope_or_router_tie`).
"""

import os

import numpy as np
import pytest
import torch

from benchmark.harness.spec import load_module
from llama3np_tpu_torch import kvcache
from llama3np_tpu_torch.models import deepseek_v2 as dsv2
from llama3np_tpu_torch.models.deepseek_v2 import BlockTimer, DeepseekV2, DeepseekV2Args
from llama3np_tpu_torch.ops import core as ops
from llama3np_tpu_torch.serving import BatchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = load_module(os.path.join(ROOT, "benchmark", "families", "deepseek_v2.py"),
                     "bench_family_deepseek_v2")
REF = load_module(os.path.join(ROOT, "benchmark", "reference", "deepseek_v2.py"),
                  "bench_reference_deepseek_v2")

PUBLISHED_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
                  "beta_fast": 32, "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}
SMALL = {"hidden_size": 64, "num_attention_heads": 4, "qk_nope_head_dim": 16,
         "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
         "num_hidden_layers": 3, "first_k_dense_replace": 1, "intermediate_size": 96,
         "moe_intermediate_size": 32, "n_routed_experts": 8, "n_shared_experts": 1,
         "num_experts_per_tok": 2, "vocab_size": 256, "max_position_embeddings": 128,
         "rope_theta": 10000, "rms_norm_eps": 1e-6, "torch_dtype": "float32",
         # original 16 positions: the ramp's two ends both fall inside 4 pairs
         "rope_scaling": {**PUBLISHED_YARN, "factor": 4, "original_max_position_embeddings": 16}}
F32_TOL = 2e-5
BF16_TOL = 0.01
FLIP_TOL = 0.05
ROUTER_TIE = 1e-3  # 25x the move of a score under a bf16 router input
SEED = 2**31 + 11


def build(dtype="float32", seed=SEED):
    dm = FAMILY.dims({**SMALL, "torch_dtype": dtype})
    dt = getattr(torch, dtype)
    tree = FAMILY.program_tree(torch, dm, seed, "cpu", dt)
    eng = DeepseekV2.from_param_tree(tree, FAMILY.program_args(dm), device="cpu")
    return eng, FAMILY.reference(torch, dm, seed, "cpu"), dm


def prompts(n, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, SMALL["vocab_size"], size=L).tolist() for L in lengths[:n]]


def scale_of(x):
    return max(1.0, float(x.abs().max()))


# -- YaRN ----------------------------------------------------------------------

def test_yarn_at_the_published_numbers():
    assert ops.yarn_correction_range(64, 1e4, PUBLISHED_YARN) == (10, 23)
    m = ops.yarn_mscale(40, 0.707)
    assert m == pytest.approx(0.1 * 0.707 * np.log(40) + 1) and m == pytest.approx(1.26080, abs=1e-5)
    args = FAMILY.program_args(FAMILY.dims({**SMALL, "qk_nope_head_dim": 128,
                                            "qk_rope_head_dim": 64,
                                            "rope_scaling": PUBLISHED_YARN}))
    assert args.softmax_scale == pytest.approx(0.114721, abs=5e-7)
    assert args.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)


@pytest.mark.parametrize("rs", [PUBLISHED_YARN, {**PUBLISHED_YARN, "mscale": 1.0},
                                SMALL["rope_scaling"]])
def test_yarn_tables_against_the_formula(rs):
    dim, n, theta = (64, 4096, 1e4) if rs["factor"] == 40 else (8, 128, 1e4)
    cos, sin = ops.rope_tables(dim, n, theta, torch.float32, scaling=rs, device="cpu")
    # The formula written out: pairs below `low` keep theta's frequencies,
    # those above `high` are divided by the factor, a ramp between.
    low, high = ops.yarn_correction_range(dim, theta, rs)
    base = 1.0 / theta ** (np.arange(0, dim, 2) / dim)
    j = np.arange(dim // 2)
    ramp = np.clip((j - low) / (high - low), 0, 1)
    inv = base * (1 - ramp) + base / rs["factor"] * ramp
    assert np.allclose(inv[j < low], base[j < low]) and np.allclose(
        inv[j > high], base[j > high] / rs["factor"])
    mag = ops.yarn_mscale(rs["factor"], rs["mscale"]) / ops.yarn_mscale(
        rs["factor"], rs["mscale_all_dim"])
    ang = np.arange(n)[:, None] * inv[None, :]
    np.testing.assert_allclose(cos.numpy(), np.cos(ang) * mag, atol=2e-6)
    np.testing.assert_allclose(sin.numpy(), np.sin(ang) * mag, atol=2e-6)
    rc, rsn = REF.rope_tables(dim, n, theta, rs, "cpu")  # the reference's own
    np.testing.assert_allclose(cos.numpy(), rc.numpy(), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), rsn.numpy(), atol=1e-6)


def test_rope_tables_without_yarn_are_unchanged():
    rs = {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
          "original_max_position_embeddings": 64}
    exps = np.arange(0, 16, 2) / 16
    inv = ops.scale_rope_inv_freq(1.0 / 500000.0 ** exps, rs)
    cos, _ = ops.rope_tables(16, 32, 500000.0, torch.float32, scaling=rs, device="cpu")
    assert torch.equal(cos, torch.from_numpy(np.cos(np.arange(32)[:, None] * inv)).float())


# -- the blocks ----------------------------------------------------------------

def test_absorbed_decode_equals_decompressed_attention():
    eng, _, _ = build()
    a, lp = eng.args, eng.params["layers"][1]
    L, page = 19, 8
    x = torch.randn(L, a.dim, generator=torch.Generator().manual_seed(3))
    want, rows = dsv2._mla_prefill(x, lp, a, eng.cos[:L], eng.sin[:L])
    # Positions 0..L-2 in pages 1-3 of a pool; the last token decodes.
    pool = torch.zeros(4, page, a.latent_dim)
    pool.view(-1, a.latent_dim)[page : page + L - 1] = rows[:-1]
    table = torch.tensor([[1, 2, 3]])
    pos = torch.tensor([L - 1])
    got = dsv2._mla_decode(x[-1:], lp, a, eng.cos[pos], eng.sin[pos], pool,
                           *eng.absorbed[1], torch.tensor([3]), torch.tensor([(L - 1) % page]),
                           table, pos)
    # The row written is the prefill's (one product row against 19: the
    # sums' order may differ in the last bit).
    torch.testing.assert_close(pool[3, (L - 1) % page], rows[-1], rtol=0, atol=1e-6)
    torch.testing.assert_close(got, want[-1:], rtol=0, atol=F32_TOL * scale_of(want))


def test_moe_routes_top_k_and_combines_unnormalized():
    eng, _, _ = build()
    a, lp = eng.args, eng.params["layers"][2]
    x = torch.randn(37, a.dim, generator=torch.Generator().manual_seed(4))
    got = dsv2._moe(x, lp, a)
    fe = a.moe_intermediate_size
    scores = torch.softmax(x @ lp["router"], dim=-1)
    want = ops.fused_ffn(x, lp["s_gu"], lp["s_down"])
    for t in range(x.shape[0]):  # every expert computed, the top k kept
        top = torch.argsort(scores[t], descending=True)[: a.num_experts_per_tok]
        for e in top.tolist():
            gu = lp["e_gu"][e] @ x[t]
            want[t] += scores[t, e] * (lp["e_down"][e] @ (torch.nn.functional.silu(gu[:fe]) * gu[fe:]))
    torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * scale_of(want))
    assert (scores.topk(2).values.sum(-1) < 1).all()  # not renormalized


def test_grouped_dot_with_an_empty_expert():
    g = torch.Generator().manual_seed(5)
    w = torch.randn(4, 6, 8, generator=g)  # rows of 16-byte multiples, as the GEMM reads
    expert = torch.tensor([0, 0, 2, 3, 3, 3])  # expert 1 takes no row
    a = torch.randn(6, 8, generator=g)
    offs = torch.cumsum(torch.bincount(expert, minlength=4), 0).to(torch.int32)
    want = torch.stack([w[e] @ a[i] for i, e in enumerate(expert.tolist())])
    torch.testing.assert_close(ops.grouped_dot(a, w, offs), want)


def test_latent_pool_layout():
    c = kvcache.init_latent_paged_cache(3, 5, 16, 576, "bfloat16", device="cpu")
    assert list(c) == ["latent"] and c["latent"].shape == (3, 5, 16, 576)
    assert c["latent"].dtype == torch.bfloat16 and not c["latent"].any()


# -- the engine against the reference -----------------------------------------

def serve(eng, plan, quantum=1, **kw):
    """Drive a paged BatchEngine through `plan` [(step index, prompt,
    max_new)], recording each request's logits in the order it was served:
    the admission's, then one a decode step.  Returns [(request, logits
    [n, VS])]."""
    be = BatchEngine(eng, capacity=3, paged=True, page_size=8, **kw)
    seen, order = {}, []
    prefill, decode = eng.prefill_paged, eng.decode_paged

    def rec_prefill(*a):
        out = prefill(*a)
        order.append(out[0])
        return out

    def rec_decode(tokens, pos, pool, table):
        out = decode(tokens, pos, pool, table)
        for slot, r in enumerate(be.slots):
            if r is not None:
                seen.setdefault(r.request_id, []).append(out[slot])
        return out

    eng.prefill_paged, eng.decode_paged = rec_prefill, rec_decode
    try:
        reqs, i = [], 0
        while len(reqs) < len(plan) or be.num_active:
            while len(reqs) < len(plan) and plan[len(reqs)][0] <= i:
                _, p, n = plan[len(reqs)]
                reqs.append(be.submit(p, n, stop_ids=()))
                seen[reqs[-1].request_id] = [order[-1]]
            be.step(quantum)
            i += 1
    finally:
        del eng.prefill_paged, eng.decode_paged
    assert be.allocator.available == be.allocator.num_pages - 1  # no page leaks
    return [(r, torch.stack(seen[r.request_id][: len(r.generated)])) for r in reqs]


def reference_logits(ref, served):
    seqs = [r.prompt_ids + r.generated[:-1] for r, _ in served]
    spans = [(len(r.prompt_ids) - 1, len(r.prompt_ids) - 1 + len(r.generated)) for r, _ in served]
    return ref.logits(seqs, spans)["float32"]


PLAN = [(0, 20, 12), (3, 13, 9), (5, 31, 8)]  # (step, prompt length, new tokens)


def plan(lengths_seed=0):
    ps = prompts(3, [L for _, L, _ in PLAN], lengths_seed)
    return [(s, p, n) for (s, _, n), p in zip(PLAN, ps)]


def test_batch_engine_decode_at_ragged_positions_matches_reference():
    eng, ref, _ = build()
    served = serve(eng, plan())
    for (r, got), want in zip(served, reference_logits(ref, served)):
        assert len(r.generated) == r.max_new_tokens and r.done
        torch.testing.assert_close(got, want, rtol=0, atol=F32_TOL * scale_of(want))
        assert got.argmax(-1).tolist() == r.generated


def test_f32_tolerance_rejects_bf16_products():
    """The f32 comparison's tolerance is tight enough that products in bf16
    (the same weights rounded, activations rounded at each product) fail
    it by far."""
    eng, ref, _ = build()
    served = serve(eng, plan())
    (r, _), = served[:1]
    seq = r.prompt_ids + r.generated[:-1]
    span = [(len(r.prompt_ids) - 1, len(seq))]
    want = ref.logits([seq], span)["float32"][0]
    mm = ref._mm
    ref._mm = lambda x, w, p: mm(x.bfloat16().float(), w.bfloat16().float(), p)
    low = ref.logits([seq], span)["float32"][0]
    assert float((low - want).abs().max()) > 20 * F32_TOL * scale_of(want)


def test_generate_tokens_is_the_reference_greedy_stream_and_the_served_one():
    eng, ref, _ = build()
    ps = prompts(2, [17, 17], seed=9)
    toks = eng.generate_tokens(ps, 10)
    assert toks.shape == (2, 10) and toks.dtype == torch.long
    for p, t in zip(ps, toks.tolist()):
        seq = p + t[:-1]
        want = ref.logits([seq], [(len(p) - 1, len(seq))])["float32"][0]
        assert want.argmax(-1).tolist() == t
    served = serve(eng, [(0, ps[0], 10)])
    assert served[0][0].generated == toks[0].tolist()
    assert eng.generate_tokens(ps[:1], 0).shape == (1, 0)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate_tokens(ps[:1], SMALL["max_position_embeddings"])


def router_margins(ref, seqs):
    """For each sequence, each position's smallest gap between the router's
    k-th and (k+1)-th score over the MoE layers, from the float32
    reference (recorded around its own `_ffn`)."""
    margins, ffn = [], ref._ffn

    def rec(x, w, p):
        if "router" in w:
            s = torch.softmax(x @ w["router"], dim=-1).sort(dim=-1, descending=True).values
            k = ref.dm["top_k"]
            margins.append(s[:, k - 1] - s[:, k])
        return ffn(x, w, p)

    ref._ffn = rec
    try:
        ref.logits(seqs, [(len(s) - 1, len(s)) for s in seqs])
    finally:
        del ref._ffn
    per_seq = len(seqs)
    return [torch.stack(margins[j::per_seq]).amin(0) for j in range(per_seq)]


def test_bf16_engine_within_envelope_or_router_tie():
    """The served dtype: a bf16 engine against the float32 reference over
    the same (bf16) weights.  Each served position is held to BF16_TOL, or
    to FLIP_TOL where its own router is at a near tie (the module
    docstring); at least half the positions are held to BF16_TOL."""
    eng, ref, _ = build("bfloat16")
    served = serve(eng, plan())
    wants = reference_logits(ref, served)
    seqs = [r.prompt_ids + r.generated[:-1] for r, _ in served]
    held = total = 0
    for (r, got), want, m in zip(served, wants, router_margins(ref, seqs)):
        L = len(r.prompt_ids)
        for j in range(len(r.generated)):
            tie = bool(m[L - 1 + j] < ROUTER_TIE)
            err = float((got[j].float() - want[j]).abs().max()) / scale_of(want[j])
            assert err <= (FLIP_TOL if tie else BF16_TOL), (r.request_id, j, tie, err)
            total += 1
            held += not tie
    assert held >= total // 2, (held, total)


# -- the serving engine's refusals ---------------------------------------------

@pytest.mark.parametrize("kw,what", [
    ({"paged": False}, "dense cache"),
    ({"kv_quant": "int8"}, "int8 latent pool"),
    ({"prefix_cache": True}, "prefix_cache"),
    ({"admit_chunk": 16}, "admit_chunk"),
    ({"adapters": [{"layers": {}}]}, "adapters"),
])
def test_batch_engine_refuses_what_is_not_built(kw, what):
    eng, _, _ = build()
    with pytest.raises(ValueError, match=what):
        BatchEngine(eng, capacity=2, **{"paged": True, **kw})


def test_quantum_above_one_a_mesh_and_other_widths_are_refused():
    eng, _, dm = build()
    be = BatchEngine(eng, capacity=2, paged=True, page_size=8)
    be.submit(prompts(1, [9])[0], 4, stop_ids=())
    with pytest.raises(ValueError, match="quantum 2"):
        be.step(2)
    tree = FAMILY.program_tree(torch, dm, 1, "cpu", torch.float32)
    with pytest.raises(ValueError, match="tensor-parallel"):
        DeepseekV2.from_param_tree(tree, FAMILY.program_args(dm), device="cpu", mesh=object())
    tree["layers"][2]["e_gu"] = tree["layers"][2]["e_gu"][:, :-1]  # a tree of other widths
    with pytest.raises(ValueError, match="layer 2"):
        DeepseekV2.from_param_tree(tree, FAMILY.program_args(dm), device="cpu")


# -- tracing -------------------------------------------------------------------

def test_block_timer_and_profiler_ranges():
    eng, _, _ = build()
    assert eng.timer is None
    p = prompts(1, [12])[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.generate_tokens([p], 3)
    names = {e.key for e in prof.key_averages()}
    assert {"deepseek_v2.mla", "deepseek_v2.moe"} <= names
    eng.timer = BlockTimer("cpu")
    eng.generate_tokens([p], 3)
    recs = eng.timer.records
    nl = eng.args.n_layers
    assert len(eng.timer.steps) == 2 and len(recs) == 3 * 2 * nl
    assert [r[2] for r in recs] == ["prefill"] * 2 * nl + ["decode"] * 4 * nl
    assert [r[1] for r in recs[: 2 * nl]] == ["deepseek_v2.mla", "deepseek_v2.moe"] * nl
    assert all(eng.timer.ms(r[3], r[4]) >= 0 for r in recs)
    assert all(a[0] <= b[0] for a, b in zip(recs, recs[1:]))


def test_args_expose_the_latent_row():
    a = DeepseekV2Args(dim=2048, n_layers=27, n_heads=16, qk_nope_head_dim=128,
                       qk_rope_head_dim=64, v_head_dim=128, kv_lora_rank=512,
                       intermediate_size=10944, moe_intermediate_size=1408,
                       n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
                       first_k_dense_replace=1, vocab_size=102400, max_seq_len=4096)
    assert a.latent_dim == 576 and a.qk_head_dim == 192
    assert a.softmax_scale == pytest.approx(192 ** -0.5)  # no YaRN: no mscale
    shapes = dsv2.layer_shapes(a, 1)
    assert shapes["e_gu"] == (64, 2816, 2048) and shapes["s_gu"] == (2048, 5632)
    assert "router" not in dsv2.layer_shapes(a, 0)
