"""The DeepSeek-V2 family (`benchmark/families/deepseek_v2.py`): its dims
and work counts pinned at the published DeepSeek-V2-Lite configuration,
the keys it refuses, the reference's fp8 control judged not correct at a
bf16 configuration of the block's shape, a tiny configuration run end to
end on the CPU through `dsv2lite.longdoc`'s driver (sound, with a fault
underneath, and with the program's model module missing, as on a checkout
that predates it), and the block-timer readers on a program without the
timer."""

import io
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import blocks, check, runner
from benchmark.harness.spec import Spec

from .conftest import make_root

CELL = "dsv2lite.longdoc"
TINY_V2 = {"family": "deepseek_v2", "hidden_size": 64, "num_attention_heads": 4,
           "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
           "kv_lora_rank": 32, "num_hidden_layers": 3, "first_k_dense_replace": 1,
           "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
           "n_shared_experts": 1, "num_experts_per_tok": 2, "vocab_size": 512,
           "max_position_embeddings": 256, "rope_theta": 10000, "rms_norm_eps": 1e-6,
           "torch_dtype": "float32", "q_lora_rank": None, "scoring_func": "softmax",
           "topk_method": "greedy", "norm_topk_prob": False, "n_group": 1,
           "rope_scaling": {"type": "yarn", "factor": 4, "original_max_position_embeddings": 64,
                            "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                            "mscale_all_dim": 0.707}}


def family():
    return Spec().family("deepseek_v2")


def published():
    return Spec().config("deepseek-v2-lite")


# -- dims and counts at the published configuration ---------------------------

def test_dims_at_the_published_config():
    dm = family().dims(published())
    assert Spec().workload(CELL)["family"] == "deepseek_v2"
    assert tuple(dm)[:19] == (27, 2048, 16, 128, 64, 128, 512, 10944, 1408, 64, 2, 6, 1,
                              102400, 4096, 10000.0,
                              (("beta_fast", 32), ("beta_slow", 1), ("factor", 40),
                               ("mscale", 0.707), ("mscale_all_dim", 0.707),
                               ("original_max_position_embeddings", 4096), ("type", "yarn")),
                              1.0, 1e-6)
    assert dm.dtype == "bfloat16" and dm.qk == 192 and dm.latent == 576


def test_counts_at_the_published_config():
    fam = family()
    dm = fam.dims(published())
    assert fam.product_params(dm) == 2_451_308_544  # the issue's active product parameters
    assert fam.attention_params(dm) == 13_762_560
    assert fam.ffn_params(dm, 0) == 67_239_936 and fam.ffn_params(dm, 1) == 69_337_088
    ctxs = [1, 777, 2048, 4096]
    per_ctx = 2 * 27 * 16 * (192 + 128)
    assert fam.decode_flops(dm, ctxs) == 2.0 * 2_451_308_544 * 4 + per_ctx * sum(ctxs)
    layers = 2_451_308_544 - 2048 * 102400
    for L in (1, 777, 3072):
        assert fam.prefill_flops(dm, L) == (2.0 * (layers * L + 2048 * 102400)
                                            + per_ctx * L * (L + 1) / 2)
    # no kernel of the program runs whose roofline a metric reads
    for name in ("paged_attention_bytes", "paged_attention_flops", "decode_layers_bytes"):
        assert not hasattr(fam, name)


def test_leaf_shapes_are_the_programs():
    from llama3np_tpu_torch.models.deepseek_v2 import layer_shapes

    fam = family()
    dm = fam.dims(TINY_V2)
    args = fam.program_args(dm)
    tree = fam.program_tree(torch, dm, 3, "cpu", torch.float32)
    for i, lp in enumerate(tree["layers"]):
        assert {k: tuple(v.shape) for k, v in lp.items()} == layer_shapes(args, i)


@pytest.mark.parametrize("extra", [
    {"q_lora_rank": 1536}, {"scoring_func": "sigmoid"}, {"topk_method": "group_limited_greedy"},
    {"topk_method": "noaux_tc"}, {"norm_topk_prob": True}, {"n_group": 8},
    {"rope_scaling": {"type": "linear", "factor": 2.0}}, {"hidden_act": "gelu"},
    {"moe_layer_freq": 2}])
def test_dims_refuse_what_the_block_does_not_compute(extra):
    with pytest.raises(ValueError):
        family().dims({**published(), **extra})


# -- whole runs on the CPU ------------------------------------------------------

def run(root, trace=0, seconds=1.5, seed=2**31 + 29):
    out = io.StringIO()
    rc = runner.run(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], root=root, device="cpu", out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def v2_root(tmp_path):
    return make_root(tmp_path, TINY_V2)


def test_sound_run_is_correct(v2_root):
    rc, line = run(v2_root)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "output_tok_s.longdoc"}
    assert line["checks"]["logit_gap"]["value"] <= 1e-3
    assert line["pool"]["pages"] == 4 * 256 // 16  # capacity x max pages


def test_traced_run_reads_the_block_timer(v2_root):
    rc, line = run(v2_root, trace=1)
    assert rc == 0 and line["correct"] is True
    m = line["metrics"]
    assert set(m) == {"mla_ms.dsv2lite", "moe_ms.dsv2lite", "step_mfu.dsv2lite"}
    assert all(v["value"] > 0 for v in m.values())


def altered_token(monkeypatch):
    """Row 0's token altered where the step produces it."""
    from llama3np_tpu_torch.models.deepseek_v2 import DeepseekV2
    real = DeepseekV2.decode_paged

    def step(self, *a):
        logits = real(self, *a).clone()
        logits[0, (logits[0].argmax() + 1) % logits.shape[-1]] = logits[0].max() + 1.0
        return logits
    monkeypatch.setattr(DeepseekV2, "decode_paged", step)


def test_an_altered_token_is_caught(v2_root, monkeypatch):
    altered_token(monkeypatch)
    rc, line = run(v2_root)
    assert rc == 0 and line["correct"] is False


def test_a_program_without_the_model_fails_at_once(v2_root, monkeypatch):
    """A checkout that predates the model: the run stops before any weight
    is made, with no result line."""
    monkeypatch.setitem(sys.modules, "llama3np_tpu_torch.models.deepseek_v2", None)
    out = io.StringIO()
    with pytest.raises(ImportError):
        runner.run(["--workload", CELL, "--seed", "5", "--seconds", "1"], root=v2_root,
                   device="cpu", out=out)
    assert out.getvalue() == ""


# -- the readers -------------------------------------------------------------

@pytest.mark.parametrize("name", ["mla_ms.dsv2lite", "moe_ms.dsv2lite"])
def test_block_readers_read_nothing_without_the_timer(name):
    read = Spec().reader(name)
    ctx = SimpleNamespace(window={"t0": 0.0, "t1": 1.0, "window_s": 1.0}, counters={})
    assert read(ctx) is None
    ctx.block_timer = SimpleNamespace(steps=[], records=[])  # a timer, no step in the window
    assert read(ctx) is None
    assert blocks.decode_block_ms(SimpleNamespace(window={}), "deepseek_v2.mla") is None


# -- the control ---------------------------------------------------------------

# The block's shape at a bf16 size a test run holds, served to completion
# (4 prompts of 20-60 tokens, 40 new tokens each: the same work however
# loaded the host is): the program read 0.0004-0.0046 over seeds 31-40, the
# fp8 control 0.047-0.092; LIMIT between, ~3x from each.
SMALL_BF16 = {**TINY_V2, "hidden_size": 256, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16,
              "v_head_dim": 32, "kv_lora_rank": 64, "intermediate_size": 512,
              "moe_intermediate_size": 64, "vocab_size": 2048, "torch_dtype": "bfloat16"}
LIMIT = 0.015


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_comes_out_not_correct(seed):
    from llama3np_tpu_torch.serving import BatchEngine

    fam = family()
    dm = fam.dims(SMALL_BF16)
    h = SimpleNamespace(torch=torch, dm=dm, seed=seed, device="cpu", dtype=torch.bfloat16,
                        traced=False)
    be = BatchEngine(fam.engine(h), capacity=4, paged=True, page_size=16)
    rng = np.random.default_rng([seed, 0])
    reqs = [be.submit(rng.integers(3, dm.vs, size=L).tolist(), 40, stop_ids=())
            for L in (20, 35, 50, 60)]
    be.run_to_completion()
    r = check.readings(torch, fam, dm, seed, "cpu", [(q.prompt_ids, q.generated) for q in reqs],
                       control=True)
    ck = {"logit_gap_limit": LIMIT}
    assert check.passed(check.judge(ck, r["logit_gap"], 0)), r
    assert not check.passed(check.judge(ck, r["control_gap"], 0)), r
