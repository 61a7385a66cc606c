"""Model families (`benchmark/families/<family>.py`): the Llama family
gives the very counts and weights the harness had before families
existed (numbers pinned from that code), a configuration naming another
family runs end to end through that family's dims, engine and reference,
and an unknown family is an error that names its missing file."""

import hashlib
import io
import json
import os

import pytest
import torch

from benchmark.harness import runner
from benchmark.harness.spec import Spec

from .conftest import BENCH, LLAMA, TINY, make_root

CTXS = [1, 777, 2048, 4096]

# (dims, decode_flops(CTXS), prefill_flops(1, 777, 3072), paged bytes and
# FLOPs over CTXS, decode_layers_bytes(0, 1023)), as the harness counted them
# before families existed.
COUNTS = {
    "mistral-7b-v0.3": (
        (32, 4096, 32, 8, 128, 14336, 32768, 4096, 1e6, 1e-5, "bfloat16"),
        60537438208.0, (14227603456.0, 11004602220544.0, 45355928387584.0),
        909377536, 3629121536.0, (13959430144, 14093516800)),
    "deepseek-llm-7b": (
        (30, 4096, 32, 32, 128, 11008, 102400, 4096, 1e4, 1e-6, "bfloat16"),
        55327784960.0, (12981862400.0, 9584132587520.0, 39622667141120.0),
        3404267520, 3402301440.0, (12143984640, 12646809600)),
}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_llama_counts_are_the_harness_counts(name):
    dims, decode, prefill, paged_b, paged_f, layers_b = COUNTS[name]
    cfg = Spec().config(name)
    assert "family" not in cfg  # the default family
    dm = LLAMA.dims(cfg)
    assert tuple(dm) == dims
    assert LLAMA.decode_flops(dm, CTXS) == decode
    assert tuple(LLAMA.prefill_flops(dm, L) for L in (1, 777, 3072)) == prefill
    assert LLAMA.paged_attention_bytes(dm, CTXS) == paged_b
    assert LLAMA.paged_attention_flops(dm, CTXS) == paged_f
    assert tuple(LLAMA.decode_layers_bytes(dm, p) for p in (0, 1023)) == layers_b


@pytest.mark.parametrize("extra", [
    {"rope_scaling": {"type": "yarn", "factor": 40}}, {"sliding_window": 4096},
    {"attention_bias": True}, {"n_routed_experts": 64}, {"kv_lora_rank": 512},
    {"qk_rope_head_dim": 64}, {"head_dim": 32}])
def test_llama_dims_refuse_what_the_block_lacks(extra):
    with pytest.raises(ValueError):
        LLAMA.dims({**TINY, **extra})


def test_existing_cells_resolve_to_llama():
    spec = Spec()
    for cell in ("mistral7b.chat", "deepseek7b.longdoc", "mistral7b.solo", "deepseek7b.solo"):
        assert spec.workload(cell)["family"] == "llama"
    assert spec.family("llama").dims is spec.family("llama").dims  # loaded once


def digest(x):
    return hashlib.sha256(x.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


# Digests of leaves drawn on the CPU at seed 2**31 + 17, pinned from the
# harness's leaves before families existed.
LEAVES = [("wq", 0, "float32", "4cdd7ba72f759e84"), ("wq", 0, "bfloat16", "abf2d95631ab1ff3"),
          ("wk", 1, "float32", "1016d37ad39a499b"), ("w_down", 1, "bfloat16", "514a956427caf36d"),
          ("attn_norm", 0, "float32", "d9681aa62a381601"),
          ("tok_embedding", -1, "bfloat16", "73eafebc99e63d18"),
          ("norm", -1, "float32", "6421e72edf53591e"), ("lm_head", -1, "float32", "b135030ceb1ecaab")]


@pytest.mark.parametrize("name,layer,dtype,want", LEAVES)
def test_llama_leaves_are_the_harness_leaves(name, layer, dtype, want):
    dm = LLAMA.dims(TINY)
    x = LLAMA.leaf(torch, dm, 2**31 + 17, name, layer, "cpu", getattr(torch, dtype))
    assert tuple(x.shape) == LLAMA.shapes(dm)[name] and digest(x) == want


def test_llama_fused_tree_is_the_harness_tree():
    t = LLAMA.fused_tree(torch, LLAMA.dims(TINY), 5, "cpu", torch.float32)
    h = hashlib.sha256()
    for k in ("tok_embedding", "norm", "lm_head"):
        h.update(t[k].numpy().tobytes())
    for k in sorted(t["layers"]):
        h.update(t["layers"][k].numpy().tobytes())
    assert h.hexdigest()[:16] == "b333e2e5b2d21881"


# -- a second family, added as new files ------------------------------------

FAMILY = '''
import os

from benchmark.harness.spec import load_module

HERE = os.path.dirname(os.path.abspath(__file__))
_llama = load_module(os.path.join(HERE, "llama.py"), "bench_family_llama_under_shifted")
engine, decode_flops, prefill_flops = _llama.engine, _llama.decode_flops, _llama.prefill_flops


def dims(config):
    return _llama.dims({k: v for k, v in config.items() if k != "rope_scaling"})


def reference(torch, dm, seed, device):
    ref = load_module(os.path.join(os.path.dirname(HERE), "reference", "shifted.py"),
                      "bench_reference_shifted")
    return ref.Shifted(_llama.reference(torch, dm, seed, device), SHIFT)
'''

REFERENCE = '''
import torch


class Shifted:
    """Another model's logits: token 3's raised by `shift`."""

    def __init__(self, inner, shift):
        self.inner, self.shift = inner, shift

    def logits(self, seqs, spans, precisions=("float32",)):
        out = self.inner.logits(seqs, spans, precisions)
        bump = torch.zeros(out[precisions[0]][0].shape[-1])
        bump[3] = self.shift
        return {p: [x + bump.to(x.device) for x in xs] for p, xs in out.items()}
'''


def shifted_root(tmp_path, shift):
    cfg = {**TINY, "family": "shifted", "rope_scaling": {"type": "linear", "factor": 1.0}}
    root = make_root(tmp_path, cfg)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "families", "shifted.py"), "w") as f:
        f.write(FAMILY.replace("SHIFT", repr(shift)))
    with open(os.path.join(b, "reference", "shifted.py"), "w") as f:
        f.write(REFERENCE)
    return root, cfg


def run(root, cell, trace=0):
    out = io.StringIO()
    rc = runner.run(["--workload", cell, "--seed", str(2**31 + 3), "--seconds", "1.5",
                     "--trace", str(trace)], root=root, device="cpu", out=out)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("shift,correct", [(0.0, True), (100.0, False)])
def test_another_family_is_judged_by_its_own_reference(tmp_path, shift, correct):
    root, cfg = shifted_root(tmp_path, shift)
    with pytest.raises(ValueError, match="rope_scaling"):
        LLAMA.dims(cfg)
    rc, line = run(root, "mistral7b.solo")
    assert rc == 0 and line["correct"] is correct
    gap = line["checks"]["logit_gap"]["value"]
    assert gap <= 1e-3 if correct else gap > 50


def test_a_family_without_kernel_counts_reads_no_roofline(tmp_path):
    root, _ = shifted_root(tmp_path, 0.0)
    rc, line = run(root, "deepseek7b.longdoc", trace=1)
    assert rc == 0 and line["correct"] is True
    assert "step_mfu.longdoc" in line["metrics"]
    assert "paged_attention_roofline.longdoc" not in line["metrics"]


def test_unknown_family_names_its_missing_file(tmp_path):
    root = make_root(tmp_path, {**TINY, "family": "nosuch"})
    with pytest.raises(FileNotFoundError, match=r"families/nosuch\.py"):
        Spec(root).family("nosuch")
    with pytest.raises(FileNotFoundError, match=r"families/nosuch\.py"):
        runner.run(["--workload", "mistral7b.solo", "--seed", "1", "--seconds", "0.5"],
                   root=root, device="cpu", out=io.StringIO())
    assert os.path.isfile(os.path.join(BENCH, "families", "llama.py"))
