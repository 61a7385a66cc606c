"""The reference against the program's plain CPU path in float32, and the
reference's independence from the program."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.reference.llama import to_fp8

from .conftest import BENCH, LLAMA, ROOT, TINY


def tiny_dims(**kw):
    return LLAMA.dims({**TINY, **kw})


def reference(dm, seed):
    return LLAMA.reference(torch, dm, seed, "cpu")


def program(dm, seed):
    from llama3np_tpu_torch.models.llama import Llama

    tree = LLAMA.fused_tree(torch, dm, seed, "cpu", torch.float32)
    return Llama.from_param_tree(tree, LLAMA.program_args(dm), device="cpu")


@pytest.mark.parametrize("kv", [2, 4])  # GQA and MHA
def test_reference_matches_the_program_in_float32(kv):
    dm = tiny_dims(num_key_value_heads=kv, rope_theta=1e6)
    ids = np.random.default_rng(0).integers(3, dm.vs, size=40).tolist()
    eng = program(dm, seed=11)
    want = [eng(np.asarray([ids[:8]]), 0)[0, -1]]
    for p in range(8, len(ids)):  # the rest one token at a time, through the cache
        want.append(eng(np.asarray([[ids[p]]]), p)[0, -1])
    got = reference(dm, 11).logits([ids], [(7, len(ids))])["float32"][0]
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-4, atol=1e-4)


def test_served_gap_is_zero_for_the_reference_argmax_and_positive_otherwise():
    dm = tiny_dims()
    prompt = list(range(3, 20))
    ref = reference(dm, 5)
    toks = []
    for _ in range(6):  # the reference's own greedy stream
        seq = prompt + toks
        toks.append(int(ref.logits([seq], [(len(seq) - 1, len(seq))])["float32"][0].argmax()))
    assert check.readings(torch, LLAMA, dm, 5, "cpu", [(prompt, toks)])["logit_gap"] <= 1e-5
    bad = toks[:2] + [(toks[2] + 1) % dm.vs] + toks[3:]
    assert check.readings(torch, LLAMA, dm, 5, "cpu", [(prompt, bad)])["logit_gap"] > 1e-3


def test_fp8_rounding():
    x = torch.tensor([[1.0, -0.3, 448.0, 1e-3]])
    y = to_fp8(x, -1)
    assert y[0, 2] == 448.0 and y[0, 0] == 1.0
    assert abs(float(y[0, 1]) + 0.3) <= 0.3 / 16  # e4m3 keeps 3 mantissa bits
    w = torch.randn(64, 32)
    rel = ((to_fp8(w, 0) - w).norm() / w.norm()).item()
    assert 0.005 < rel < 0.06


def test_sample_takes_the_longest_then_by_seed():
    done = [([1] * 10, [2] * 5), ([1] * 100, [2] * 50), ([1] * 3, [2] * 2), ([1] * 4, [])]
    a = check.sample(done, np.random.default_rng([9, 1]), served_tokens=56, max_requests=8)
    assert a[0] == done[1] and len(a) == 3 and ([1] * 4, []) not in a
    assert check.sample(done, np.random.default_rng([9, 1]), 10, 8) == [done[1]]
    assert check.sample([], np.random.default_rng(0), 10, 8) == []


def test_judge_and_passed():
    ck = {"logit_gap_limit": 1.0}
    ok = check.judge(ck, 0.2, 0)
    assert ok == {"logit_gap": {"value": 0.2, "limit": 1.0},
                  "length_errors": {"value": 0, "limit": 0}}
    assert check.passed(ok)
    assert not check.passed(check.judge(ck, 1.5, 0))
    assert not check.passed(check.judge(ck, 0.2, 1))
    assert not check.passed(check.judge(ck, None, 0))
    assert not check.passed(check.judge({}, 0.0, 0))


def imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(BENCH, "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            names = set(imported_names(os.path.join(ref_dir, f)))
            assert names <= {"__future__", "typing", "math", "torch", "torch.nn.functional"}, names
    code = ("import sys; import benchmark.reference.llama; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'llama3np_tpu_torch', 'llama3np_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_imports_no_jax():
    """The benchmark's own files never name JAX or the JAX package."""
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            if f.endswith(".py"):
                for name in imported_names(os.path.join(dirpath, f)):
                    top = name.lstrip(".").split(".")[0]
                    assert top not in ("jax", "jaxlib", "flax", "llama3np_tpu"), (f, name)
