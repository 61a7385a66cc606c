"""Whole runs of every cell's driver on the CPU at a tiny configuration
(the look for a card skipped), sound and with the timed path broken
underneath: `correct` has to come out true, then false for each fault a
cell can have (one chip: no exchange between chips to leave out)."""

import io
import json
import sys

import pytest
import torch

from benchmark.harness import runner

CELLS = ["mistral7b.chat", "deepseek7b.longdoc", "mistral7b.solo", "deepseek7b.solo"]
SERVE = CELLS[:2]
E2E = {"mistral7b.chat": {"itl_p50_ms"},
       "deepseek7b.longdoc": {"output_tok_s.longdoc"},
       "mistral7b.solo": {"output_tok_s"}, "deepseek7b.solo": {"output_tok_s"}}


def run(root, cell, trace=0, seconds=1.5, seed=2**31 + 17):
    out = io.StringIO()
    rc = runner.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], root=root, device="cpu", out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    rc, line = run(tiny_root, cell)
    assert rc == 0 and line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"setup_s", *E2E[cell]}
    assert line["checks"]["logit_gap"]["value"] <= 1e-3


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_layer_metrics(tiny_root, cell):
    rc, line = run(tiny_root, cell, trace=1)
    assert rc == 0 and line["correct"] is True
    assert "setup_s" not in line["metrics"] and line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert line["profile_clock"]["window_s"] == line["device"]["window_s"]
    if cell == "mistral7b.chat":  # the TTFT tail, read per layer
        assert line["metrics"]["ttft_p95_ms.chat"]["value"] > 0


# -- faults ----------------------------------------------------------------

def stale_step(monkeypatch):
    """A serving step that returns its cache unchanged."""
    import llama3np_tpu_torch.serving as serving
    real = serving.forward_ragged_decode

    def step(params, tokens, pos, cache, *a, **kw):
        logits, _ = real(params, tokens, pos, {k: v.clone() for k, v in cache.items()}, *a, **kw)
        return logits, cache
    monkeypatch.setattr(serving, "forward_ragged_decode", step)


def half_batch(monkeypatch):
    """Half of the batch left out: the other rows take the mean of the
    rows computed."""
    import llama3np_tpu_torch.serving as serving
    real = serving.forward_ragged_decode

    def step(*a, **kw):
        logits, cache = real(*a, **kw)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h].mean(0, keepdim=True).expand_as(logits[h:])]), cache
    monkeypatch.setattr(serving, "forward_ragged_decode", step)


def altered_token(monkeypatch):
    """Row 0's token altered where the step produces it."""
    import llama3np_tpu_torch.serving as serving
    real = serving.forward_ragged_decode

    def step(*a, **kw):
        logits, cache = real(*a, **kw)
        logits = logits.clone()
        wrong = (logits[0].argmax() + 1) % logits.shape[-1]
        logits[0, wrong] = logits[0].max() + 1.0
        return logits, cache
    monkeypatch.setattr(serving, "forward_ragged_decode", step)


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [stale_step, half_batch, altered_token])
def test_serving_faults_are_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = run(tiny_root, cell)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > line["checks"]["logit_gap"]["limit"]


def stale_decode(monkeypatch):
    """A batch-1 decode step that returns its cache unchanged."""
    import llama3np_tpu_torch.generate as generate
    real = generate.decode_steps

    def steps(params, tok, pos, cache, cos, sin, cfg, num_steps):
        toks = []
        for i in range(num_steps):
            t, _ = real(params, tok, pos + i, {k: v.clone() for k, v in cache.items()},
                        cos, sin, cfg, 1)
            tok = t[:, 0]
            toks.append(tok)
        return torch.stack(toks, dim=1), cache
    monkeypatch.setattr(generate, "decode_steps", steps)


def altered_first_token(monkeypatch):
    """The prefill's token altered where it is produced."""
    import llama3np_tpu_torch.generate as generate
    real = generate.prefill_step

    def prefill(*a, **kw):
        tok, cache = real(*a, **kw)
        return (tok + 1) % 512, cache
    monkeypatch.setattr(generate, "prefill_step", prefill)


@pytest.mark.parametrize("cell", ["mistral7b.solo", "deepseek7b.solo"])
@pytest.mark.parametrize("fault", [stale_decode, altered_first_token])
def test_solo_faults_are_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = run(tiny_root, cell)
    assert rc == 0 and line["correct"] is False


# -- refusals --------------------------------------------------------------

def test_no_card_no_result(tiny_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    rc = runner.run(["--workload", "mistral7b.solo", "--seed", "1", "--seconds", "1"],
                    root=tiny_root, device="cuda", out=out)
    assert rc != 0 and out.getvalue() == ""


def test_forbidden_module_no_result(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc, line = run(tiny_root, "mistral7b.solo", seconds=0.5)
    assert rc != 0 and line is None


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "llama3np_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    import llama3np_tpu_torch  # noqa: F401  begins with llama3np_tpu, is not it
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "llama3np_tpu.ops", type(sys)("llama3np_tpu.ops"))
    assert runner.forbidden_modules() == ["llama3np_tpu"]


def test_same_seed_same_traffic_and_weights(tiny_root):
    a = run(tiny_root, "mistral7b.solo", seconds=0.5, seed=77)[1]
    b = run(tiny_root, "mistral7b.solo", seconds=0.5, seed=77)[1]
    assert a["checks"]["logit_gap"] == b["checks"]["logit_gap"]
