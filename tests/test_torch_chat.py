"""The port's chat templates (`llama3np_tpu_torch.chat`) against the JAX
package's, and request cancellation in both engines (CPU).

The template, validation and stop-string cases of tests/test_chat.py run
against the port's copy, and a set of conversations renders to the same
string in both copies.  The engine-level cancel cases run through both
`BatchEngine`s on the same weights with equal results.
"""

import numpy as np
import pytest
import torch

from llama3np_tpu import chat as jchat
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu_torch import preset
from llama3np_tpu_torch.chat import (TEMPLATES, render_chat, stop_strings,
                                     truncate_at_stop)
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.serving import BatchEngine

torch.set_num_threads(1)


def test_plain_template():
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"}]
    assert render_chat(msgs, "plain") == "system: be brief\nuser: hi\nassistant:"


def test_llama2_template():
    msgs = [{"role": "system", "content": "S"}, {"role": "user", "content": "u1"},
            {"role": "assistant", "content": "a1"}, {"role": "user", "content": "u2"}]
    assert render_chat(msgs, "llama2") == ("[INST] <<SYS>>\nS\n<</SYS>>\n\nu1 [/INST] a1 "
                                           "[INST] u2 [/INST]")


def test_chatml_template():
    out = render_chat([{"role": "user", "content": "hi"}], "chatml")
    assert out == "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"


@pytest.mark.parametrize("msgs,tpl,match", [
    ([], "plain", "non-empty"),
    ([{"role": "user", "content": "x"}], "nope", "unknown chat template"),
    ([{"role": "user", "content": "x"}, {"role": "system", "content": "s"}], "plain",
     "must be first"),
    ([{"role": "user", "content": "a"}, {"role": "user", "content": "b"}], "llama2",
     "alternating"),
    ([{"role": "user", "content": "a"}, {"role": "assistant", "content": "b"}], "llama2",
     "end on a user turn"),
    ([{"role": "robot", "content": "a"}], "plain", "role must be"),
    (["hi"], "chatml", "must be"),
])
def test_template_validation(msgs, tpl, match):
    with pytest.raises(ValueError, match=match) as got:
        render_chat(msgs, tpl)
    with pytest.raises(ValueError) as want:
        jchat.render_chat(msgs, tpl)
    assert str(got.value) == str(want.value)


def test_multi_turn_rendering_is_prefix():
    turn1 = [{"role": "user", "content": "hello"}]
    turn2 = turn1 + [{"role": "assistant", "content": "world"},
                     {"role": "user", "content": "again"}]
    for tpl in TEMPLATES:
        assert render_chat(turn2, tpl).startswith(render_chat(turn1, tpl)), tpl


CONVERSATIONS = [
    [{"role": "user", "content": "tell me a story"}],
    [{"role": "system", "content": "you are terse"}, {"role": "user", "content": "why?"}],
    [{"role": "user", "content": "a"}, {"role": "assistant", "content": "b c"},
     {"role": "user", "content": "d\ne"}],
    [{"role": "system", "content": "S"}, {"role": "user", "content": 12},
     {"role": "assistant", "content": "[INST] x"}, {"role": "user", "content": ""}],
]


@pytest.mark.parametrize("tpl", sorted(jchat.TEMPLATES))
@pytest.mark.parametrize("conv", range(len(CONVERSATIONS)))
@pytest.mark.parametrize("gen", [True, False])
def test_render_equals_jax(tpl, conv, gen):
    msgs = CONVERSATIONS[conv]
    assert sorted(TEMPLATES) == sorted(jchat.TEMPLATES)
    assert render_chat(msgs, tpl, gen) == jchat.render_chat(msgs, tpl, gen)


def test_truncate_at_stop():
    stops = stop_strings("plain")
    assert truncate_at_stop("hi there\nuser: more", stops) == "hi there"
    assert truncate_at_stop("clean", stops) == "clean"
    assert truncate_at_stop("anything", None) == "anything"
    assert truncate_at_stop("a[INST]b", ["[INST]", "b"]) == "a"


@pytest.mark.parametrize("tpl", ["plain", "llama2", "chatml", "other"])
def test_stop_strings_equal_jax(tpl):
    assert stop_strings(tpl) == jchat.stop_strings(tpl)
    for text in ("x\nuser: y", "a <|im_end|> b", "[INST] z", "plain text"):
        assert truncate_at_stop(text, stop_strings(tpl)) == \
            jchat.truncate_at_stop(text, jchat.stop_strings(tpl))


# -- engine-level cancel ------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    w = jsynth(jpreset("test-tiny"), seed=0)
    return JLlama(w, jpreset("test-tiny")), Llama(w, preset("test-tiny"), device="cpu")


def cancel_active(BE, engine):
    be = BE(engine, capacity=2, paged=True, page_size=16)
    r1 = be.submit([1, 5, 9], max_new_tokens=30, stop_ids=())
    r2 = be.submit([1, 7, 3], max_new_tokens=10, stop_ids=())
    be.step()
    n1 = len(r1.generated)
    held = len(be._pages[r1.slot])
    free_before = be.allocator.available
    assert be.cancel(r1) is True
    assert r1.done and len(r1.generated) == n1
    assert be.allocator.available == free_before + held
    assert be.cancel(r1) is False  # idempotent on finished requests
    r3 = be.submit([1, 2, 4], max_new_tokens=5, stop_ids=())
    be.run_to_completion()
    return r1.generated, r2.generated, r3.generated, be.allocator.available


def cancel_queued(BE, engine):
    be = BE(engine, capacity=1, paged=True, page_size=16)
    r1 = be.submit([1, 5], max_new_tokens=20, stop_ids=())
    r2 = be.submit([1, 6], max_new_tokens=5, stop_ids=())
    assert r2.slot is None and be._queue
    assert be.cancel(r2) is True
    assert r2.done and not be._queue
    be.run_to_completion()
    return r1.generated, r2.generated


@pytest.mark.parametrize("scenario", [cancel_active, cancel_queued])
def test_cancel_equals_jax(engines, scenario):
    jeng, teng = engines
    got = scenario(BatchEngine, teng)
    assert got == scenario(JBatchEngine, jeng)
    if scenario is cancel_active:
        want = teng.generate_tokens(np.asarray([[1, 7, 3]]), 10)[0].tolist()
        assert got[1] == want and len(got[2]) == 5
