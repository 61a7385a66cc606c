"""The port's HTTP server (`llama3np_tpu_torch.server`) against the JAX
package's (CPU).

Both servers run on ephemeral ports over paged, prefix-caching
`BatchEngine`s built on the same synthetic weights, with tokenizers over
one vocabulary made from a seed.  Every request goes to both servers in
the same order (so request ids, which key sampled streams, stay aligned),
and the JSON bodies must be equal apart from the response ids: greedy ids
and text, stop ids, concurrent requests against solo ones, SSE chunks,
`n` choices, errors, /health, /stats and /metrics, chat (plain, streamed,
stop strings that cancel), sampled requests with a fixed seed.
"""

import http.client
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from llama3np_tpu import Tokenizer as JTokenizer
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights as jsynth
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.serving import BatchEngine as JBatchEngine
from llama3np_tpu.server import serve as jserve
from llama3np_tpu_torch import Tokenizer, preset
from llama3np_tpu_torch.models.llama import Llama
from llama3np_tpu_torch.serving import BatchEngine
from llama3np_tpu_torch.server import main, serve

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ARGS = jpreset("test-tiny", max_seq_len=256)  # room for chat prompts
TIMING = ("step_seconds_total", "step_seconds_ema")


def write_vocab(path, size=512, seed=3):
    """A tokenizer model of `size` entries from a seed: the markers,
    printable ASCII, then random merges of letters and spaces."""
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [chr(c) for c in range(32, 127)]
    seen = set(tokens)
    while len(tokens) < size:
        piece = "".join(rng.choice(list("abcdefghij :\n"), size=int(rng.integers(2, 5))))
        if piece not in seen:
            seen.add(piece)
            tokens.append(piece)
    scores = [0.0, 0.0, 0.0] + np.round(-rng.random(size - 3) * 10, 3).tolist()
    path.write_text(json.dumps({"tokens": tokens, "scores": scores}))
    return str(path)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("vocab") / "vocab.json")


@pytest.fixture(scope="module")
def engines():
    w = jsynth(ARGS, seed=0)
    return JLlama(w, ARGS), Llama(w, preset("test-tiny", max_seq_len=256), device="cpu")


@pytest.fixture(scope="module")
def servers(engines, vocab):
    """(JAX server, port server), each over a paged prefix-caching engine."""
    jeng, teng = engines
    kw = dict(capacity=4, paged=True, page_size=16, prefix_cache=True, logprobs=3)
    js = jserve(JBatchEngine(jeng, **kw), tokenizer=JTokenizer(vocab), port=0, quantum=2)
    ts = serve(BatchEngine(teng, **kw), tokenizer=Tokenizer(vocab), port=0, quantum=2)
    yield js, ts
    for s in (js, ts):
        s.shutdown()
        s.loop.shutdown()
        s.server_close()


def _conn(s):
    host, port = s.server_address
    return http.client.HTTPConnection(host, port, timeout=300)


def post(s, path, body):
    c = _conn(s)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    out.pop("id", None)
    return r.status, out


def get(s, path):
    c = _conn(s)
    c.request("GET", path)
    r = c.getresponse()
    body = r.read().decode()
    c.close()
    return r.status, r.getheader("Content-Type"), body


def sse(s, path, body):
    """The SSE events of a streamed response, each chunk's id removed."""
    c = _conn(s)
    c.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200 and r.getheader("Content-Type") == "text/event-stream"
    raw = r.read().decode()
    c.close()
    events = [e[len("data: "):] for e in raw.split("\n\n") if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    out = [json.loads(e) for e in events[:-1]]
    for e in out:
        e.pop("id", None)
    return out


def assert_same(got, want, where="body"):
    """Equal JSON values; floats (log-probabilities) within rtol 2e-4 /
    atol 1e-4, as the engines' logprobs are held."""
    if isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= 1e-4 + 2e-4 * abs(want), where
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, type(want)) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def post_both(servers, path, body):
    (js, ts) = servers
    want = post(js, path, body)
    got = post(ts, path, body)
    assert_same(got, want)
    return got


def solo(engine, prompt, n):
    return engine.generate_tokens(np.asarray([prompt]), n)[0].tolist()


def test_completion_ids_and_text(servers, engines, vocab):
    _, teng = engines
    prompt = [1, 17, 98, 45]
    status, out = post_both(servers, "/v1/completions",
                            {"prompt_ids": prompt, "max_tokens": 12, "stop_ids": []})
    assert status == 200 and out["object"] == "text_completion"
    choice = out["choices"][0]
    assert choice["token_ids"] == solo(teng, prompt, 12)
    assert choice["text"] == Tokenizer(vocab).decode(choice["token_ids"])
    assert out["usage"] == {"prompt_tokens": 4, "completion_tokens": 12, "total_tokens": 16}
    assert choice["finish_reason"] == "length"
    # a text prompt, echoed, with logprobs
    status, out = post_both(servers, "/v1/completions",
                            {"prompt": "abc dd", "max_tokens": 5, "stop_ids": [],
                             "echo": True, "logprobs": 2})
    assert status == 200 and len(out["choices"][0]["logprobs"]["top_logprobs"][0]) == 2


def test_stop_id_finish_reason(servers, engines):
    _, teng = engines
    prompt = [1, 17, 98, 45]
    first = solo(teng, prompt, 1)[0]
    status, out = post_both(servers, "/v1/completions",
                            {"prompt_ids": prompt, "max_tokens": 8, "stop_ids": [first]})
    assert status == 200
    assert out["choices"][0]["token_ids"] == [] and out["choices"][0]["finish_reason"] == "stop"


def test_concurrent_requests_match_solo(servers, engines):
    _, teng = engines
    rng = np.random.default_rng(0)
    prompts = [[1] + rng.integers(3, ARGS.vocab_size, size=3).tolist() for _ in range(6)]
    for s in servers:
        results = [None] * len(prompts)

        def go(i, s=s, results=results):
            results[i] = post(s, "/v1/completions",
                              {"prompt_ids": prompts[i], "max_tokens": 10, "stop_ids": []})

        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in ts), "a request never completed"
        for p, (status, out) in zip(prompts, results):
            assert status == 200 and out["choices"][0]["token_ids"] == solo(teng, p, 10)


def test_streaming_chunks(servers):
    body = {"prompt_ids": [1, 17, 98, 45], "max_tokens": 9, "stream": True, "stop_ids": [],
            "logprobs": 1}
    js, ts = servers
    got = sse(ts, "/v1/completions", body)
    assert_same(got, sse(js, "/v1/completions", body))
    assert len(got) > 1 and all(e["object"] == "text_completion.chunk" for e in got)
    toks = [t for e in got for t in e["choices"][0]["token_ids"]]
    _, whole = post_both(servers, "/v1/completions", {**body, "stream": False})
    assert toks == whole["choices"][0]["token_ids"]
    assert "".join(e["choices"][0]["text"] for e in got) == whole["choices"][0]["text"]


def test_n_choices(servers):
    prompt = [1, 9, 33, 7]
    status, out = post_both(servers, "/v1/completions",
                            {"prompt_ids": prompt, "max_tokens": 6, "n": 3, "stop_ids": []})
    assert status == 200 and [c["index"] for c in out["choices"]] == [0, 1, 2]
    assert out["usage"]["completion_tokens"] == 18
    status, out = post_both(servers, "/v1/completions",
                            {"prompt_ids": prompt, "max_tokens": 8, "n": 3,
                             "temperature": 1.0, "stop_ids": []})
    assert status == 200
    assert len({tuple(c["token_ids"]) for c in out["choices"]}) > 1
    status, out = post_both(servers, "/v1/completions",
                            {"prompt_ids": prompt, "max_tokens": 4, "n": 2, "stream": True})
    assert status == 400 and "n=1" in out["error"]
    assert post_both(servers, "/v1/completions",
                     {"prompt_ids": prompt, "max_tokens": 4, "n": 0})[0] == 400


@pytest.mark.parametrize("temperature,extra", [(0.8, {}), (1.2, {"logprobs": 3}),
                                                (0.5, {"stream": True})])
def test_sampled_request_fixed_seed(servers, temperature, extra):
    """The engines' seeds and request ids agree, so a sampled request is
    drawn the same by both servers."""
    body = {"prompt_ids": [1, 40, 41, 42, 43], "max_tokens": 10, "stop_ids": [],
            "temperature": temperature, **extra}
    if extra.get("stream"):
        js, ts = servers
        assert sse(ts, "/v1/completions", body) == sse(js, "/v1/completions", body)
    else:
        assert post_both(servers, "/v1/completions", body)[0] == 200


def test_error_paths(servers):
    for body, status, needle in (
            ({"max_tokens": 4}, 400, "prompt"),
            ({"prompt_ids": "nope", "max_tokens": 4}, 400, "prompt_ids"),
            ({"prompt_ids": [1] * 250, "max_tokens": 30}, 400, "max_seq_len"),
            ({"prompt_ids": [1, 2], "max_tokens": 2, "logprobs": 9}, 400, "logprobs")):
        got = post_both(servers, "/v1/completions", body)
        assert got[0] == status and needle in got[1]["error"]
    assert post_both(servers, "/nope", {})[0] == 404
    for s in servers:
        c = _conn(s)
        c.request("POST", "/v1/completions", "{not json",
                  {"Content-Type": "application/json"})
        r = c.getresponse()
        assert r.status == 400 and "invalid JSON" in json.loads(r.read())["error"]
        c.close()
        assert get(s, "/nope")[0] == 404


def test_adapter_requests_refused(servers):
    """Over engines without adapters, a request naming one (by index, by
    an unknown name, by neither) gets the JAX server's 400 and body."""
    for path in ("/v1/completions", "/v1/chat/completions"):
        for adapter in (0, "nope", [1]):
            status, out = post_both(servers, path, {
                "prompt_ids": [1, 2], "adapter": adapter,
                "messages": [{"role": "user", "content": "x"}]})
            assert status == 400 and out["error"], (path, adapter, out)


def counters(s):
    status, _, body = get(s, "/stats")
    assert status == 200
    return {k: v for k, v in json.loads(body).items() if k not in TIMING}


def test_health_and_stats(servers):
    post_both(servers, "/v1/completions",
              {"prompt_ids": [1, 5, 9], "max_tokens": 5, "stop_ids": []})
    js, ts = servers
    for s in servers:
        status, _, body = get(s, "/health")
        health = json.loads(body)
        assert status == 200 and health["status"] == "ok" and health["active"] == 0
    got, want = counters(ts), counters(js)
    assert got.keys() == want.keys() and "prefix_cache" in got
    assert got["served_requests"] == want["served_requests"] >= 1
    assert got["served_tokens"] >= 5 and got["prefix_cache"].keys() == want["prefix_cache"].keys()


def parse_metrics(s):
    status, ctype, body = get(s, "/metrics")
    assert status == 200 and ctype.startswith("text/plain")
    out, kinds = {}, {}
    for line in body.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            kinds[name] = kind
        elif line:
            k, v = line.split()
            out[k] = float(v)
    assert out.keys() == kinds.keys()
    return out, kinds


def test_metrics_endpoint(servers):
    post_both(servers, "/v1/completions",
              {"prompt_ids": [1, 8, 3], "max_tokens": 4, "stop_ids": []})
    js, ts = servers
    (got, got_kinds), (want, want_kinds) = parse_metrics(ts), parse_metrics(js)
    assert got_kinds == want_kinds
    assert got["llama3np_served_requests_total"] == want["llama3np_served_requests_total"] >= 1
    assert got["llama3np_engine_steps_total"] >= 1 and got["llama3np_step_seconds_total"] > 0
    assert got["llama3np_step_seconds_ema"] > 0 and got["llama3np_active_requests"] == 0


CHAT = [{"role": "user", "content": "tell me a story"}]


def test_chat_completion_greedy(servers, engines, vocab):
    _, teng = engines
    status, out = post_both(servers, "/v1/chat/completions",
                            {"messages": CHAT, "max_tokens": 8})
    assert status == 200 and out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant"
    tok = Tokenizer(vocab)
    from llama3np_tpu_torch.chat import render_chat, stop_strings, truncate_at_stop
    ids = tok.encode(render_chat(CHAT, "plain"), add_bos=True)
    want = solo(teng, ids, 8)
    assert msg["content"] == truncate_at_stop(tok.decode(want), stop_strings("plain"))
    assert out["usage"]["prompt_tokens"] == len(ids)


def test_chat_stream_matches_nonstream(servers):
    js, ts = servers
    _, whole = post_both(servers, "/v1/chat/completions",
                         {"messages": CHAT, "max_tokens": 8, "template": "chatml"})
    body = {"messages": CHAT, "max_tokens": 8, "stream": True, "template": "chatml"}
    got = sse(ts, "/v1/chat/completions", body)
    assert got == sse(js, "/v1/chat/completions", body)
    deltas = [e["choices"][0] for e in got]
    assert deltas[0]["delta"].get("role") == "assistant"
    assert "".join(d["delta"].get("content", "") for d in deltas) == \
        whole["choices"][0]["message"]["content"]
    assert deltas[-1]["finish_reason"] in ("stop", "length")


def test_chat_stop_string_truncates_and_cancels(servers):
    _, full = post_both(servers, "/v1/chat/completions", {"messages": CHAT, "max_tokens": 16})
    text = full["choices"][0]["message"]["content"]
    assert len(text) >= 8, text  # the seeded vocabulary's pieces are 2-4 characters
    stop = text[4:7]
    for stream in (False, True):
        body = {"messages": CHAT, "max_tokens": 16, "stop": [stop], "stream": stream}
        if stream:
            js, ts = servers
            got = sse(ts, "/v1/chat/completions", body)
            assert got == sse(js, "/v1/chat/completions", body)
            content = "".join(e["choices"][0]["delta"].get("content", "") for e in got)
            finish = got[-1]["choices"][0]["finish_reason"]
        else:
            status, out = post_both(servers, "/v1/chat/completions", body)
            content = out["choices"][0]["message"]["content"]
            finish = out["choices"][0]["finish_reason"]
        assert content == text[: text.index(stop)] and finish == "stop"


def test_chat_two_turns_hit_the_prefix_cache(servers):
    js, ts = servers
    before = counters(ts)["prefix_cache"]["hits"]
    turn1 = [{"role": "user", "content": "once upon a time there was a cat and a dog"}]
    _, r1 = post_both(servers, "/v1/chat/completions", {"messages": turn1, "max_tokens": 8})
    turn2 = turn1 + [r1["choices"][0]["message"], {"role": "user", "content": "and then?"}]
    assert post_both(servers, "/v1/chat/completions", {"messages": turn2, "max_tokens": 8})[0] == 200
    got, want = counters(ts)["prefix_cache"], counters(js)["prefix_cache"]
    assert got == want and got["hits"] > before


def test_chat_errors(servers):
    for body, needle in (({"messages": []}, "non-empty"),
                         ({"messages": CHAT, "template": "nope"}, "unknown chat template"),
                         ({"messages": CHAT, "n": 0}, "n must be")):
        status, out = post_both(servers, "/v1/chat/completions", body)
        assert status == 400 and needle in out["error"]


def test_chat_requires_tokenizer(engines):
    _, teng = engines
    s = serve(BatchEngine(teng, capacity=1), tokenizer=None, port=0, quantum=1)
    try:
        status, out = post(s, "/v1/chat/completions", {"messages": CHAT})
        assert status == 400 and "tokenizer" in out["error"]
        status, out = post(s, "/v1/completions", {"prompt": "hi", "max_tokens": 4})
        assert status == 400 and "tokenizer" in out["error"]
    finally:
        s.shutdown()
        s.loop.shutdown()
        s.server_close()


@pytest.mark.parametrize("argv,item", [(["--adapter", "a=b.npz"], "A7")])
def test_main_refuses_unported_options(argv, item):
    """`--adapter` is ported (ROADMAP A7): an adapter file that is not
    there, and a spec without a path, are refused as the JAX server's main
    refuses them."""
    from llama3np_tpu.server import main as jmain
    base = ["--preset", "test-tiny", "--synthetic"]
    for run in (lambda a: main([*base, "--device", "cpu", *a]), lambda a: jmain([*base, *a])):
        with pytest.raises(FileNotFoundError):
            run(argv)
        with pytest.raises(SystemExit, match="--adapter wants NAME=PATH"):
            run(["--adapter", "just-a-name"])


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--preset", "test-tiny", "--synthetic", "--no-tokenizer", "--port", "0"])


def test_module_entry_point_serves(vocab):
    """`python -m llama3np_tpu_torch.server ... --device cpu --port 0`
    answers a completion as the in-process engine computes it."""
    tiny = Llama(jsynth(jpreset("test-tiny"), seed=0), preset("test-tiny"), device="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llama3np_tpu_torch.server", "--preset", "test-tiny",
         "--synthetic", "--device", "cpu", "--port", "0", "--paged", "--prefix-cache",
         "--tokenizer", vocab, "--quantum", "3"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", line).group(1))
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/v1/completions",
                  json.dumps({"prompt_ids": [1, 4, 5, 6], "max_tokens": 7, "stop_ids": []}))
        out = json.loads(c.getresponse().read())
        c.close()
        assert out["choices"][0]["token_ids"] == solo(tiny, [1, 4, 5, 6], 7)
    finally:
        proc.kill()
        proc.communicate(timeout=60)
