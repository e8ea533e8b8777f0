"""The port's HTTP serving layer (tmac_tpu_torch/runtime/server.py):
tests/test_server.py's tests on the port, at llama-2-7b scaled(8) on the
CPU, concurrent clients batched by one engine; a greedy reply's ids equal
the port's own single-stream generate.  Its bench test is in
tests/test_torch_bench_serve.py."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import Llama, init_params
from tmac_tpu_torch.runtime.engine import InferenceEngine
from tmac_tpu_torch.runtime.generate import generate
from tmac_tpu_torch.runtime.server import serve_async

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def server():
    cfg = get_preset("llama-2-7b").scaled(8)
    model = Llama(cfg, init_params(cfg, seed=0, device="cpu"))
    eng = InferenceEngine(model, max_batch=4, max_len=64, decode_chunk=4)
    httpd, serving = serve_async(eng, port=0)
    yield cfg, model, httpd.server_address[1]
    serving.shutdown()
    httpd.shutdown()
    httpd.server_close()


def _post(port, obj, path="/v1/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_health_and_completion(server):
    cfg, model, port = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=10) as r:
        assert json.loads(r.read())["ok"]
    out = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 6})
    ref = generate(model, np.asarray([[1, 2, 3]], np.int32),
                   max_new_tokens=6)
    assert out["ids"] == [int(t) for t in np.asarray(ref)[0]]


def test_concurrent_clients_batched(server):
    cfg, model, port = server
    prompts = [[1, 2], [3, 4, 5], [6], [7, 8, 9, 10]]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = _post(port, {"prompt_ids": prompts[i], "max_tokens": 5})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, p in enumerate(prompts):
        ref = generate(model, np.asarray([p], np.int32),
                       max_new_tokens=5)
        assert results[i]["ids"] == [int(t) for t in np.asarray(ref)[0]], p

    # stats endpoint reflects the traffic
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=10) as r:
        stats = json.loads(r.read())
    assert stats["prefills"] >= 5


def test_streaming_tokens_arrive_before_completion(server):
    """'stream': true -> SSE-style events; token deltas arrive in multiple
    events before the final done event, and the concatenation equals the
    non-streaming result."""
    cfg, model, port = server
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt_ids": [1, 2, 3], "max_tokens": 12,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    assert events[-1]["done"] is True
    # incremental delivery: more than one token-bearing event BEFORE done
    token_events = [e for e in events if e["ids"]]
    assert len(token_events) >= 2, events
    got = [t for e in events for t in e["ids"]]
    ref = generate(model, np.asarray([[1, 2, 3]], np.int32),
                   max_new_tokens=12)
    assert got == [int(t) for t in np.asarray(ref)[0]]


def test_per_request_sampling_http(server):
    """temperature/top_k/top_p in the POST body apply per request; an
    explicit temperature=0 request still matches greedy."""
    cfg, model, port = server
    out = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 5,
                       "temperature": 0.9, "top_k": 20})
    assert len(out["ids"]) == 5
    assert all(0 <= t < cfg.vocab_size for t in out["ids"])
    out0 = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 5,
                        "temperature": 0.0})
    ref = generate(model, np.asarray([[1, 2, 3]], np.int32),
                   max_new_tokens=5)
    assert out0["ids"] == [int(t) for t in np.asarray(ref)[0]]


def test_bad_request(server):
    _, _, port = server
    try:
        _post(port, {"max_tokens": 5})
        assert False, "should have errored"
    except urllib.error.HTTPError as e:
        assert e.code == 400




class _ChatTok:
    """Minimal chat-capable tokenizer stub: token ids are character codes;
    the chat template concatenates message contents."""
    eos_token_id = 0

    def encode(self, s):
        return [ord(c) % 256 + 1 for c in s]

    def decode(self, ids):
        return "".join(chr((i - 1) % 26 + 97) for i in ids)

    def apply_chat_template(self, messages, add_generation_prompt=True):
        text = "".join(m["content"] for m in messages)
        return self.encode(text)


@pytest.fixture(scope="module")
def chat_server():
    cfg = get_preset("llama-2-7b").scaled(8)
    model = Llama(cfg, init_params(cfg, seed=0, device="cpu"))
    eng = InferenceEngine(model, max_batch=4, max_len=64, decode_chunk=4)
    httpd, serving = serve_async(eng, port=0, tokenizer=_ChatTok(),
                                 model_name="test-model")
    yield cfg, model, httpd.server_address[1]
    serving.shutdown()
    httpd.shutdown()
    httpd.server_close()


def test_openai_models_endpoint(chat_server):
    _, _, port = chat_server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models",
                                timeout=10) as r:
        out = json.loads(r.read())
    assert out["object"] == "list"
    assert out["data"][0]["id"] == "test-model"


def test_openai_chat_completion(chat_server):
    cfg, model, port = chat_server
    out = _post(port, {"messages": [{"role": "user", "content": "hi"}],
                       "max_tokens": 6}, path="/v1/chat/completions")
    assert out["object"] == "chat.completion"
    assert out["model"] == "test-model"
    ch = out["choices"][0]
    assert ch["message"]["role"] == "assistant"
    assert isinstance(ch["message"]["content"], str)
    assert ch["finish_reason"] in ("stop", "length")
    assert out["usage"]["prompt_tokens"] == 2
    assert out["usage"]["total_tokens"] == (out["usage"]["prompt_tokens"]
                                            + out["usage"]["completion_tokens"])
    # content must decode the engine's actual greedy tokens
    tok = _ChatTok()
    ref = generate(model, np.asarray([tok.encode("hi")], np.int32),
                   max_new_tokens=6)
    ref_ids = [int(t) for t in np.asarray(ref)[0]]
    gen = [t for t in ref_ids if t != tok.eos_token_id]
    assert ch["message"]["content"] == tok.decode(gen)


def test_openai_chat_stream(chat_server):
    _, _, port = chat_server
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "yo"}],
                         "max_tokens": 8, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                events.append("DONE")
                break
            events.append(json.loads(body))
    assert events[-1] == "DONE"
    chunks = [e for e in events if isinstance(e, dict)]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert isinstance(text, str) and len(text) > 0


def test_openai_chat_requires_tokenizer(server):
    _, _, port = server  # the plain fixture has no tokenizer
    try:
        _post(port, {"messages": [{"role": "user", "content": "x"}]},
              path="/v1/chat/completions")
        raise AssertionError("expected HTTP 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


# --------------------------------------------------------------- stop support

def test_stop_matcher_withholding():
    """Partial stop prefixes are withheld across feeds; a match truncates;
    flush releases a false-positive tail at end of stream."""
    from tmac_tpu_torch.runtime.server import StopMatcher
    m = StopMatcher(["\nUser:"])
    assert m.feed("hello wor") == "hello wor"
    # "\nUs" could still become the stop -> withheld
    assert m.feed("ld\nUs") == "ld"
    assert not m.stopped
    assert m.feed("er:ignored") == ""
    assert m.stopped and m.text == "hello world"
    # false positive: stream ends while withholding
    m2 = StopMatcher(["END"])
    assert m2.feed("abcEN") == "abc"
    assert m2.flush() == "EN"
    assert not m2.stopped and m2.text == "abcEN"
    # multiple stops: earliest match wins
    m3 = StopMatcher(["xx", "by"])
    assert m3.feed("abyxx") == "a"
    assert m3.stopped and m3.text == "a"


def test_stop_token_ids_http(server):
    """stop_token_ids ends generation at the token and removes it."""
    cfg, model, port = server
    ref = generate(model, np.asarray([[1, 2, 3]], np.int32),
                   max_new_tokens=8)
    ref = [int(t) for t in np.asarray(ref)[0]]
    out = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 8,
                       "stop_token_ids": [ref[3]]})
    # the stop token may repeat in the output; generation ends at its
    # FIRST occurrence and the stop token itself is removed
    assert out["ids"] == ref[:ref.index(ref[3])]
    assert out["finish_reason"] == "stop"
    # and the plain path now reports finish_reason too
    out2 = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 4})
    assert out2["finish_reason"] == "length"


def test_stop_string_requires_tokenizer(server):
    _, _, port = server  # no tokenizer on this fixture
    try:
        _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 4,
                     "stop": "xy"})
        raise AssertionError("expected HTTP 400")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def _ref_text(model, prompt_ids, n, strip_eos=False):
    tok = _ChatTok()
    ref = generate(model, np.asarray([prompt_ids], np.int32),
                   max_new_tokens=n)
    ids = [int(t) for t in np.asarray(ref)[0]]
    if strip_eos:
        ids = [t for t in ids if t != tok.eos_token_id]
    return ids, tok.decode(ids)


def test_stop_string_completion(chat_server):
    """Text-level stop: the completion text ends exactly before the stop
    string and generation is cancelled live (fewer ids than max_tokens)."""
    cfg, model, port = chat_server
    tok = _ChatTok()
    ids0 = tok.encode("hi")
    _, full = _ref_text(model, ids0, 12)
    stop = full[3:5]
    assert stop in full
    out = _post(port, {"prompt": "hi", "max_tokens": 12, "stop": stop})
    assert out["text"] == full[:full.index(stop)]
    assert out["finish_reason"] == "stop"
    # live cancellation: decode_chunk=4, stop hits by token 5 -> the
    # request must not have produced all 12 tokens
    assert len(out["ids"]) < 12


def test_stop_string_streaming(chat_server):
    """Streaming with a stop string: emitted text halts exactly at the
    match and the final event carries finish_reason 'stop'."""
    cfg, model, port = chat_server
    tok = _ChatTok()
    ids0 = tok.encode("yo")
    _, full = _ref_text(model, ids0, 12)
    stop = full[4:6]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps({"prompt": "yo", "max_tokens": 12, "stream": True,
                         "stop": stop}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    assert events[-1]["done"] is True
    assert events[-1]["finish_reason"] == "stop"
    text = "".join(e.get("text", "") for e in events)
    assert text == full[:full.index(stop)]


def test_chat_stop_string(chat_server):
    """OpenAI chat 'stop' param: content truncates at the stop,
    finish_reason 'stop', both stream and non-stream."""
    cfg, model, port = chat_server
    tok = _ChatTok()
    ids0 = tok.encode("hi")
    _, full = _ref_text(model, ids0, 12, strip_eos=True)
    stop = full[2:4]
    out = _post(port, {"messages": [{"role": "user", "content": "hi"}],
                       "max_tokens": 12, "stop": stop},
                path="/v1/chat/completions")
    assert out["choices"][0]["message"]["content"] == full[:full.index(stop)]
    assert out["choices"][0]["finish_reason"] == "stop"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 12, "stream": True,
                         "stop": stop}).encode(),
        headers={"Content-Type": "application/json"})
    chunks = []
    with urllib.request.urlopen(req, timeout=120) as r:
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                chunks.append(json.loads(line[len("data: "):]))
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == full[:full.index(stop)]
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


# ----------------------------------------------------------------- logprobs

def test_logprobs_http(server):
    """'logprobs': N returns a per-token record aligned with ids; greedy
    chosen token equals the top-1 alternative."""
    _, _, port = server
    out = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 5,
                       "logprobs": 3})
    assert len(out["logprobs"]) == len(out["ids"]) == 5
    for tid, rec in zip(out["ids"], out["logprobs"]):
        assert rec["id"] == tid
        assert len(rec["top"]) == 3
        assert rec["top"][0]["id"] == tid  # greedy = argmax
        assert abs(rec["logprob"] - rec["top"][0]["logprob"]) < 1e-6
    # requests without logprobs have no field
    out2 = _post(port, {"prompt_ids": [1, 2, 3], "max_tokens": 3})
    assert "logprobs" not in out2


def test_chat_logprobs_openai_shape(chat_server):
    """OpenAI chat logprobs: choices[0].logprobs.content entries with
    token/logprob/top_logprobs."""
    _, _, port = chat_server
    out = _post(port, {"messages": [{"role": "user", "content": "hi"}],
                       "max_tokens": 5, "logprobs": True,
                       "top_logprobs": 2}, path="/v1/chat/completions")
    content = out["choices"][0]["logprobs"]["content"]
    assert len(content) >= 1
    for e in content:
        assert isinstance(e["token"], str)
        assert len(e["top_logprobs"]) == 2
        assert e["top_logprobs"][0]["logprob"] >= e["top_logprobs"][1]["logprob"]


def test_logprobs_with_stop_string(chat_server):
    """Live text-stop cancellation still returns logprob records for the
    tokens that were generated."""
    cfg, model, port = chat_server
    tok = _ChatTok()
    _, full = _ref_text(model, tok.encode("hi"), 12)
    stop = full[4:6]
    out = _post(port, {"prompt": "hi", "max_tokens": 12, "stop": stop,
                       "logprobs": 2})
    assert out["finish_reason"] == "stop"
    assert len(out["logprobs"]) > 0
    assert len(out["logprobs"]) <= len(out["ids"])


def test_seed_http_reproducible(server):
    """'seed' in the POST body reproduces sampled output across calls."""
    _, _, port = server
    body = {"prompt_ids": [1, 2, 3], "max_tokens": 6,
            "temperature": 0.9, "seed": 42}
    a = _post(port, body)
    b = _post(port, body)
    assert a["ids"] == b["ids"]
    c = _post(port, dict(body, seed=43))
    assert c["ids"] != a["ids"]
