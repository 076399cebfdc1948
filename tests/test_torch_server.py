"""The port's OpenAI-compatible server (asyncio, no aiohttp) held against
jlama_tpu's (aiohttp), analogs of tests/test_server.py: the same requests go
to both over real sockets through one http.client helper, and the status,
the content, the finish reason, the usage and the streamed events must be
equal, ids, timestamps and tool-call ids aside. Both serve the same tiny chat
checkpoint in f32 (2 slots, pages of 8, greedy unless a test says)."""

import asyncio
import http.client
import json
import socket
import threading
import time

import jax.numpy as jnp
import pytest
import torch

from tests.helpers import make_tiny_chat_model

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]
TOOL_JSON = '{"name": "get_weather", "parameters": {"city": "Paris"}}'


class ToolTalk:
    """A tokenizer whose decode can be switched to a fixed text, so that a
    random model's answer is tool-shaped JSON (encode and the spec are the
    real tokenizer's)."""

    def __init__(self, tok):
        self.tok, self.spec, self.reply = tok, tok.spec, None

    def encode(self, text, add_special=True):
        return self.tok.encode(text, add_special=add_special)

    def decode(self, ids, skip_special=True):
        if self.reply is not None:
            return self.reply if list(ids) else ""
        return self.tok.decode(ids, skip_special=skip_special)


class LoopThread:
    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_chat_model(tmp_path_factory.mktemp("tiny_torch_serve"))[0]


@pytest.fixture(scope="module")
def servers(model_dir):
    """{"jax": (port, scheduler, tokenizer), "torch": (...)}, both started."""
    from aiohttp import web

    from jlama_tpu.models.loader import load_params as jax_load
    from jlama_tpu.runtime.scheduler import BatchScheduler as JaxSched
    from jlama_tpu.server.openai_api import OpenAIServer as JaxServer
    from jlama_tpu.tokenizers import load_tokenizer as jax_tokenizer
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from jlama_tpu_torch.server import OpenAIServer
    from jlama_tpu_torch.tokenizers import load_tokenizer

    kw = dict(n_slots=2, n_pages=64, page_size=8, max_seq_len=96)
    jparams, jcfg = jax_load(model_dir, float_dtype=jnp.float32)
    jtok = ToolTalk(jax_tokenizer(model_dir))
    jsched = JaxSched(jparams, jcfg, jtok, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                      **kw)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    tok = ToolTalk(load_tokenizer(model_dir))
    sched = BatchScheduler(params, cfg, tok, kv_dtype=torch.float32,
                           compute_dtype=torch.float32, device="cpu", **kw)
    jsched.start()
    loops = {"jax": LoopThread(), "torch": LoopThread()}

    async def start_jax():
        runner = web.AppRunner(JaxServer(jsched, jtok, model_name="tiny-test").app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, runner.addresses[0][1]

    runner, jport = loops["jax"].run(start_jax())
    srv = OpenAIServer(sched, tok, model_name="tiny-test")
    port = loops["torch"].run(srv.start("127.0.0.1", 0))
    yield {"jax": (jport, jsched, jtok), "torch": (port, sched, tok)}
    loops["jax"].run(runner.cleanup())
    loops["torch"].run(srv.close())
    for lt in loops.values():
        lt.stop()
    jsched.stop()
    sched.stop()


def call(port, method, path, body=None, headers=None, raw=None):
    """(status, headers, body bytes) of one request on a fresh connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
        hdrs = dict(headers or {})
        if data is not None:
            hdrs.setdefault("Content-Type", "application/json")
        conn.request(method, path, body=data, headers=hdrs)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


def _strip(obj):
    """Drop what differs between runs: ids, timestamps, tool-call ids."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def events(raw: bytes) -> list:
    out = []
    for line in raw.decode().splitlines():
        if line.startswith("data: "):
            out.append(line[6:] if line == "data: [DONE]" else _strip(json.loads(line[6:])))
    return out


def _merged(evs: list) -> list:
    """Adjacent content deltas as one: where text splits into chunks depends
    on when the scheduler's thread hands tokens to the event loop (the last
    ones may come with the finish, in both servers)."""
    out = []
    for e in evs:
        text = e["choices"][0]["delta"].get("content") if isinstance(e, dict) else None
        prev = out[-1]["choices"][0]["delta"] if out and isinstance(out[-1], dict) else {}
        if text is not None and set(prev) == {"content"} and \
                set(e["choices"][0]["delta"]) == {"content"}:
            prev["content"] += text
        else:
            out.append(json.loads(json.dumps(e)))
    return out


def both(servers, method, path, body=None, headers=None, raw=None):
    """The same request to both servers: {"jax": (status, headers, body), ...}."""
    return {k: call(v[0], method, path, body, headers, raw) for k, v in servers.items()}


def same_json(servers, method, path, body=None, headers=None, status=200):
    res = both(servers, method, path, body, headers)
    assert res["jax"][0] == res["torch"][0] == status, (res["jax"][:2], res["torch"][:2])
    j, t = (_strip(json.loads(res[k][2])) for k in ("jax", "torch"))
    assert j == t
    return t


def same_stream(servers, body):
    res = both(servers, "POST", "/v1/chat/completions", body)
    for st, hdrs, _ in res.values():
        assert st == 200 and hdrs["content-type"].startswith("text/event-stream")
    j, t = events(res["jax"][2]), events(res["torch"][2])
    assert _merged(j) == _merged(t)
    assert res["torch"][2].decode().strip().endswith("data: [DONE]")
    return t


def test_chat_completion(servers):
    body = same_json(servers, "POST", "/v1/chat/completions", {
        "model": "tiny-test", "messages": [{"role": "user", "content": "Hello there"}],
        "max_tokens": 8, "temperature": 0})
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert body["usage"]["completion_tokens"] >= 1
    assert body["choices"][0]["finish_reason"] in ("stop", "length")


def test_chat_streaming(servers):
    evs = same_stream(servers, {"messages": [{"role": "user", "content": "Tell me a story"}],
                                "max_tokens": 6, "temperature": 0, "stream": True})
    assert evs[-1] == "[DONE]"
    assert evs[0]["choices"][0]["delta"].get("role") == "assistant"
    assert evs[-2]["choices"][0]["finish_reason"] in ("stop", "length")


def test_completions_endpoint(servers):
    body = same_json(servers, "POST", "/v1/completions",
                     {"prompt": "The quick", "max_tokens": 4, "temperature": 0})
    assert body["object"] == "text_completion"
    assert body["usage"]["completion_tokens"] >= 1


def test_models_and_topology(servers):
    same_json(servers, "GET", "/v1/models")
    assert json.loads(call(servers["torch"][0], "GET", "/v1/models")[2])["data"][0]["id"] == \
        "tiny-test"
    tops = {k: json.loads(call(v[0], "GET", "/cluster/topology")[2])
            for k, v in servers.items()}
    assert tops["torch"]["n_slots"] == 2 and tops["torch"]["devices"][0]["platform"] == "cpu"
    assert {k: v for k, v in tops["jax"].items() if k != "devices"} == \
        {k: v for k, v in tops["torch"].items() if k != "devices"}
    assert same_json(servers, "GET", "/healthz") == {"status": "ok"}
    metrics = {k: json.loads(call(v[0], "GET", "/metrics")[2]) for k, v in servers.items()}
    assert metrics["jax"].keys() == metrics["torch"].keys()
    for path, text in (("/admin/topology", "cluster topology"), ("/", "/v1/chat/completions"),
                       ("/ui", "/v1/chat/completions")):
        res = both(servers, "GET", path)
        for st, hdrs, page in res.values():
            assert st == 200 and hdrs["content-type"].startswith("text/html")
            assert text in page.decode()


def test_healthz_degraded(servers):
    for _, sched, _ in servers.values():
        sched.degraded = "lost peer 1"
    try:
        assert same_json(servers, "GET", "/healthz", status=503) == \
            {"status": "degraded", "reason": "lost peer 1"}
    finally:
        for _, sched, _ in servers.values():
            sched.degraded = None


def test_session_affinity_header(servers):
    for content in ("Hello", "More"):
        body = same_json(servers, "POST", "/v1/chat/completions",
                         {"messages": [{"role": "user", "content": content}], "max_tokens": 3,
                          "temperature": 0}, headers={"X-Jlama-Session": "sess-42"})
        assert body["usage"]["completion_tokens"] >= 1


def test_tools_passthrough_and_parse(servers):
    body = same_json(servers, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "What is the weather?"}], "max_tokens": 4,
        "temperature": 0, "tools": TOOLS})
    assert body["choices"][0]["finish_reason"] in ("stop", "length", "tool_calls")
    assert body["object"] == "chat.completion"


def test_streaming_with_tools_plain_text(servers):
    evs = same_stream(servers, {"messages": [{"role": "user", "content": "Tell me a story"}],
                                "max_tokens": 8, "temperature": 0, "stream": True,
                                "tools": TOOLS})
    content = [e for e in evs[:-1] if e["choices"][0]["delta"].get("content")]
    assert len(content) >= 2


@pytest.mark.parametrize("stream", [False, True])
def test_tool_call_answer(servers, stream):
    """A tool-shaped answer comes back as tool_calls with finish tool_calls,
    held back from the streamed content."""
    for _, _, tok in servers.values():
        tok.reply = "Sure. " + TOOL_JSON
    try:
        req = {"messages": [{"role": "user", "content": "Weather in Paris?"}],
               "max_tokens": 5, "temperature": 0, "tools": TOOLS, "stream": stream}
        if stream:
            evs = same_stream(servers, req)
            assert evs[-2]["choices"][0]["finish_reason"] == "tool_calls"
            calls = evs[-3]["choices"][0]["delta"]["tool_calls"]
            text = "".join(e["choices"][0]["delta"].get("content", "") for e in evs[:-1])
            assert "{" not in text
        else:
            body = same_json(servers, "POST", "/v1/chat/completions", req)
            assert body["choices"][0]["finish_reason"] == "tool_calls"
            assert body["choices"][0]["message"]["content"] is None
            calls = body["choices"][0]["message"]["tool_calls"]
        assert [c["function"]["name"] for c in calls] == ["get_weather"]
        assert json.loads(calls[0]["function"]["arguments"]) == {"city": "Paris"}
    finally:
        for _, _, tok in servers.values():
            tok.reply = None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_scheduler_tool_call_finish(servers, pkg):
    """Each package's scheduler: a request with tools whose output is a
    tool-shaped JSON finishes TOOL_CALL with its name and parameters."""
    from jlama_tpu import prompt as jp
    from jlama_tpu.runtime.scheduler import GenRequest as JaxRequest
    from jlama_tpu_torch import prompt as tp
    from jlama_tpu_torch.runtime.scheduler import GenRequest

    _, sched, tok = servers[pkg]
    prompt, request = (jp, JaxRequest) if pkg == "jax" else (tp, GenRequest)
    tool = prompt.Tool.from_function(prompt.Function(
        name="get_weather", parameters=prompt.Parameters().add_property("city", "string")))
    tok.reply = TOOL_JSON
    try:
        req = request(prompt_ids=tok.encode("Weather?"), max_new_tokens=3, tools=[tool])
        sched.submit(req)
        assert req.done_event.wait(120)
        resp = req.to_response(tok)
    finally:
        tok.reply = None
    assert resp.finish_reason.value == "TOOL_CALL"
    assert [(c.name, c.parameters) for c in resp.tool_calls] == [("get_weather",
                                                                  {"city": "Paris"})]
    assert len(resp.tool_calls[0].id) == 9


def test_top_k_rides_through_server(servers):
    body = same_json(servers, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Hi"}], "max_tokens": 4, "temperature": 0.8,
        "top_k": 1})
    assert body["usage"]["completion_tokens"] >= 1


def test_stop_string_and_seed(servers):
    """Stop strings truncate the text; a seeded sampled request is the same
    in both (greedy-equivalent top_k 1 keeps the draw out of it)."""
    same_json(servers, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Tell me a story"}], "max_tokens": 10,
        "temperature": 0, "stop": ["e"]})
    same_stream(servers, {"messages": [{"role": "user", "content": "Tell me a story"}],
                          "max_tokens": 10, "temperature": 0, "stop": "e", "stream": True})
    same_json(servers, "POST", "/v1/completions", {"prompt": "The weather", "max_tokens": 5,
                                                   "seed": 7, "temperature": 0.7, "top_k": 1,
                                                   "presence_penalty": 0.5})


def test_embeddings_not_implemented(servers):
    res = both(servers, "POST", "/v1/embeddings", {"input": "hello"})
    assert res["jax"][0] == res["torch"][0] == 501
    assert json.loads(res["jax"][2]) == json.loads(res["torch"][2]) == \
        {"error": "no embedding engine attached"}


@pytest.fixture
def embed_engines(servers):
    """Each scheduler's embed_engine for one test, as the JAX CLI's serve
    attaches it (an Engine over the scheduler's fused tree, fuse=False);
    detached after, so that the 501 case still holds."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.runtime.engine import Engine

    _, jsched, jtok = servers["jax"]
    _, sched, tok = servers["torch"]
    jsched.embed_engine = JEngine(jsched.params, jsched.cfg, jtok, max_seq_len=96,
                                  kv_dtype=jnp.float32, compute_dtype=jnp.float32, fuse=False,
                                  moe_ragged=False)
    sched.embed_engine = Engine(sched.params, sched.cfg, tok, device=sched.device,
                                max_seq_len=96, kv_dtype=torch.float32,
                                compute_dtype=torch.float32, fuse=False, moe_ragged=False)
    try:
        yield sched.embed_engine
    finally:
        jsched.embed_engine = sched.embed_engine = None


@pytest.mark.parametrize("pooling", [None, "AVG", "MAX", "SUM", "MODEL"])
def test_embeddings(servers, embed_engines, pooling):
    """/v1/embeddings with a string and with a list of inputs, under each
    pooling (None: the default, AVG): the same JSON as the JAX server's,
    vectors within 1e-4, and equal to the port's embed_batch on the same ids."""
    import numpy as np

    for inputs in ("hello there", ["hello", "a longer input for the batch", "x", "hi hi"]):
        body = {"input": inputs, "model": "tiny-test"}
        if pooling is not None:
            body["pooling"] = pooling
        res = both(servers, "POST", "/v1/embeddings", body)
        assert res["jax"][0] == res["torch"][0] == 200
        j, t = (json.loads(res[k][2]) for k in ("jax", "torch"))
        jvecs = [d.pop("embedding") for d in j["data"]]
        tvecs = [d.pop("embedding") for d in t["data"]]
        assert j == t and t["object"] == "list" and t["model"] == "tiny-test"
        texts = [inputs] if isinstance(inputs, str) else inputs
        assert [d["index"] for d in t["data"]] == list(range(len(texts)))
        np.testing.assert_allclose(tvecs, jvecs, rtol=1e-4, atol=1e-4)
        want = embed_engines.embed_batch([embed_engines.tokenizer.encode(x) for x in texts],
                                         pooling=pooling or "AVG")
        np.testing.assert_array_equal(np.asarray(tvecs, np.float32), np.stack(want))


def test_errors(servers):
    for path in ("/v1/chat/completions", "/v1/completions"):
        res = both(servers, "POST", path, raw=b"{not json")
        assert res["jax"][0] == res["torch"][0] == 400
        assert json.loads(res["jax"][2]) == json.loads(res["torch"][2])
    same_json(servers, "POST", "/v1/chat/completions",
              {"messages": [{"role": "user", "content": "Hi"}], "n": 2}, status=400)
    for method, path, status in (("GET", "/nope", 404), ("GET", "/v1/chat/completions", 405),
                                 ("POST", "/v1/models", 405)):
        res = both(servers, method, path)
        assert res["jax"][0] == res["torch"][0] == status


def _raw_exchange(port, chunks, n_responses=1):
    """Send `chunks` (with pauses between) on one socket; read until
    `n_responses` complete responses (each with a Content-Length) came back."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        for c in chunks:
            s.sendall(c)
            time.sleep(0.05)
        data = b""
        while data.count(b"HTTP/1.") < n_responses or not _complete(data, n_responses):
            more = s.recv(65536)
            if not more:
                break
            data += more
        return data


def _complete(data, n):
    pos = 0
    for _ in range(n):
        head_end = data.find(b"\r\n\r\n", pos)
        if head_end < 0:
            return False
        head = data[pos:head_end].decode("latin-1").lower()
        length = int(head.split("content-length:")[1].split("\r\n")[0])
        pos = head_end + 4 + length
        if pos > len(data):
            return False
    return True


def test_http_body_in_pieces_and_keep_alive(servers):
    """The port's HTTP layer: a body split across packets is read to its
    end; two requests share one connection; Connection: close closes."""
    port = servers["torch"][0]
    body = json.dumps({"prompt": "The quick", "max_tokens": 2, "temperature": 0}).encode()
    head = (b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body))
    data = _raw_exchange(port, [head, body[:7], body[7:]])
    assert data.startswith(b"HTTP/1.1 200 OK") and b'"text_completion"' in data
    two = head + body + b"GET /v1/models HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n"
    data = _raw_exchange(port, [two], n_responses=2)
    assert data.count(b"HTTP/1.1 200 OK") == 2 and b"Connection: close" in data
    data = _raw_exchange(port, [b"GET /healthz HTTP/1.0\r\n\r\n"])
    assert data.startswith(b"HTTP/1.1 200 OK") and b"Connection: close" in data
    assert _raw_exchange(port, [b"garbage\r\n\r\n"]).startswith(b"HTTP/1.1 400")


def test_concurrent_requests(servers):
    """Requests from several clients at once share the port's decode batch
    and each gets the answer it gets alone."""
    port = servers["torch"][0]
    reqs = [{"prompt": p, "max_tokens": 4, "temperature": 0}
            for p in ("The quick", "Hello there", "The weather is", "What is")]
    alone = [json.loads(call(port, "POST", "/v1/completions", r)[2])["choices"] for r in reqs]
    out = [None] * len(reqs)

    def go(i):
        out[i] = json.loads(call(port, "POST", "/v1/completions", reqs[i])[2])["choices"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    assert out == alone


def test_tiny_chat_model_tokenizer_matches(model_dir):
    """make_tiny_chat_model's tokenizer: the port's ids and texts equal
    jlama_tpu's and `tokenizers`'."""
    from tokenizers import Tokenizer as HFTok

    from jlama_tpu.tokenizers import load_tokenizer as jax_load
    from jlama_tpu_torch.tokenizers import load_tokenizer

    hf = HFTok.from_file(str(model_dir / "tokenizer.json"))
    ours, ref = load_tokenizer(model_dir), jax_load(model_dir)
    for text in ("Hello there, how are you today?", "The weather is nice.", "  x\n\ny  ", "",
                 "café 你好 😀 ² ½ e\u0301", "<|user|>Hello there</s><|assistant|>"):
        ids = ours.encode(text)
        assert ids == ref.encode(text) == hf.encode(text).ids, text
        assert ours.decode(ids) == ref.decode(ids) == hf.decode(ids)
    assert (ours.bos_id, ours.eos_id) == (ref.bos_id, ref.eos_id)
