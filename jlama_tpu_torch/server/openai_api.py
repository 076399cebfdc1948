"""OpenAI-compatible REST API over the port's `BatchScheduler` (counterpart of
`jlama_tpu/server/openai_api.py`, on the standard library's asyncio in place
of aiohttp):

- POST /chat/completions and /v1/chat/completions: messages -> chat template
  -> generate; SSE streaming and non-streaming; tool definitions and
  tool_call responses; the `X-Jlama-Session` header for KV session affinity;
- POST /v1/completions; POST /v1/embeddings (through the scheduler's
  `embed_engine`, one `Engine.embed_batch` of every input; 501 without
  one); GET /v1/models, /metrics, /healthz (503 when the
  scheduler is degraded), /cluster/topology (the torch devices), and the
  static pages /, /ui and /admin/topology.

Request fields, defaults and response bodies are the JAX server's.
Concurrent requests share the scheduler's decode batch.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid
from pathlib import Path

import torch

from ..prompt import Function, Parameters, PromptBuilder, Tool, ToolCall, ToolResult
from ..runtime.engine import FinishReason
from ..runtime.scheduler import BatchScheduler, GenRequest
from ..utils.metrics import GLOBAL_METRICS
from ._http import HTML_TYPE, JSON_TYPE, TEXT_TYPE, HTTPError, HTTPServer, Response, json_response

SESSION_HEADER = "X-Jlama-Session"
WEBAPP = Path(__file__).parent / "webapp"


def _openai_tools_to_internal(tools_json: list[dict] | None) -> list[Tool]:
    tools = []
    for t in tools_json or []:
        fn = t.get("function", {})
        params = fn.get("parameters", {}) or {}
        p = Parameters(
            properties=params.get("properties", {}) or {},
            required=list(params.get("required", []) or []),
        )
        tools.append(
            Tool.from_function(
                Function(
                    name=fn.get("name", ""),
                    description=fn.get("description"),
                    parameters=p,
                )
            )
        )
    return tools


def _json_body(request) -> dict:
    try:
        return request.json()
    except ValueError:
        raise HTTPError(400, json.dumps({"error": {"message": "invalid JSON body"}}),
                        JSON_TYPE) from None


class OpenAIServer:
    def __init__(
        self,
        scheduler: BatchScheduler,
        tokenizer,
        model_name: str = "jlama-tpu",
    ):
        self.sched = scheduler
        self.tokenizer = tokenizer
        self.model_name = model_name
        post, get = "POST", "GET"
        self.http = HTTPServer({
            "/chat/completions": {post: self.chat_completions},
            "/v1/chat/completions": {post: self.chat_completions},
            "/v1/completions": {post: self.completions},
            "/v1/embeddings": {post: self.embeddings},
            "/v1/models": {get: self.models},
            "/cluster/topology": {get: self.topology},
            "/metrics": {get: self.metrics},
            "/healthz": {get: self.health},
            "/": {get: self.ui},
            "/ui": {get: self.ui},
            "/admin/topology": {get: self.topology_ui},
        })

    # ------------------------------------------------------------------

    def _render_prompt(self, body: dict) -> tuple[str, list[Tool]]:
        tools = _openai_tools_to_internal(body.get("tools"))
        builder = PromptBuilder(self.tokenizer.spec)
        for m in body.get("messages", []):
            role = m.get("role")
            content = m.get("content") or ""
            if isinstance(content, list):  # content parts
                content = "".join(
                    p.get("text", "") for p in content if p.get("type") == "text"
                )
            if role == "system":
                builder.add_system(content)
            elif role == "user":
                builder.add_user(content)
            elif role == "assistant":
                if m.get("tool_calls"):
                    for tc in m["tool_calls"]:
                        fn = tc.get("function", {})
                        try:
                            args = json.loads(fn.get("arguments", "{}"))
                        except json.JSONDecodeError:
                            args = {}
                        builder.add_tool_call(
                            ToolCall(name=fn.get("name", ""), parameters=args,
                                     id=tc.get("id"))
                        )
                else:
                    builder.add_assistant(content)
            elif role == "tool":
                builder.add_tool_result(
                    ToolResult(result=content, name=m.get("name"),
                               tool_call_id=m.get("tool_call_id"))
                )
        if tools:
            builder.add_tools(*tools)
        ctx = builder.build()
        return ctx.prompt, tools

    def _encode(self, prompt: str) -> list[int]:
        return self.tokenizer.encode(prompt)

    # ------------------------------------------------------------------

    async def chat_completions(self, request):
        body = _json_body(request)
        stream = bool(body.get("stream", False))
        n = int(body.get("n", 1) or 1)
        if n != 1:
            raise HTTPError(400, json.dumps({"error": {"message": "only n=1 is supported"}}),
                            JSON_TYPE)
        prompt, tools = self._render_prompt(body)
        prompt_ids = self._encode(prompt)
        temperature = float(body.get("temperature", 0.9) or 0.0)
        max_tokens = int(
            body.get("max_tokens") or body.get("max_completion_tokens") or 1024
        )
        top_p = float(body.get("top_p", 1.0) or 1.0)
        stop = body.get("stop")
        stop_strings = (
            [stop] if isinstance(stop, str) else [str(s) for s in stop or []]
        )
        seed = body.get("seed")
        rid = "chatcmpl-" + uuid.uuid4().hex[:24]
        created = int(time.time())

        loop = asyncio.get_running_loop()
        token_q: asyncio.Queue = asyncio.Queue()

        def on_token(tok: int) -> None:
            loop.call_soon_threadsafe(token_q.put_nowait, tok)

        req = GenRequest(
            prompt_ids=prompt_ids,
            max_new_tokens=max_tokens,
            temperature=temperature,
            top_p=top_p,
            top_k=int(body.get("top_k", 0) or 0),
            stop_strings=stop_strings,
            seed=int(seed) if seed is not None else None,
            presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
            on_token=on_token if stream else None,
            session_id=request.header(SESSION_HEADER),
            tools=tools or None,
        )
        self.sched.submit(req)

        if not stream:
            await loop.run_in_executor(None, req.done_event.wait)
            resp = req.to_response(self.tokenizer)
            if resp.finish_reason == FinishReason.ERROR:
                raise HTTPError(500, json.dumps({"error": {
                    "message": resp.error or "generation failed",
                    "type": "server_error",
                }}), JSON_TYPE)
            # finish_reason and tool_calls come from the scheduler's own
            # post-processing
            tool_calls = resp.tool_calls
            finish = (
                "tool_calls"
                if resp.finish_reason == FinishReason.TOOL_CALL
                else ("stop" if resp.finish_reason == FinishReason.STOP_TOKEN else "length")
            )
            message: dict = {"role": "assistant"}
            if tool_calls:
                message["content"] = None
                message["tool_calls"] = [tc.to_dict() for tc in tool_calls]
            else:
                message["content"] = resp.response_text
            return json_response(
                {
                    "id": rid,
                    "object": "chat.completion",
                    "created": created,
                    "model": self.model_name,
                    "choices": [
                        {"index": 0, "message": message, "finish_reason": finish}
                    ],
                    "usage": {
                        "prompt_tokens": resp.prompt_tokens,
                        "completion_tokens": resp.generated_tokens,
                        "total_tokens": resp.prompt_tokens + resp.generated_tokens,
                    },
                }
            )

        sse = await request.stream({
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })

        async def send_chunk(delta: dict, finish_reason=None):
            payload = {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": self.model_name,
                "choices": [
                    {"index": 0, "delta": delta, "finish_reason": finish_reason}
                ],
            }
            await sse.write(f"data: {json.dumps(payload)}\n\n".encode())

        await send_chunk({"role": "assistant"})
        stops = req.stop_ids or set(self.sched.cfg.eos_token_ids)
        stream_ids: list[int] = []
        sent = 0  # chars of decoded text already emitted as chunks
        # with tools attached, plain text still streams as it comes; only
        # from the first '{' on is text held back, so a tool invocation's raw
        # JSON never leaks as content but a prose answer stays live
        holding = False
        while True:
            if req.done_event.is_set() and token_q.empty():
                break
            try:
                tok = await asyncio.wait_for(token_q.get(), timeout=0.1)
            except asyncio.TimeoutError:
                continue
            if tok in stops:
                continue
            stream_ids.append(tok)
            if holding:
                continue
            text = self.tokenizer.decode(stream_ids)
            if not text or text.endswith("�"):  # partial UTF-8 codepoint
                continue
            limit = len(text)
            if tools:
                brace = text.find("{", sent)
                if brace != -1:
                    limit = brace
                    holding = True
            if limit > sent:
                await send_chunk({"content": text[sent:limit]})
                sent = limit

        resp = req.to_response(self.tokenizer)
        if resp.finish_reason == FinishReason.ERROR:
            # a failure mid-stream is reported, not left hanging
            await sse.write(
                b'data: ' + json.dumps({"error": {
                    "message": resp.error or "generation failed",
                    "type": "server_error",
                }}).encode() + b"\n\n"
            )
            await sse.write(b"data: [DONE]\n\n")
            return sse
        tool_calls = resp.tool_calls
        if tool_calls:
            await send_chunk(
                {
                    "tool_calls": [
                        {**tc.to_dict(), "index": i}
                        for i, tc in enumerate(tool_calls)
                    ]
                }
            )
            finish = "tool_calls"
        else:
            # flush whatever the client hasn't seen (held-back text that
            # turned out not to be a tool call, the final token of a
            # MAX_TOKENS finish, and stop-string truncation via text_override)
            full = resp.response_text
            if full and len(full) > sent:
                await send_chunk({"content": full[sent:]})
            finish = (
                "stop" if req.finish == FinishReason.STOP_TOKEN else "length"
            )
        await send_chunk({}, finish_reason=finish)
        await sse.write(b"data: [DONE]\n\n")
        return sse

    async def completions(self, request):
        body = _json_body(request)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        prompt_ids = self._encode(prompt)
        loop = asyncio.get_running_loop()
        stop = body.get("stop")
        seed = body.get("seed")
        req = GenRequest(
            prompt_ids=prompt_ids,
            max_new_tokens=int(body.get("max_tokens", 128)),
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
            top_k=int(body.get("top_k", 0) or 0),
            stop_strings=(
                [stop] if isinstance(stop, str) else [str(s) for s in stop or []]
            ),
            seed=int(seed) if seed is not None else None,
            presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
        )
        self.sched.submit(req)
        await loop.run_in_executor(None, req.done_event.wait)
        resp = req.to_response(self.tokenizer)
        return json_response(
            {
                "id": "cmpl-" + uuid.uuid4().hex[:24],
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": [
                    {
                        "index": 0,
                        "text": resp.response_text,
                        "finish_reason": "stop"
                        if resp.finish_reason == FinishReason.STOP_TOKEN
                        else "length",
                    }
                ],
                "usage": {
                    "prompt_tokens": resp.prompt_tokens,
                    "completion_tokens": resp.generated_tokens,
                    "total_tokens": resp.prompt_tokens + resp.generated_tokens,
                },
            }
        )

    async def embeddings(self, request):
        body = _json_body(request)
        inputs = body.get("input", [])
        if isinstance(inputs, str):
            inputs = [inputs]
        engine = getattr(self.sched, "embed_engine", None)
        if engine is None:
            raise HTTPError(501, json.dumps({"error": "no embedding engine attached"}),
                            TEXT_TYPE)
        pooling = body.get("pooling", "AVG")

        def run():  # off the event loop: a 32-row batch must not stall other connections
            token_lists = [engine.tokenizer.encode(t) for t in inputs]
            return engine.embed_batch(token_lists, pooling=pooling)

        vecs = await asyncio.get_running_loop().run_in_executor(None, run)
        data = [{"object": "embedding", "index": i, "embedding": v.tolist()}
                for i, v in enumerate(vecs)]
        return json_response({"object": "list", "data": data, "model": self.model_name})

    async def models(self, request):
        return json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "created": 0,
                        "owned_by": "jlama-tpu",
                    }
                ],
            }
        )

    async def topology(self, request):
        """The devices and the scheduler's occupancy."""
        if self.sched.device.type == "cuda":
            devices = [{"id": i, "platform": "gpu",
                        "device_kind": torch.cuda.get_device_name(i), "process_index": 0}
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [{"id": 0, "platform": "cpu", "device_kind": "cpu", "process_index": 0}]
        return json_response(
            {
                "model": self.model_name,
                "devices": devices,
                "n_slots": self.sched.n_slots,
                "active": sum(1 for s in self.sched.slots if s is not None),
                "kv_pages_free": self.sched.kv.alloc.n_free,
                "kv_pages_total": self.sched.kv.n_pages,
            }
        )

    async def metrics(self, request):
        return json_response(GLOBAL_METRICS.snapshot())

    async def health(self, request):
        degraded = getattr(self.sched, "degraded", None)
        if degraded:
            return json_response({"status": "degraded", "reason": degraded}, status=503)
        return json_response({"status": "ok"})

    async def ui(self, request):
        return Response((WEBAPP / "index.html").read_bytes(), content_type=HTML_TYPE)

    async def topology_ui(self, request):
        return Response((WEBAPP / "topology.html").read_bytes(), content_type=HTML_TYPE)

    # ------------------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the scheduler's loop and listen; returns the bound port."""
        self.sched.start()
        return await self.http.start(host, port)

    async def close(self) -> None:
        await self.http.close()

    def run(self, host: str = "0.0.0.0", port: int = 8080) -> None:
        """Serve until interrupted (blocks)."""

        async def serve():
            bound = await self.start(host, port)
            print(f"======== Running on http://{host}:{bound} ========", flush=True)
            try:
                await self.http.serve_forever()
            finally:
                await self.close()

        try:
            asyncio.run(serve())
        except KeyboardInterrupt:
            pass
        finally:
            self.sched.stop()
