"""`/v1/embeddings` on a mesh server: `python -m jlama_tpu_torch.cli serve
--mesh D,1,T --device cpu` in two rank processes (gloo on the CPU, a file
store in tmp_path, the HTTP port and the step channel's bound as port 0).
Rank 0's embeddings `Engine` publishes each embed call on the step channel
and rank 1 replays it in `run_follower` (at tp = 2 its half of the heads;
at dp = 2 it skips the call, which runs on dp group 0 alone). A chat
completion and an embeddings request go in at once, so that the embed steps
interleave with the decode steps. The server's Engine computes in bf16 (the
command line's f32 working dtype is the weights'): at dp = 2 the vectors
equal one device's `Engine.embed_batch` bit for bit, and at tp = 2, whose
partial sums round once after the all-reduce, each vector is within
`tp_check.REL_L2_LIMIT` (relative L2) of it; the answer is one device's.
At tp = 2 a JQ4 model wide enough for q4s under tp (each rank's K of wo
and w2 a multiple of 256) is served with `--pallas w8a8` by ranged HTTP
from this file's own Range server, each rank reading only its slice (its
line says how many bytes), against one device's q4s scheduler and its
embeddings Engine. Each case has a deadline of its own."""

import json
import os
import queue
import re
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from jlama_tpu_torch.scripts.tp_check import REL_L2_LIMIT
from tests.helpers import make_tiny_chat_model
from tests.test_torch_shard_load import RangeHandler
from tests.test_torch_tp_cli import BODY, DEADLINE, SERVE, _lines, _one_device_answer

ROOT = Path(__file__).resolve().parent.parent
TEXTS = ["the fox jumps over the dog", "a story", "tell me about the weather in the hills"]


def _post(port, path, body, end):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=max(1.0, end - time.monotonic())) as resp:
        return json.load(resp)


def _one_device_vectors(model_dir):
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.tokenizers import load_tokenizer

    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    tok = load_tokenizer(model_dir)
    eng = Engine(params, cfg, tok, device="cpu", max_seq_len=64)  # as `serve` makes it
    return np.stack(eng.embed_batch([tok.encode(t) for t in TEXTS], pooling="AVG"))


def _one_device_q4s(model_dir):
    """One device's q4s scheduler as `serve --pallas w8a8` builds it: its
    greedy answer to BODY and its embeddings Engine's vectors."""
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from jlama_tpu_torch.server.openai_api import OpenAIServer
    from jlama_tpu_torch.tokenizers import load_tokenizer

    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    tok = load_tokenizer(model_dir)
    sched = BatchScheduler(params, cfg, tok, n_slots=2, n_pages=32, page_size=8,
                           max_seq_len=64, kv_dtype=torch.float32, device="cpu",
                           weight_format="q4s")
    assert sched.params["layers"][0]["wo"].fmt == "q4s"
    eng = Engine(sched.params, cfg, tok, device="cpu", max_seq_len=64, fuse=False,
                 moe_ragged=False)
    srv = OpenAIServer(sched, tok)
    answer = sched.generate(srv._encode(srv._render_prompt(BODY)[0]), max_new_tokens=6)
    assert answer.generated_tokens > 0
    vectors = np.stack(eng.embed_batch([tok.encode(t) for t in TEXTS], pooling="AVG"))
    return answer.response_text, vectors


@pytest.mark.parametrize("mesh", ["1,1,2", "2,1,1"])
def test_mesh_server_embeddings_replayed_by_the_followers(tmp_path, mesh):
    extra, http = [], mesh == "1,1,2"
    if http:  # JQ4, every rank's K of wo (256) and w2 (512) whole 256-groups
        from jlama_tpu.quant.quantizer import quantize_model

        src, _ = make_tiny_chat_model(tmp_path / "src", config_overrides=dict(
            hidden_size=512, intermediate_size=1024, num_attention_heads=8,
            num_key_value_heads=4))
        model_dir = quantize_model(src, tmp_path / "model")
        extra = ["--pallas", "w8a8"]
    else:
        model_dir, _ = make_tiny_chat_model(tmp_path / "model")
    model, srv = str(model_dir), None
    if http:
        handler = type("Handler", (RangeHandler,), {"root": str(tmp_path)})
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        model = f"http://127.0.0.1:{srv.server_address[1]}/model"
    store = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "jlama_tpu_torch.cli", "serve", model, "--mesh", mesh,
         "--num-processes", "2", "--process-id", str(r), "--coordinator", store,
         "--host", "127.0.0.1", "--port", "0", *SERVE, *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    end = time.monotonic() + DEADLINE
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_lines, args=(procs[0], lines), daemon=True).start()
    seen, port = [], None
    try:
        while port is None:
            try:
                line = lines.get(timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                raise AssertionError("rank 0 did not listen in time: "
                                     + "".join(seen)[-2000:]) from None
            seen.append(line)
            m = re.search(r"Running on http://127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
            assert procs[0].poll() is None, "".join(seen)[-2000:]
        out = {}

        def chat():
            out["chat"] = _post(port, "/v1/chat/completions", BODY, end)

        t = threading.Thread(target=chat)
        t.start()
        first = _post(port, "/v1/embeddings", {"input": TEXTS}, end)
        t.join(max(1.0, end - time.monotonic()))
        again = _post(port, "/v1/embeddings", {"input": TEXTS[:1]}, end)
        assert procs[1].poll() is None  # the follower replayed every step
    finally:
        for p in procs:  # stopped by PID
            p.kill()
            p.wait(10)
        if srv is not None:
            srv.shutdown()
    read = [int(m.group(1)) for s in seen for m in [re.search(r"read (\d+) of", s)] if m]
    assert len(read) == 1 and read[0] > 0, "".join(seen)
    if http:
        answer, ref = _one_device_q4s(model_dir)
    else:
        answer, ref = _one_device_answer(model_dir), _one_device_vectors(model_dir)
    got = np.array([d["embedding"] for d in first["data"]] + [again["data"][0]["embedding"]],
                   np.float32)
    want = np.concatenate([ref, ref[:1]])
    if mesh == "2,1,1":
        np.testing.assert_array_equal(got, want)
    else:
        rel = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
        assert (rel < REL_L2_LIMIT).all(), rel
    assert out["chat"]["choices"][0]["message"]["content"] == answer
