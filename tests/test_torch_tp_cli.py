"""`python -m jlama_tpu_torch.cli serve --mesh 1,1,2 --device cpu` in two
processes, one a rank, meeting through a file store in tmp_path (the HTTP
port and the step channel's are bound as port 0): one greedy chat
completion from rank 0 equals an in-process single-device BatchScheduler's
answer on the same prompt ids; both processes are stopped by their PIDs.
Then rank 0 started alone with `--num-processes 2`, which starts rank 1
itself: the same answer, and on an interrupt both ranks stop and the store
directory it made is gone. Each test has a deadline of its own."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import torch

from tests.helpers import make_tiny_chat_model

ROOT = Path(__file__).resolve().parent.parent
DEADLINE = 90
SERVE = ["--device", "cpu", "--batch-slots", "2", "--kv-pages", "32", "--page-size", "8",
         "--context", "64", "--kv-dtype", "f32", "--working-dtype", "f32"]


def _lines(proc, out: queue.Queue):
    for line in proc.stdout:
        out.put(line)


def test_rank_argv_parses_as_that_rank():
    """Rank 0 started alone gives each rank its own command line: the last
    of a repeated option wins."""
    from jlama_tpu_torch.cli import build_parser, rank_argv

    argv = ["serve", "m", "--mesh", "1,1,2", "--num-processes", "2", "--device", "cpu"]
    args = build_parser().parse_args(rank_argv(argv, 1, 2, "file:///x/store"))
    assert (args.process_id, args.num_processes, args.coordinator, args.mesh,
            args.device) == (1, 2, "file:///x/store", "1,1,2", "cpu")


BODY = {"messages": [{"role": "user", "content": "Tell me a story about a fox."}],
        "max_tokens": 6, "temperature": 0.0}


def _ask(lead, end):
    """Wait for rank 0 to listen, then one greedy chat completion from it;
    returns its text and rank 0's output lines so far."""
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_lines, args=(lead, lines), daemon=True).start()
    seen, port = [], None
    while port is None:
        try:
            line = lines.get(timeout=max(0.1, end - time.monotonic()))
        except queue.Empty:
            raise AssertionError(f"rank 0 did not listen within {DEADLINE} s: "
                                 f"{''.join(seen)[-2000:]}") from None
        seen.append(line)
        m = re.search(r"Running on http://127\.0\.0\.1:(\d+)", line)
        port = int(m.group(1)) if m else None
        assert time.monotonic() < end and lead.poll() is None, "".join(seen)[-2000:]
    assert any("rank 0/2: gloo on cpu" in s for s in seen), "".join(seen)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(BODY).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=max(1.0, end - time.monotonic())) as resp:
        return json.load(resp)["choices"][0]["message"]["content"], seen


def _one_device_answer(model_dir):
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from jlama_tpu_torch.server.openai_api import OpenAIServer
    from jlama_tpu_torch.tokenizers import load_tokenizer

    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    tok = load_tokenizer(model_dir)
    sched = BatchScheduler(params, cfg, tok, n_slots=2, n_pages=32, page_size=8,
                           max_seq_len=64, kv_dtype=torch.float32, device="cpu")
    srv = OpenAIServer(sched, tok)
    ids = srv._encode(srv._render_prompt(BODY)[0])
    ref = sched.generate(ids, max_new_tokens=6)
    assert ref.generated_tokens > 0
    return ref.response_text


def test_serve_mesh_1_1_2_answers_as_one_device(tmp_path):
    model_dir, _ = make_tiny_chat_model(tmp_path / "model")
    store = f"file://{tmp_path / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "jlama_tpu_torch.cli", "serve", str(model_dir), "--mesh",
         "1,1,2", "--num-processes", "2", "--process-id", str(r), "--coordinator", store,
         "--host", "127.0.0.1", "--port", "0", *SERVE],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    end = time.monotonic() + DEADLINE
    try:
        got, _ = _ask(procs[0], end)
    finally:
        for p in procs:  # stopped by PID
            p.kill()
            p.wait(10)
    assert got == _one_device_answer(model_dir)


def test_serve_rank0_alone_starts_the_other_ranks(tmp_path):
    """`serve --mesh 1,1,2 --num-processes 2` with no rank: rank 0 starts
    rank 1 on a file store in a directory of its own, answers as one device
    does, and on an interrupt stops rank 1 and removes that directory."""
    model_dir, _ = make_tiny_chat_model(tmp_path / "model")
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT), TMPDIR=str(tmp))
    lead = subprocess.Popen(
        [sys.executable, "-m", "jlama_tpu_torch.cli", "serve", str(model_dir), "--mesh",
         "1,1,2", "--num-processes", "2", "--host", "127.0.0.1", "--port", "0", *SERVE],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    end = time.monotonic() + DEADLINE
    started, stopped = [], False
    try:
        got, seen = _ask(lead, end)
        started = [int(m.group(1)) for s in seen
                   for m in [re.search(r"started rank 1/2 \(pid (\d+)\)", s)] if m]
        assert len(started) == 1, "".join(seen)
        assert len(list(tmp.glob("jlama_tp_*"))) == 1, list(tmp.iterdir())
        lead.send_signal(signal.SIGINT)  # the server stops, rank 0 publishes stop
        assert lead.wait(max(1.0, end - time.monotonic())) == 0
        stopped = True
    finally:
        if not stopped:  # stopped by PID: rank 0, and the rank it started
            for pid in [lead.pid, *started]:
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            lead.wait(10)
    assert list(tmp.glob("jlama_tp_*")) == [], "rank 0 left its store directory"
    assert got == _one_device_answer(model_dir)


def test_serve_mesh_2_1_1_answers_as_one_device(tmp_path):
    """`serve --mesh 2,1,1 --num-processes 2`: two dp groups of one rank
    each, rank 0 starting rank 1; its greedy answer equals one device's.
    (The batch here has 2 slots: one a group.)"""
    model_dir, _ = make_tiny_chat_model(tmp_path / "model")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path))
    lead = subprocess.Popen(
        [sys.executable, "-m", "jlama_tpu_torch.cli", "serve", str(model_dir), "--mesh",
         "2,1,1", "--num-processes", "2", "--host", "127.0.0.1", "--port", "0", *SERVE],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    end = time.monotonic() + DEADLINE
    started = []
    try:
        got, seen = _ask(lead, end)
        assert any("(dp group 0, tp rank 0)" in s for s in seen), "".join(seen)
        started = [int(m.group(1)) for s in seen
                   for m in [re.search(r"started rank 1/2 \(pid (\d+)\)", s)] if m]
    finally:
        for pid in [lead.pid, *started]:  # stopped by PID
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        lead.wait(10)
    assert len(started) == 1
    assert got == _one_device_answer(model_dir)
