"""The port's command line (`python -m jlama_tpu_torch.cli`) against
jlama_tpu's (`jlama_tpu/cli.py`), in-process on the CPU (`--device cpu`):

- the parser's defaults and choices equal to `jlama_tpu.cli.build_parser()`'s
  for every shared option of every command, `--device` the one option more;
- `complete` and a piped `chat` on `tests/helpers.py::make_tiny_chat_model`
  print the same greedy text as the JAX commands. Both CLIs build their
  `Engine` with bf16 activations, where a tiny random model's near-flat
  logits let the two packages' roundings pick other tokens; so both runs
  here build it in f32 (the engines are wrapped, the commands run as they
  are), where the packages agree (`tests/test_torch_engine.py`);
- `serve` built without blocking (`build_server`) answers a chat request
  with `BatchScheduler.generate`'s greedy text; `--pallas w8a8` builds a q4s
  scheduler; `--pallas off` and the parallel options exit with a message;
- `quantize`, `list`, `rm`, `version` and `download` (a fake hub on
  127.0.0.1) do what the JAX commands do.
"""

import asyncio
import contextlib
import filecmp
import io
import json
import sys

import pytest
import jax.numpy as jnp
import torch

import jlama_tpu.cli as jcli
import jlama_tpu_torch.cli as tcli
from tests.test_torch_hub import fake_hub  # noqa: F401  (a fixture)

COMMANDS = {
    "chat": ["chat", "m"],
    "complete": ["complete", "m", "a prompt"],
    "serve": ["serve", "m"],
    "download": ["download", "m"],
    "quantize": ["quantize", "m"],
    "list": ["list"],
    "rm": ["rm", "m"],
    "version": ["version"],
}


def _subparser(parser, cmd):
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return sub.choices[cmd]


@pytest.mark.parametrize("cmd", list(COMMANDS))
def test_parser_defaults_equal_jax(cmd):
    got = vars(tcli.build_parser().parse_args(COMMANDS[cmd]))
    ref = vars(jcli.build_parser().parse_args(COMMANDS[cmd]))
    extra = {"device"} if cmd in ("chat", "complete", "serve", "quantize") else set()
    assert set(got) == set(ref) | extra
    assert {k: v for k, v in got.items() if k not in extra | {"fn"}} == \
        {k: v for k, v in ref.items() if k != "fn"}
    assert got["fn"].__name__ == ref["fn"].__name__
    if extra:
        assert got["device"] is None
    tp, jp = _subparser(tcli.build_parser(), cmd), _subparser(jcli.build_parser(), cmd)
    jacts = {a.dest: a for a in jp._actions}
    for a in tp._actions:
        if a.dest in jacts:
            b = jacts[a.dest]
            assert (a.option_strings, a.choices, a.type, a.nargs) == \
                (b.option_strings, b.choices, b.type, b.nargs), a.dest


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    from tests.helpers import make_tiny_chat_model

    root = tmp_path_factory.mktemp("cli_home")
    make_tiny_chat_model(root / "tinychat")
    return root


@pytest.fixture
def f32_engines(monkeypatch, home):
    import jlama_tpu.runtime.engine as jengine
    import jlama_tpu_torch.runtime.engine as tengine

    class JEngine(jengine.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, kv_dtype=jnp.float32, compute_dtype=jnp.float32))

    class TEngine(tengine.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, kv_dtype=torch.float32,
                                        compute_dtype=torch.float32))

    monkeypatch.setattr(jengine, "Engine", JEngine)
    monkeypatch.setattr(tengine, "Engine", TEngine)
    monkeypatch.setenv("JLAMA_MODEL_HOME", str(home))


def _run(main, argv, stdin=None):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    finally:
        sys.stdin = old
    return out.getvalue(), err.getvalue()


def _without_timing(text):
    """Printed lines with the timing numbers of the stats lines cut."""
    lines = []
    for line in text.splitlines():
        if line.startswith("[") and ("ms" in line):
            line = line.split(",")[0] if "tokens," in line else line.split(" tok ")[0]
        lines.append(line)
    return lines


def test_complete_prints_jax_greedy_text(f32_engines):
    argv = ["complete", "tinychat", "Hello there, tell me", "--max-tokens", "12",
            "--context", "64", "--working-dtype", "f32"]
    out, err = _run(tcli.main, argv + ["--device", "cpu"])
    ref, ref_err = _run(jcli.main, argv)
    assert out == ref and out.startswith("Hello there, tell me")
    assert _without_timing(err) == _without_timing(ref_err)
    assert "generated 12 tok" in err


def test_piped_chat_prints_jax_greedy_text(f32_engines):
    argv = ["chat", "tinychat", "--max-tokens", "6", "--context", "96",
            "--working-dtype", "f32", "--system", "be brief"]
    turns = "hello\n\nTell me a story\n"
    out, _ = _run(tcli.main, argv + ["--device", "cpu"], turns)
    ref, _ = _run(jcli.main, argv, turns)
    assert out.startswith("Chatting (ctrl-d to exit)")
    assert _without_timing(out) == _without_timing(ref)
    assert out.count("[6 tokens,") == 2


def _serve_args(home, *extra):
    return tcli.build_parser().parse_args(
        ["serve", str(home / "tinychat"), "--device", "cpu", "--batch-slots", "2",
         "--kv-pages", "32", "--page-size", "8", "--context", "64",
         "--kv-dtype", "f32", "--working-dtype", "f32", *extra])


def test_serve_builds_without_blocking_and_answers(home):
    import http.client

    from jlama_tpu_torch.prompt import PromptBuilder

    server, model_dir = tcli.build_server(_serve_args(home, "--prefill-fair-rows", "2",
                                                      "--itl-budget-ms", "50"))
    sched = server.sched
    assert model_dir.name == "tinychat" and server.model_name == "tinychat"
    assert sched.prefill_fair_rows == 2 and sched.itl_budget_ms == 50
    shared = sched.embed_engine.params  # one copy of the weights: every leaf shared
    assert all(shared["layers"][i][k] is v for i, d in enumerate(sched.params["layers"])
               for k, v in d.items())
    assert shared["embed"] is sched.params["embed"]
    b = PromptBuilder(server.tokenizer.spec)
    b.add_user("Tell me a story")
    ids = server.tokenizer.encode(b.build().prompt)
    want = sched.generate(ids, max_new_tokens=8).response_text

    async def ask():
        port = await server.start("127.0.0.1", 0)
        body = json.dumps({"messages": [{"role": "user", "content": "Tell me a story"}],
                           "max_tokens": 8, "temperature": 0})

        def post():
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            c.request("POST", "/v1/chat/completions", body,
                      {"Content-Type": "application/json"})
            r = c.getresponse()
            return r.status, json.loads(r.read())

        try:
            return await asyncio.get_running_loop().run_in_executor(None, post)
        finally:
            await server.close()
            sched.stop()

    status, answer = asyncio.run(ask())
    assert status == 200
    assert answer["choices"][0]["message"]["content"] == want


def test_serve_w8a8_prewarm_and_exits(home, monkeypatch):
    from jlama_tpu_torch.runtime import scheduler

    made, warmed = [], []
    inner = scheduler.BatchScheduler.__init__

    def spy(self, *a, **kw):
        made.append(kw.get("weight_format"))
        inner(self, *a, **kw)

    monkeypatch.setattr(scheduler.BatchScheduler, "__init__", spy)
    monkeypatch.setattr(scheduler.BatchScheduler, "warmup",
                        lambda self, max_context=None: warmed.append(max_context))
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.build_server(_serve_args(home, "--pallas", "w8a8", "--prewarm", "32"))
    assert made == ["q4s"] and warmed == [32]
    with pytest.raises(SystemExit, match="dequantizing"):
        tcli.build_server(_serve_args(home, "--pallas", "off"))
    # pp meshes are served (tests/test_torch_pp_cli.py): their refusals are
    # the JAX pipeline's (the layers must divide by pp) and a world's
    for opt in (["--mesh", "2,2,1", "--num-processes", "2"],
                ["--mesh", "1,2,2", "--num-processes", "2"], ["--coordinator", "h:1"],
                ["--num-processes", "2"], ["--process-id", "0"], ["--step-port", "9"],
                ["--no-pp-pipeline", "--num-processes", "2"],
                ["--mesh", "1,1,2", "--num-processes", "4"],
                ["--mesh", "2,1,2", "--num-processes", "2"]):
        with pytest.raises(SystemExit, match="module 10|one process a rank"):
            tcli.build_server(_serve_args(home, *opt))
    with pytest.raises(SystemExit, match="n_layers must divide by pp"):
        tcli.build_server(_serve_args(home, "--mesh", "1,3,1", "--no-pp-pipeline"))
    for mesh in ("1,1,2", "2,1,1", "2,1,2", "2,2,1", "1,2,2"):  # served meshes: every rank
        with pytest.raises(SystemExit, match="--process-id and the same --coordinator"):
            tcli.build_server(_serve_args(home, "--mesh", mesh))
    assert made == ["q4s"]  # the exits come before any loading


def test_quantize_command_matches_jax(home, tmp_path, monkeypatch):
    monkeypatch.setenv("JLAMA_MODEL_HOME", str(home))
    for main, out, extra in ((tcli.main, "t", ["--device", "cpu"]), (jcli.main, "j", [])):
        _run(main, ["quantize", "tinychat", "--output", str(tmp_path / out),
                    "--skip-prefix", "q_proj", "--drop-prefix", "lm_head"] + extra)
    for f in ("model.safetensors", "config.json", "tokenizer.json", "README.md"):
        assert filecmp.cmp(tmp_path / "t" / f, tmp_path / "j" / f, shallow=False), f


def test_list_rm_version_and_missing_model(tmp_path, monkeypatch):
    from tests.helpers import make_tiny_llama

    monkeypatch.setenv("JLAMA_MODEL_HOME", str(tmp_path))
    out, err = _run(tcli.main, ["list"])
    assert out == "" and "no models" in err
    make_tiny_llama(tmp_path / "victim")
    assert _run(tcli.main, ["list"]) == _run(jcli.main, ["list"])
    assert _run(tcli.main, ["list"])[0] == "victim\n"
    out, _ = _run(tcli.main, ["rm", "victim"])
    assert out.startswith("Removed") and not (tmp_path / "victim").exists()
    with pytest.raises(SystemExit, match="model not found"):
        _run(tcli.main, ["rm", "victim"])
    assert _run(tcli.main, ["version"]) == _run(jcli.main, ["version"])
    with pytest.raises(SystemExit, match="model not found: nothing"):
        _run(tcli.main, ["complete", "nothing", "x", "--device", "cpu"])


def test_download_command(fake_hub, monkeypatch):  # noqa: F811
    files, hits, tmp_path = fake_hub
    out, _ = _run(tcli.main, ["download", "acme/tiny"])
    dest = tmp_path / "home" / "acme_tiny"
    assert f"Downloaded to {dest}" in out and "config.json: done" in out
    for name, data in files.items():
        if name != "README.md":
            assert (dest / name).read_bytes() == data
    assert _run(tcli.main, ["list"])[0] == "acme_tiny\n"
