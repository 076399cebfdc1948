"""Rules of the port package: no JAX and nothing of jlama_tpu, no optional
text-processing or HTTP packages anywhere in it (the tokenizer, the chat
templates and the HTTP server run on the standard library), CUDA by default
with no quiet CPU fall-back, and plain versions on the CPU."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "jlama_tpu_torch"
OPTIONAL = ("regex", "jinja2", "ml_dtypes", "safetensors", "transformers", "tokenizers",
            "aiohttp", "huggingface_hub", "requests")
# the one exception: the generator of tokenizers/_uniclass.py reads `regex`'s
# tables, and nothing imports it
GENERATOR = PKG / "scripts" / "gen_uniclass.py"


def _imports(path: Path, top_level_only: bool = False):
    tree = ast.parse(path.read_text())
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_jlama_tpu():
    files = _port_files()
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root != "jax" and root != "jaxlib", f"{f}: imports {mod}"
            assert root != "jlama_tpu", f"{f}: imports {mod}"


TP_MODULES = ("parallel/mesh.py", "parallel/tp_forward.py", "parallel/distributed.py",
              "runtime/coordination.py")


def test_tp_modules_import_no_jax_and_nothing_of_jlama_tpu():
    """The tp serving modules are among the files the import rule reads, and
    import with jax, jaxlib and jlama_tpu blocked (each keeps its own copy of
    what it needs from jlama_tpu, runtime/coordination.py's too)."""
    files = set(_port_files())
    for rel in TP_MODULES:
        assert PKG / rel in files, rel
        for mod in _imports(PKG / rel):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "jlama_tpu"), (rel, mod)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'jlama_tpu'):\n"
        "    sys.modules[m] = None\n"
        + "".join(f"import jlama_tpu_torch.{rel[:-3].replace('/', '.')}\n" for rel in TP_MODULES)
        + "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_optional_packages_only_in_tokenizers():
    """No file of the port imports an optional package, at its top or inside
    a function, but the table generator, which nothing imports."""
    for f in _port_files():
        for mod in _imports(f):
            if mod.split(".")[0] in OPTIONAL:
                assert f == GENERATOR and mod == "regex", (f, mod)
            assert "gen_uniclass" not in mod, (f, mod)
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert "gen_uniclass" not in (node.module or "") and \
                    all(a.name != "gen_uniclass" for a in node.names), f


def test_text_and_http_front_import_and_run_without_optional_packages(tmp_path):
    """With regex, jinja2 and aiohttp blocked, the tokenizer (WordPiece too),
    the chat templates and the server import, a prompt renders and encodes (a
    tokenizer.json in chip_smoke.py's Llama-3 layout, its Split pattern
    through the translated classes), and a WordPiece text encodes and
    decodes."""
    code = (
        "import sys\n"
        "sys.modules['regex'] = sys.modules['jinja2'] = sys.modules['aiohttp'] = None\n"
        "import jlama_tpu_torch.tokenizers, jlama_tpu_torch.prompt\n"
        "import jlama_tpu_torch.tokenizers.wordpiece\n"
        "import jlama_tpu_torch.server.openai_api\n"
        "import chip_smoke as cs\n"
        "from jlama_tpu_torch.tokenizers import Tokenizer, parse_tokenizer_json\n"
        "from jlama_tpu_torch.prompt import PromptBuilder\n"
        "tok = Tokenizer(parse_tokenizer_json(cs.front_tokenizer_json(2048, 16),\n"
        "                                     cs.FRONT_TOKENIZER_CONFIG))\n"
        "ctx = PromptBuilder(tok.spec).add_system('Be brief.').add_user(\n"
        "    'x² ½ café 你好 १२३ it\\'s 12345!').build()\n"
        "ids = tok.encode(ctx.prompt)\n"
        "assert ids[0] == tok.bos_id == 2048 and tok.decode(ids) == tok.decode(\n"
        "    tok.encode(tok.decode(ids)))\n"
        "assert tok.decode(ids, skip_special=False) == ctx.prompt, ctx.prompt\n"
        "wp = Tokenizer(parse_tokenizer_json({'model': {'type': 'WordPiece', 'vocab': {\n"
        "    '[UNK]': 0, 'hello': 1, 'wor': 2, '##ld': 3, ',': 4}, 'unk_token': '[UNK]'},\n"
        "    'normalizer': {'type': 'BertNormalizer', 'lowercase': True}}))\n"
        "assert wp.encode('Hello, world zz') == [1, 4, 2, 3, 0], wp.encode('Hello, world zz')\n"
        "assert wp.decode([1, 4, 2, 3]) == 'hello, world'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('regex', 'jinja2', 'aiohttp',\n"
        "       'jax', 'jlama_tpu') and sys.modules[m] is not None]\n"
        "print(bad, len(ids))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[] "), out.stdout


def test_engine_import_path_is_clean():
    """The Engine, serving (scheduler, paged KV, metrics, q4s), perplexity,
    card-bench, command-line, quantizer, hub and HTTP-loader paths pull in
    none of jax, jlama_tpu, the optional packages or aiohttp."""
    code = (
        "import sys\n"
        "import jlama_tpu_torch.runtime.engine, jlama_tpu_torch.models.loader\n"
        "import jlama_tpu_torch.models.init, jlama_tpu_torch.models.convert\n"
        "import jlama_tpu_torch.runtime.scheduler, jlama_tpu_torch.kv.paged\n"
        "import jlama_tpu_torch.utils.metrics, jlama_tpu_torch.ops.w8a8\n"
        "import jlama_tpu_torch.ops.moe_q4, jlama_tpu_torch.ops.moe_float\n"
        "import jlama_tpu_torch.eval.ppl\n"
        "import jlama_tpu_torch.cli, jlama_tpu_torch.hub, jlama_tpu_torch.quant.quantizer\n"
        "import jlama_tpu_torch.st.http_loader, jlama_tpu_torch.st.splitter\n"
        "import jlama_tpu_torch.scripts.kbench_q4, jlama_tpu_torch.scripts.kbench_w8a8\n"
        "import jlama_tpu_torch.scripts.probe_int4, jlama_tpu_torch.scripts.probe_sigma_i16\n"
        "import jlama_tpu_torch.parallel.mesh, jlama_tpu_torch.parallel.tp_forward\n"
        "import jlama_tpu_torch.parallel.distributed, jlama_tpu_torch.runtime.coordination\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{OPTIONAL + ('jax', 'jlama_tpu', 'aiohttp')!r}]\n"
        "bad += [m for m in sys.modules if m.startswith('jlama_tpu_torch.tokenizers')]\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_cli_help_imports_no_jax_and_needs_cuda_or_device_cpu():
    """`python -m jlama_tpu_torch.cli --help` runs with jax, jlama_tpu and the
    optional packages blocked and lists the eight commands; without CUDA and
    without `--device cpu` a model command exits with `resolve_device`'s
    message (before it looks for the model)."""
    blocked = OPTIONAL + ("jax", "jaxlib", "jlama_tpu")
    code = (
        "import contextlib, io, runpy, sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "out = io.StringIO()\n"
        "sys.argv = ['jlama_tpu_torch.cli', '--help']\n"
        "try:\n"
        "    with contextlib.redirect_stdout(out):\n"
        "        runpy.run_module('jlama_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(out.getvalue())\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from jlama_tpu_torch.cli import main\n"
        "for argv in (['complete', 'nowhere', 'hi'], ['chat', 'nowhere'],\n"
        "             ['serve', 'nowhere'], ['quantize', 'nowhere']):\n"
        "    try:\n"
        "        main(argv)\n"
        "    except SystemExit as e:\n"
        "        print('EXIT', argv[0], e.code)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("chat", "complete", "serve", "download", "quantize", "list", "rm",
                "version"):
        assert cmd in out.stdout.split("EXIT")[0]
    exits = [line for line in out.stdout.splitlines() if line.startswith("EXIT")]
    assert len(exits) == 4, out.stdout
    for line in exits:
        assert "no CUDA device is available; pass device='cpu'" in line \
            and "--device cpu" in line, line


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from jlama_tpu_torch.kv.paged import PagedKVCache
    from jlama_tpu_torch.models.convert import from_jax_kv_state, from_jax_params
    from jlama_tpu_torch.models.init import (bert_base_config, gpt2_config, init_params,
                                             llama_1b_config, mixtral_8x7b_config,
                                             random_q4_params)
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from jlama_tpu_torch.config import from_hf_config
    from tests.helpers import TINY_LLAMA_CONFIG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = from_hf_config(TINY_LLAMA_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_q4_params(llama_1b_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        random_q4_params(mixtral_8x7b_config())
    for c in (gpt2_config(), bert_base_config()):
        with pytest.raises(RuntimeError, match="CUDA"):
            random_q4_params(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(ROOT / "no_such_model")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"embed": np.zeros((4, 32), np.float32), "layers": []})
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg)
    assert Engine(params, cfg, device="cpu").device.type == "cpu"
    # the embedding entry points run on the Engine's device: CUDA unless named
    bert = from_hf_config(dict(BERT_TINY, id2label={0: "a", 1: "b"}))
    bert_params = init_params(bert, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(bert_params, bert)
    eng = Engine(bert_params, bert, device="cpu", compute_dtype=torch.float32)
    vec = eng.embed_batch([[1, 2, 3]], pooling="CLS")[0]
    assert vec.shape == (bert.embedding_length,) and isinstance(vec, np.ndarray)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchScheduler(params, cfg, n_slots=2, n_pages=8, page_size=8, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(cfg, n_pages=8, page_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_kv_state((np.zeros((1, 1, 2, 2, 16), np.float32),) * 2)
    sched = BatchScheduler(params, cfg, n_slots=2, n_pages=8, page_size=8, max_seq_len=32,
                           device="cpu")
    assert sched.device.type == "cpu" and sched.kv.state.k_pool.device.type == "cpu"


def test_cpu_run_goes_through_plain_versions(monkeypatch):
    """A device="cpu" generation at head size 64 reaches the q4, flash-prefill
    and paged-decode wrappers (the last for each decode step's attention on
    the dense cache), which run the plain versions and count no launch."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.ops import attention, q4_matmul
    from jlama_tpu_torch.runtime.engine import Engine
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(dict(TINY_LLAMA_CONFIG, hidden_size=128, num_attention_heads=2,
                              num_key_value_heads=1))
    assert cfg.head_size == 64
    calls = {"q4": 0, "flash": 0, "paged": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(q4_matmul, "q4_matmul_plain",
                        counting("q4", q4_matmul.q4_matmul_plain))
    monkeypatch.setattr(attention, "flash_prefill_plain",
                        counting("flash", attention.flash_prefill_plain))
    monkeypatch.setattr(attention, "paged_decode_plain",
                        counting("paged", attention.paged_decode_plain))
    fns = (q4_matmul.q4_matmul, attention.flash_prefill, attention.paged_decode)
    launches = [f.launches for f in fns]
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    eng = Engine(params, cfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    resp = eng.generate_tokens(list(range(1, 12)), max_new_tokens=3, stop_ids=set())
    assert len(resp.token_ids) == 3
    # prefill: 4 q4 matmuls per layer, 1 flash per layer; decode adds lm_head
    # (float embedding, tied: torch.matmul) and 4 per layer per step
    assert calls["flash"] == cfg.n_layers
    assert calls["q4"] == 4 * cfg.n_layers * (1 + 3)
    assert calls["paged"] == cfg.n_layers * 3
    assert [f.launches for f in fns] == launches


def test_chip_smoke_refuses_without_gpu_or_package(tmp_path):
    """chip_smoke.py exits non-zero, with no result line, when it stands alone
    in a directory, and when torch has no CUDA device."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    scripts = [alone] + ([] if torch.cuda.is_available() else [ROOT / "chip_smoke.py"])
    for script in scripts:
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and '"ok"' not in r.stdout, (script, r.stdout, r.stderr)
        assert "FAIL" in r.stderr


def test_wrappers_reject_other_devices():
    from jlama_tpu_torch.nn.qarray import quantize_q4
    from jlama_tpu_torch.ops.attention import flash_prefill, paged_decode
    from jlama_tpu_torch.ops.kv_write import kv_write
    from jlama_tpu_torch.ops.moe_q4 import MoEGroups, moe_gather, moe_groups, moe_q4_matmul
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul

    w = quantize_q4(np.ones((8, 32), np.float32)).to("meta")
    with pytest.raises(ValueError, match="device"):
        q4_matmul(torch.ones((1, 32), device="meta"), w)
    we = quantize_q4(np.ones((4, 8, 32), np.float32)).to("meta")
    ids = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        moe_q4_matmul(torch.ones((1, 32), device="meta"), we, ids)
    with pytest.raises(ValueError, match="device"):
        moe_groups(ids, 4)
    meta_groups = MoEGroups(*(torch.zeros(2, dtype=torch.int32, device="meta"),) * 5)
    with pytest.raises(ValueError, match="device"):
        moe_gather(torch.ones((1, 32), device="meta"), meta_groups, 2)
    q = torch.ones((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_prefill(q, q, q, torch.zeros(1, dtype=torch.int32), 0.1)
    pool = torch.ones((2, 4, 8, 64), device="meta")
    pt = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        paged_decode(torch.ones((1, 4, 64), device="meta"), pool, pool, pt,
                     torch.ones(1, dtype=torch.int32), 0.1)
    rows = torch.ones((1, 1, 2, 64), device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="device"):
        kv_write(pool, pool, rows, rows, pt, pos)
    # the RoPE arguments: on another device than the rows, or with them
    q = torch.ones((1, 1, 4, 64), device="meta")
    cs = torch.ones((1, 1, 32), device="meta")
    with pytest.raises(ValueError, match="device"):
        kv_write(pool, pool, rows, rows, pt, pos, q=q, cos=cs, sin=cs)
    cpu_pool, cpu_rows = torch.ones((2, 4, 8, 64)), torch.ones((1, 1, 2, 64))
    cpu_q, cpu_cs = torch.ones((1, 1, 4, 64)), torch.ones((1, 1, 32))
    for bad in (dict(q=q, cos=cpu_cs, sin=cpu_cs), dict(q=cpu_q, cos=cs, sin=cs)):
        with pytest.raises(ValueError, match="device"):
            kv_write(cpu_pool, cpu_pool, cpu_rows, cpu_rows, pt, pos, **bad)


BERT_TINY = dict(model_type="bert", hidden_size=128, num_attention_heads=2, num_hidden_layers=2,
                 intermediate_size=256, vocab_size=96, max_position_embeddings=64)


def test_cpu_embeddings_go_through_plain_versions(monkeypatch):
    """A device="cpu" Engine.embed_batch over a q4 BERT at head size 64 sends
    its 4 projections a layer to K1's wrapper (its plain version, no launch)
    and takes the dense masked attention (BERT is not causal): no K2, K3 or
    K4; a causal Llama's embed_batch takes K3's plain version."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.ops import attention, kv_write as kvw, q4_matmul
    from jlama_tpu_torch.runtime.engine import Engine
    from tests.helpers import TINY_LLAMA_CONFIG

    calls = {"q4": 0, "flash": 0, "paged": 0, "kv": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(q4_matmul, "q4_matmul_plain", counting("q4", q4_matmul.q4_matmul_plain))
    monkeypatch.setattr(attention, "flash_prefill_plain",
                        counting("flash", attention.flash_prefill_plain))
    monkeypatch.setattr(attention, "paged_decode_plain",
                        counting("paged", attention.paged_decode_plain))
    monkeypatch.setattr(kvw, "kv_write_plain", counting("kv", kvw.kv_write_plain))
    fns = (q4_matmul.q4_matmul, attention.flash_prefill, attention.paged_decode, kvw.kv_write)
    launches = [f.launches for f in fns]
    cfg = from_hf_config(BERT_TINY)
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    eng = Engine(params, cfg, device="cpu", compute_dtype=torch.float32)
    vecs = eng.embed_batch([[1, 2, 3], list(range(1, 40))], pooling="AVG")
    assert len(vecs) == 2
    assert calls == {"q4": 4 * cfg.n_layers, "flash": 0, "paged": 0, "kv": 0}
    llama = from_hf_config(dict(TINY_LLAMA_CONFIG, hidden_size=128, num_attention_heads=2,
                                num_key_value_heads=1))
    eng = Engine(init_params(llama, seed=0, quantize="q4", device="cpu", dtype=torch.float32),
                 llama, device="cpu", compute_dtype=torch.float32)
    eng.embed_batch([[1, 2, 3], list(range(1, 40))], pooling="MODEL")
    assert calls["flash"] == llama.n_layers and calls["paged"] == calls["kv"] == 0
    assert [f.launches for f in fns] == launches


def test_cpu_serving_goes_through_plain_versions(monkeypatch):
    """A device="cpu" scheduler at head size 64 reaches the paged-decode, KV
    write, flash-prefill and q4 wrappers, which run their plain versions
    (as often as the scheduler's prefill calls and decode steps imply) and
    count no launch."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.ops import attention, kv_write as kvw, q4_matmul
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(dict(TINY_LLAMA_CONFIG, hidden_size=128, num_attention_heads=2,
                              num_key_value_heads=1))
    calls = {"q4": 0, "flash": 0, "paged": 0, "kv": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(q4_matmul, "q4_matmul_plain", counting("q4", q4_matmul.q4_matmul_plain))
    monkeypatch.setattr(attention, "flash_prefill_plain",
                        counting("flash", attention.flash_prefill_plain))
    monkeypatch.setattr(attention, "paged_decode_plain",
                        counting("paged", attention.paged_decode_plain))
    monkeypatch.setattr(kvw, "kv_write_plain", counting("kv", kvw.kv_write_plain))
    fns = (q4_matmul.q4_matmul, attention.flash_prefill, attention.paged_decode, kvw.kv_write)
    launches = [f.launches for f in fns]
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    sched = BatchScheduler(params, cfg, n_slots=2, n_pages=16, page_size=8, max_seq_len=64,
                           kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu")
    resp = sched.generate(list(range(1, 12)), max_new_tokens=3, stop_ids={-1})
    assert len(resp.token_ids) == 3
    L, n_pf, n_dec = cfg.n_layers, sched.n_prefill_calls, sched.n_decode_steps
    assert (n_pf, n_dec) == (1, 3)
    assert calls == {"q4": 4 * L * (n_pf + n_dec), "flash": L * n_pf, "paged": L * n_dec,
                     "kv": L * (n_pf + n_dec)}
    assert [f.launches for f in fns] == launches


def test_cpu_q4s_serving_goes_through_plain_versions(monkeypatch):
    """A device="cpu" scheduler with weight_format="q4s" sends every
    projection and the tied lm_head to K5's wrapper, which runs the plain
    version (4 per layer per forward, and the lm_head per decode step) and
    counts no launch; K1 is not reached."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.nn.qarray import quantize_q4
    from jlama_tpu_torch.ops import q4_matmul, w8a8
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(dict(TINY_LLAMA_CONFIG, hidden_size=256, intermediate_size=512,
                              tie_word_embeddings=True))
    calls = {"q4s": 0, "q4": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(w8a8, "q4s_matmul_plain", counting("q4s", w8a8.q4s_matmul_plain))
    monkeypatch.setattr(q4_matmul, "q4_matmul_plain", counting("q4", q4_matmul.q4_matmul_plain))
    launches = (w8a8.q4s_matmul.launches, q4_matmul.q4_matmul.launches)
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    params["embed"] = quantize_q4(params["embed"].numpy())
    sched = BatchScheduler(params, cfg, n_slots=2, n_pages=16, page_size=8, max_seq_len=64,
                           kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
                           weight_format="q4s")
    resp = sched.generate(list(range(1, 12)), max_new_tokens=3, stop_ids={-1})
    assert len(resp.token_ids) == 3
    L, n_pf, n_dec = cfg.n_layers, sched.n_prefill_calls, sched.n_decode_steps
    assert calls == {"q4s": 4 * L * (n_pf + n_dec) + n_dec, "q4": 0}
    assert (w8a8.q4s_matmul.launches, q4_matmul.q4_matmul.launches) == launches


def test_bench_mains_need_cuda_or_explicit_cpu(monkeypatch):
    """Each card bench's main() raises without a GPU unless --device cpu is
    given (k1_ablate, k3_ablate, k5_ablate and k6_ablate run on the card only), and its
    wrappers raise on a device that is neither."""
    from jlama_tpu_torch.scripts import (k1_ablate, k3_ablate, k5_ablate, k6_ablate, kbench_q4,
                                         kbench_w8a8, probe_int4, probe_sigma_i16)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (kbench_q4, kbench_w8a8, probe_int4, probe_sigma_i16, k1_ablate, k3_ablate,
                k5_ablate, k6_ablate):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
    meta = {dt: torch.empty((8, 256), dtype=dt, device="meta")
            for dt in (torch.bfloat16, torch.uint8, torch.int8, torch.float32)}
    with pytest.raises(ValueError, match="device"):
        kbench_q4.v3a(meta[torch.bfloat16], meta[torch.uint8], meta[torch.bfloat16])
    with pytest.raises(ValueError, match="device"):
        probe_int4.u4_bitcast(meta[torch.bfloat16], meta[torch.uint8], meta[torch.bfloat16])
    with pytest.raises(ValueError, match="device"):
        probe_sigma_i16.c_i16mul_i32dot(meta[torch.int8], meta[torch.uint8], meta[torch.uint8])
    with pytest.raises(ValueError, match="device"):
        kbench_w8a8.pk4(meta[torch.bfloat16], meta[torch.uint8], meta[torch.float32],
                        xq=meta[torch.int8])


@pytest.mark.parametrize("script,source,table", [("k1_ablate", "q4_matmul", "ABLATIONS"),
                                                 ("k3_ablate", "flash_prefill", "ABLATIONS"),
                                                 ("k5_ablate", "w8a8_matmul", "ABLATIONS"),
                                                 ("k5_ablate", "w8a8_matmul",
                                                  "DECODE_ABLATIONS"),
                                                 ("k2_ablate", "paged_decode", "ABLATIONS"),
                                                 ("k6_ablate", "moe_q4", "DECODE_ABLATIONS")])
def test_ablation_cuts_apply_to_the_source(script, source, table):
    """Every cut of an ablation script finds its text in the kernel source
    exactly once (on the card the script raises when one does not)."""
    import importlib

    from jlama_tpu_torch.ops import _build

    cuts = getattr(importlib.import_module(f"jlama_tpu_torch.scripts.{script}"), table)
    src = (_build.CSRC / f"{source}.cu").read_text()
    for name, subs in cuts.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
