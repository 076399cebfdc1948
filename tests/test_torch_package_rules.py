"""Rules of the port package: no JAX and nothing of jlama_tpu, no optional
text-processing packages on the Engine/load_params import path, CUDA by
default with no quiet CPU fall-back, and plain versions on the CPU."""

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
OPTIONAL = ("regex", "jinja2", "ml_dtypes", "safetensors", "transformers", "tokenizers")


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


def test_optional_packages_only_in_tokenizers():
    for f in _port_files():
        for mod in _imports(f, top_level_only=True):
            if mod.split(".")[0] in OPTIONAL:
                assert f == PKG / "tokenizers" / "bpe.py" and mod == "regex", (f, mod)


def test_engine_import_path_is_clean():
    code = (
        "import sys\n"
        "import jlama_tpu_torch.runtime.engine, jlama_tpu_torch.models.loader\n"
        "import jlama_tpu_torch.models.init, jlama_tpu_torch.models.convert\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {OPTIONAL + ('jax', 'jlama_tpu')!r}]\n"
        "bad += [m for m in sys.modules if m.startswith('jlama_tpu_torch.tokenizers')]\n"
        "print(sorted(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from jlama_tpu_torch.models.convert import from_jax_params
    from jlama_tpu_torch.models.init import init_params, llama_1b_config, random_q4_params
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.config import from_hf_config
    from tests.helpers import TINY_LLAMA_CONFIG

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = from_hf_config(TINY_LLAMA_CONFIG)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_q4_params(llama_1b_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(ROOT / "no_such_model")
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({"embed": np.zeros((4, 32), np.float32), "layers": []})
    params = init_params(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg)
    assert Engine(params, cfg, device="cpu").device.type == "cpu"


def test_cpu_run_goes_through_plain_versions(monkeypatch):
    """A device="cpu" generation at head size 64 reaches both kernels'
    wrappers, which run the plain versions and count no launch."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.ops import attention, q4_matmul
    from jlama_tpu_torch.runtime.engine import Engine
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(dict(TINY_LLAMA_CONFIG, hidden_size=128, num_attention_heads=2,
                              num_key_value_heads=1))
    assert cfg.head_size == 64
    calls = {"q4": 0, "flash": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(q4_matmul, "q4_matmul_plain",
                        counting("q4", q4_matmul.q4_matmul_plain))
    monkeypatch.setattr(attention, "flash_prefill_plain",
                        counting("flash", attention.flash_prefill_plain))
    launches = (q4_matmul.q4_matmul.launches, attention.flash_prefill.launches)
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    eng = Engine(params, cfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    resp = eng.generate_tokens(list(range(1, 12)), max_new_tokens=3, stop_ids=set())
    assert len(resp.token_ids) == 3
    # prefill: 4 q4 matmuls per layer, 1 flash per layer; decode adds lm_head
    # (float embedding, tied: torch.matmul) and 4 per layer per step
    assert calls["flash"] == cfg.n_layers
    assert calls["q4"] == 4 * cfg.n_layers * (1 + 3)
    assert (q4_matmul.q4_matmul.launches, attention.flash_prefill.launches) == launches


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
    from jlama_tpu_torch.ops.attention import flash_prefill
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul

    w = quantize_q4(np.ones((8, 32), np.float32)).to("meta")
    with pytest.raises(ValueError, match="device"):
        q4_matmul(torch.ones((1, 32), device="meta"), w)
    q = torch.ones((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        flash_prefill(q, q, q, torch.zeros(1, dtype=torch.int32), 0.1)
