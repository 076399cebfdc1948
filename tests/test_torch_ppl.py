"""The port's perplexity harness (jlama_tpu_torch.eval.ppl) held against
jlama_tpu.eval.ppl on the same tiny checkpoints, and the q4s quality gate
through the port's W4A8 path (int8 activations, K5's plain version)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import make_tiny_llama

from jlama_tpu_torch.eval.ppl import evaluate_file, score_tokens
from jlama_tpu_torch.models.loader import load_params
from jlama_tpu_torch.nn.qarray import quantize_q4
from jlama_tpu_torch.ops import w8a8


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tiny_torch_ppl"))
    jparams, jcfg = jload(model_dir, float_dtype=jnp.float32)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return (jparams, jcfg), (params, cfg)


@pytest.mark.parametrize("n,seq_len,stride", [
    (96, 96, 48),  # one full window
    (160, 64, 32),  # full windows, then an exact partial tail
    (120, 64, 64),  # windows that do not overlap
])
def test_score_tokens_matches_jax(tiny, n, seq_len, stride):
    """Same sliding-window protocol and counts: perplexities within 1e-5
    relative (f32 forwards, sums in another order)."""
    from jlama_tpu.eval.ppl import score_tokens as jscore

    (jparams, jcfg), (params, cfg) = tiny
    ids = np.random.default_rng(n).integers(0, 256, n).astype(np.int32)
    ref = jscore(jparams, jcfg, ids, seq_len=seq_len, stride=stride)
    got = score_tokens(params, cfg, ids, seq_len=seq_len, stride=stride, device="cpu")
    assert abs(got - ref) / ref < 1e-5, (got, ref)


def test_score_tokens_needs_cuda_or_explicit_cpu(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (params, cfg) = tiny
    with pytest.raises(RuntimeError, match="CUDA"):
        score_tokens(params, cfg, np.arange(1, 20), seq_len=16, stride=8)


def test_evaluate_file_matches_jax(tmp_path):
    from jlama_tpu.eval.ppl import evaluate_file as jevaluate
    from tests.helpers import make_tiny_chat_model

    model_dir, _ = make_tiny_chat_model(tmp_path / "m")
    text = tmp_path / "corpus.txt"
    text.write_text("The weather is nice. Tell me a story about a fox. " * 8)
    ref = jevaluate(model_dir, text, seq_len=48, stride=24, max_tokens=150)
    got = evaluate_file(model_dir, text, seq_len=48, stride=24, max_tokens=150, device="cpu")
    assert abs(got - ref) / ref < 1e-5, (got, ref)


def test_q4s_ppl_delta_vs_q4(tmp_path_factory, monkeypatch):
    """The q4s re-rounding and K5's int8 activations move perplexity by less
    than 3% against q4 (analog of tests/test_ppl.py's gate, here through the
    port's own W4A8 path: every projection and the tied lm_head take
    q4s_matmul's plain version)."""
    model_dir, _ = make_tiny_llama(
        tmp_path_factory.mktemp("tiny_torch_ppl_q4s"),
        {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
         "num_key_value_heads": 2, "tie_word_embeddings": True},
    )
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    q4 = dict(params, embed=quantize_q4(params["embed"].numpy()), layers=[
        {k: quantize_q4(v.numpy()) if v.dim() == 2 else v for k, v in layer.items()}
        for layer in params["layers"]])
    q4s = w8a8.prepare_params_for_w8a8(q4)
    assert q4s["lm_head"].fmt == "q4s"
    assert {v.fmt for layer in q4s["layers"] for v in layer.values()
            if hasattr(v, "fmt")} == {"q4s"}
    calls = []
    plain = w8a8.q4s_matmul_plain
    monkeypatch.setattr(w8a8, "q4s_matmul_plain", lambda *a: calls.append(1) or plain(*a))
    ids = np.random.default_rng(5).integers(0, 256, 96).astype(np.int32)
    p_q4 = score_tokens(q4, cfg, ids, seq_len=96, stride=48, device="cpu")
    assert not calls
    p_q4s = score_tokens(q4s, cfg, ids, seq_len=96, stride=48, device="cpu")
    assert len(calls) == 7 * cfg.n_layers + 1  # wq wk wv wo w1 w3 w2 per layer, lm_head
    assert abs(p_q4s - p_q4) / p_q4 < 0.03, (p_q4s, p_q4)
