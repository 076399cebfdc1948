"""The port's trained-weights perplexity script
(`jlama_tpu_torch/scripts/ppl_trained.py`) against the JAX one
(`scripts/ppl_trained.py`), on the CPU: the same Markov corpora array for
array, the same quantized layers for q4, q8 and q4s, and five Adam steps at
the `--small` widths (batch 4, 33 tokens) from the same initial tree with
the loss trace within 1e-3 relative. The 150-step budget test
(tests/test_ppl_trained.py's analog) is marked slow, outside tier-1.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.test_torch_bridge import assert_trees_equal, port_tree

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

TRACE_TOL = 1e-3


def _jax_script():
    import ppl_trained

    return ppl_trained


@pytest.mark.parametrize("seed,n", [(1, 5_000), (2, 4_000), (7, 1_000)])
def test_markov_corpus_equals_jax(seed, n):
    from jlama_tpu_torch.scripts.ppl_trained import markov_corpus

    want = _jax_script().markov_corpus(256, n, seed=seed)
    got = markov_corpus(256, n, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def full_tree():
    """The full-size config's JAX init (6 layers, d 256: every K a multiple
    of 256, so q4s converts) and the port's config."""
    from jlama_tpu.config import from_hf_config
    from jlama_tpu.models.init import init_params
    from jlama_tpu_torch.scripts.ppl_trained import config

    cfg = config(small=False)
    jcfg = from_hf_config({"model_type": "llama", "hidden_size": 256, "intermediate_size": 768,
                           "num_attention_heads": 8, "num_key_value_heads": 4,
                           "num_hidden_layers": 6, "rms_norm_eps": 1e-5, "vocab_size": 256,
                           "max_position_embeddings": 512, "rope_theta": 10000.0,
                           "bos_token_id": 0, "eos_token_id": 0, "hidden_act": "silu"})
    assert (cfg.embedding_length, cfg.hidden_length, cfg.n_layers) == (
        jcfg.embedding_length, jcfg.hidden_length, jcfg.n_layers)
    return init_params(jcfg, seed=0, dtype=jnp.float32), cfg


@pytest.mark.parametrize("fmt", ["q4", "q8", "q4s"])
def test_quantize_layers_equals_jax(full_tree, fmt):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.scripts.ppl_trained import KEYS, quantize_layers

    jp, _ = full_tree
    want = port_tree(_jax_script().quantize_layers(jp, fmt))
    got = quantize_layers(port_tree(jp), fmt)
    if fmt != "q4s":  # the JAX QArray dequantizes no q4s: its bytes are compared below
        assert_trees_equal(_jax_script().quantize_layers(jp, fmt), got)
    for wd, gd in zip(want["layers"], got["layers"], strict=True):
        for k in KEYS:
            w, g = wd[k], gd[k]
            assert isinstance(g, QArray) and g.fmt == fmt == w.fmt
            assert torch.equal(g.data, w.data), k
            scales = zip(g.scales, w.scales) if fmt == "q4s" else [(g.scales, w.scales)]
            assert all(torch.equal(a, b) for a, b in scales), k


def test_adam_steps_match_jax():
    """Five Adam steps at --small from the JAX init (converted): the loss
    trace within TRACE_TOL relative of the JAX script's."""
    from jlama_tpu.config import from_hf_config
    from jlama_tpu.models.init import init_params
    from jlama_tpu_torch.scripts.ppl_trained import adam_train, config, markov_corpus

    cfg = config(small=True)
    jcfg = from_hf_config({"model_type": "llama", "hidden_size": 128, "intermediate_size": 384,
                           "num_attention_heads": 4, "num_key_value_heads": 2,
                           "num_hidden_layers": 2, "rms_norm_eps": 1e-5, "vocab_size": 256,
                           "max_position_embeddings": 512, "rope_theta": 10000.0,
                           "bos_token_id": 0, "eos_token_id": 0, "hidden_act": "silu"})
    corpus = markov_corpus(256, 20_000, seed=1)
    jp = init_params(jcfg, seed=0, dtype=jnp.float32)
    _, want = _jax_script().adam_train(jp, jcfg, corpus, steps=5, batch=4, seq=33, log_every=1)
    _, got = adam_train(port_tree(jp), cfg, corpus, steps=5, batch=4, seq=33, log_every=1)
    assert [t for t, _ in got] == [t for t, _ in want] == [1, 2, 3, 4, 5]
    for (t, a), (_, b) in zip(got, want):
        assert abs(a - b) <= TRACE_TOL * abs(b), (t, a, b)
    assert got[-1][1] < got[0][1]


@pytest.mark.slow
def test_trained_weights_q4_ppl_budget():
    """tests/test_ppl_trained.py on the port (CPU): 150 Adam steps at
    --small's widths on a 60,000-token corpus, the loss dropping by more
    than 1.0, f32 perplexity below e^2.2 and JQ4 within 0.1 of it."""
    from jlama_tpu_torch.eval.ppl import score_tokens
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.scripts.ppl_trained import (adam_train, config, markov_corpus,
                                                     quantize_layers)

    cfg = config(small=True)
    corpus = markov_corpus(256, 60_000, seed=1)
    held_out = markov_corpus(256, 3_000, seed=2)
    params = init_params(cfg, dtype=torch.float32, quantize=None, device="cpu")
    params, trace = adam_train(params, cfg, corpus, steps=150, batch=16, seq=129,
                               log_every=150)
    assert trace[-1][1] < trace[0][1] - 1.0, trace
    ppl_fp = score_tokens(params, cfg, held_out, seq_len=512, stride=256, device="cpu")
    ppl_q4 = score_tokens(quantize_layers(params, "q4"), cfg, held_out, seq_len=512,
                          stride=256, device="cpu")
    assert ppl_fp < np.exp(2.2), ppl_fp
    assert abs(ppl_q4 - ppl_fp) <= 0.1, (ppl_fp, ppl_q4)
