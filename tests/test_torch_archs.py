"""The architectures the port carries besides Llama (qwen2, mistral, gemma,
gemma2, granite) against transformers and jlama_tpu, on the CPU: the
analogs of tests/test_archs.py, through the port's loader and forward (f32,
the kernels' plain versions); then Gemma 2 at head size 256, whose attention
takes K2's and K3's plain versions, and qwen2, whose biases go through the
fused wqkv, through the port's Engine and BatchScheduler against
jlama_tpu's; and `random_q4_params` for configs with post-norms and biases.

Each checkpoint's norm weights and biases are drawn away from the values HF
initializes them to (ones or zeros), so that a norm or a bias loaded into
the wrong slot shows: with all norms equal, Gemma 2's pre-FFN and
post-attention norms could be swapped unseen.

Tolerances: transformers at tests/test_archs.py's 3e-3; jlama_tpu's
forward_logits at tests/test_torch_forward.py's 1e-4 (both in f32); greedy
ids equal.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import save_torch_model
from tests.test_torch_bridge import assert_trees_equal

torch.backends.cuda.matmul.allow_tf32 = False

TOKENS = np.array([[1, 5, 9, 42, 7, 13, 2, 30]], dtype=np.int64)
HF_TOL = 3e-3
JAX_TOL = 1e-4

_COMMON = dict(num_hidden_layers=2, vocab_size=256, max_position_embeddings=128,
               rope_theta=10000.0)
# tests/test_archs.py's tiny configs: (transformers class prefix, seed, config)
ARCHS = {
    "qwen2": ("Qwen2", 2, dict(
        model_type="qwen2", hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-6, hidden_act="silu",
        tie_word_embeddings=False, **_COMMON)),
    "mistral": ("Mistral", 3, dict(
        model_type="mistral", hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, hidden_act="silu", sliding_window=None,
        **_COMMON)),
    "gemma": ("Gemma", 4, dict(
        model_type="gemma", hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=1, rms_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh", head_dim=16,
        tie_word_embeddings=True, **_COMMON)),
    "gemma2": ("Gemma2", 5, dict(
        model_type="gemma2", hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-6, hidden_activation="gelu_pytorch_tanh",
        head_dim=16, tie_word_embeddings=True, query_pre_attn_scalar=16,
        final_logit_softcapping=30.0, attn_logit_softcapping=50.0, sliding_window=4,
        **_COMMON)),
    "granite": ("Granite", 6, dict(
        model_type="granite", hidden_size=64, intermediate_size=128, num_attention_heads=4,
        num_key_value_heads=2, rms_norm_eps=1e-5, hidden_act="silu", tie_word_embeddings=True,
        embedding_multiplier=6.0, residual_multiplier=0.22, attention_multiplier=0.015625,
        logits_scaling=8.0, **_COMMON)),
}
# Gemma 2 at head size 256 (tests/test_gemma2_window_kernel.py's model at
# hd 256): 8 query heads on 4 KV heads, a window of 8 on the even layer
GEMMA2_HD256 = dict(ARCHS["gemma2"][2], hidden_size=128, intermediate_size=256,
                    num_attention_heads=8, num_key_value_heads=4, head_dim=256,
                    query_pre_attn_scalar=256, sliding_window=8)
PROMPT = [2, 5, 9, 42, 7, 13, 21, 8, 3, 30, 17, 4]  # 12 tokens: with 6 more the window cuts
N_NEW = 6


def _build(tmp, prefix, seed, cfg):
    """A tiny random checkpoint on disk: norm weights and biases perturbed by
    N(0, 0.1) from HF's initial ones and zeros."""
    import transformers

    torch.manual_seed(seed)
    hf_cfg = getattr(transformers, prefix + "Config")(
        **{k: v for k, v in cfg.items() if k != "model_type"})
    model = getattr(transformers, prefix + "ForCausalLM")(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith(".bias"):
                p.add_(torch.randn_like(p) * 0.1)
    save_torch_model(model, tmp, cfg)
    return model


@pytest.fixture(scope="module", params=list(ARCHS))
def arch(request, tmp_path_factory):
    prefix, seed, cfg = ARCHS[request.param]
    tmp = tmp_path_factory.mktemp(f"torch_arch_{request.param}")
    return request.param, tmp, _build(tmp, prefix, seed, cfg)


def _port(model_dir):
    from jlama_tpu_torch.models.loader import load_params

    return load_params(model_dir, device="cpu", float_dtype=torch.float32)


def _jax(model_dir):
    from jlama_tpu.models.loader import load_params

    return load_params(model_dir, float_dtype=jnp.float32)


def test_load_params_matches_jax(arch):
    """The same config and the same tree (Gemma 2's four norms each in its
    own slot, qwen2's biases) as jlama_tpu's loader."""
    name, model_dir, _ = arch
    (tp, tcfg), (jp, jcfg) = _port(model_dir), _jax(model_dir)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(jp, tp)
    layer = tp["layers"][0]
    if name == "gemma2":
        assert {"post_attn_norm.weight", "post_ff_norm.weight"} <= set(layer)
    if name == "qwen2":
        assert {"wq.bias", "wk.bias", "wv.bias"} <= set(layer)


@pytest.mark.parametrize("fused", [False, True])
def test_logits_match_transformers_and_jax(arch, fused):
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu_torch.models.base import forward_logits, fuse_params

    _, model_dir, hf = arch
    tp, tcfg = _port(model_dir)
    if fused:
        tp = fuse_params(tp)
    pos = np.arange(TOKENS.shape[1])[None, :]
    got, _ = forward_logits(tp, tcfg, torch.from_numpy(TOKENS), torch.from_numpy(pos),
                            dtype=torch.float32)
    got = got.numpy()
    with torch.no_grad():
        ref = hf(torch.from_numpy(TOKENS)).logits.numpy()
    np.testing.assert_allclose(got, ref, rtol=HF_TOL, atol=HF_TOL)
    jp, jcfg = _jax(model_dir)
    jref, _ = jforward(jp, jcfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos, jnp.int32),
                       dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(jref), rtol=JAX_TOL, atol=JAX_TOL)


# ---------------------------------------------------------------------------
# greedy ids through Engine and BatchScheduler: Gemma 2 at hd 256, qwen2
# ---------------------------------------------------------------------------

SERVED = {"gemma2_hd256": ("Gemma2", 9, GEMMA2_HD256), "qwen2": ARCHS["qwen2"]}


@pytest.fixture(scope="module", params=list(SERVED))
def served(request, tmp_path_factory):
    prefix, seed, cfg = SERVED[request.param]
    tmp = tmp_path_factory.mktemp(f"torch_served_{request.param}")
    hf = _build(tmp, prefix, seed, cfg)
    return request.param, tmp, hf


def test_served_logits_match_transformers(served):
    """The 12-token prompt's logits against transformers: at hd 256 through
    K3's plain version, with Gemma 2's window of 8 cutting its keys."""
    from jlama_tpu_torch.models.base import forward_logits

    name, model_dir, hf = served
    tp, tcfg = _port(model_dir)
    if name == "gemma2_hd256":
        assert tcfg.head_size == 256 and tcfg.sliding_window == 8
    toks = np.asarray([PROMPT], np.int64)
    got, _ = forward_logits(tp, tcfg, torch.from_numpy(toks),
                            torch.arange(len(PROMPT))[None, :], dtype=torch.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=HF_TOL, atol=HF_TOL)


def test_engine_greedy_ids_match_jax(served):
    """The port's Engine (dense cache: K4, K3 and K2's plain versions at hd
    256) against jlama_tpu's Engine."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.ops.attention import paged_decode
    from jlama_tpu_torch.runtime.engine import Engine

    name, model_dir, _ = served
    jp, jcfg = _jax(model_dir)
    ref = JEngine(jp, jcfg, max_seq_len=64, kv_dtype=jnp.float32,
                  compute_dtype=jnp.float32).generate_tokens(
        PROMPT, max_new_tokens=N_NEW, temperature=0.0, stop_ids=set()).token_ids
    tp, tcfg = _port(model_dir)
    eng = Engine(tp, tcfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    if name == "qwen2":
        assert "wqkv.bias" in eng.params["layers"][0]
    before = paged_decode.launches
    got = eng.generate_tokens(PROMPT, max_new_tokens=N_NEW, temperature=0.0,
                              stop_ids=set()).token_ids
    assert paged_decode.launches == before  # the CPU runs the plain version
    assert got == ref and len(got) == N_NEW


def test_scheduler_greedy_ids_match_jax(served):
    """The port's BatchScheduler (paged f32 pool, pages of 8: the window
    crosses pages) against jlama_tpu's (layer_mode="unrolled"), one request
    alone and two at once."""
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    name, model_dir, _ = served
    jp, jcfg = _jax(model_dir)
    kw = dict(n_slots=2, n_pages=32, page_size=8, max_seq_len=64)
    js = JSched(jp, jcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                layer_mode="unrolled", **kw)
    ref = js.generate(PROMPT, max_new_tokens=N_NEW, temperature=0.0).token_ids
    pair = [PROMPT[:5], PROMPT[3:]]
    jreqs = [JReq(prompt_ids=p, max_new_tokens=N_NEW) for p in pair]
    for r in jreqs:
        js.submit(r)
    while any(r.state.value != "DONE" for r in jreqs):
        js.step()
    tp, tcfg = _port(model_dir)
    sched = BatchScheduler(tp, tcfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                           device="cpu", **kw)
    if name == "qwen2":
        assert "wqkv.bias" in sched.params["layers"][0]
    got = sched.generate(PROMPT, max_new_tokens=N_NEW, temperature=0.0).token_ids
    assert got == ref and len(got) == N_NEW
    reqs = [GenRequest(prompt_ids=p, max_new_tokens=N_NEW) for p in pair]
    for r in reqs:
        sched.submit(r)
    while not all(r.state == RequestState.DONE for r in reqs):
        sched.step()
    assert [r.out_ids for r in reqs] == [r.out_ids for r in jreqs]


# ---------------------------------------------------------------------------
# random_q4_params: the post-norms and biases init_params makes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gemma2_hd256", "qwen2"])
def test_random_q4_params_runs_forward(name):
    """A tiny Gemma 2 (post-norms) and qwen2 (q/k/v biases): the same keys
    as `init_params`, and a forward with finite logits (a missing
    post-norm weight raised KeyError in the first block)."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.base import forward_logits, fuse_params
    from jlama_tpu_torch.models.init import init_params, random_q4_params

    cfg = from_hf_config(SERVED[name][2])
    params = random_q4_params(cfg, seed=0, device="cpu")
    ref = init_params(cfg, seed=0, device="cpu")
    assert [set(d) for d in params["layers"]] == [set(d) for d in ref["layers"]]
    assert set(params) == set(ref)
    layer = params["layers"][1]
    for k, v in ref["layers"][1].items():
        if k.endswith((".weight", ".bias")):
            assert torch.equal(layer[k], v), k
    toks = torch.tensor([PROMPT])
    pos = torch.arange(len(PROMPT))[None, :]
    for p in (params, fuse_params(params)):
        logits, _ = forward_logits(p, cfg, toks, pos, dtype=torch.float32)
        assert logits.shape == (1, len(PROMPT), cfg.vocab_size)
        assert torch.isfinite(logits).all()
