"""GPT-2 and BERT in the port on the CPU, held against transformers and
jlama_tpu: the loader (float and JQ4 GPT-2, BERT with a classifier), the
forward (logits and hidden states), GPT-2's greedy ids through the port's
Engine and BatchScheduler (q4, and q4s through K5's plain version), the
embedding API (every pooling, batched against single rows, BERT's classifier,
a causal Llama), learned positions past the table, and the random weights of
both layouts.

Checkpoints are built through transformers, as tests/test_archs.py and
tests/test_classify.py build them, with norm weights and biases drawn away
from HF's ones and zeros (as tests/test_torch_archs.py draws them), so that a
norm or a bias in the wrong slot shows. GPT-2 has 4 heads of 64 on 4 KV
heads: its attention reaches K2's, K3's and K4's plain versions at a head
group of 1.

Tolerances: transformers at tests/test_archs.py's 3e-3 (logits, hidden
states) and tests/test_classify.py's 2e-3 (probabilities); jlama_tpu at
tests/test_torch_forward.py's 1e-4 (both in f32); batched against single
rows at tests/test_classify.py's 2e-5; greedy ids equal.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import save_torch_model
from tests.test_torch_bridge import assert_trees_equal, port_tree

torch.backends.cuda.matmul.allow_tf32 = False

HF_TOL = 3e-3
CLS_TOL = 2e-3
JAX_TOL = 1e-4
BATCH_TOL = 2e-5
TOKENS = np.array([[1, 5, 9, 42, 7, 13, 2, 30]], dtype=np.int64)

# GPT-2 at widths K5 takes (every K a multiple of 256), 4 heads of 64
GPT2 = dict(model_type="gpt2", n_embd=256, n_head=4, n_layer=2, n_positions=128, n_inner=512,
            vocab_size=256, layer_norm_epsilon=1e-5, activation_function="gelu_new",
            bos_token_id=0, eos_token_id=0)
# tests/test_classify.py's BERT: hidden 64, 4 heads, 2 labels, a trained WordPiece
BERT = dict(model_type="bert", hidden_size=64, num_attention_heads=4, num_hidden_layers=2,
            intermediate_size=128, max_position_embeddings=64, type_vocab_size=2,
            layer_norm_eps=1e-12, hidden_act="gelu", num_labels=2,
            id2label={0: "negative", 1: "positive"}, label2id={"negative": 0, "positive": 1})
CORPUS = ["this movie was great and wonderful", "terrible awful bad film",
          "an average unremarkable production"]
TEXTS = ["this movie was great", "terrible awful bad film and production",
         "an average unremarkable production", "great"]
POOLINGS = ("AVG", "MAX", "SUM", "CLS", "MODEL")
PROMPT = [2, 5, 9, 42, 7, 13, 21, 8, 3, 30, 17, 4]
LONG = [(i * 37) % 250 + 1 for i in range(100)]  # with 27 new tokens: position 127
# pages of 48 and prefill chunks of 40: the last chunk's pads (positions 120-135)
# cross the 128-row position table, inside the 144-slot page table
PAD_CROSS = [(i * 11) % 250 + 1 for i in range(126)]


def _perturb(model, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name.lower() or name.endswith(".bias"):
                p.add_(torch.randn_like(p) * 0.1)


@pytest.fixture(scope="module")
def gpt2(tmp_path_factory):
    from transformers import GPT2Config, GPT2LMHeadModel

    from jlama_tpu.quant.quantizer import quantize_model

    tmp = tmp_path_factory.mktemp("torch_gpt2")
    torch.manual_seed(0)
    hf = GPT2LMHeadModel(GPT2Config(**{k: v for k, v in GPT2.items() if k != "model_type"}))
    hf = hf.eval()
    _perturb(hf, 10)
    save_torch_model(hf, tmp / "f32", GPT2)
    quantize_model(tmp / "f32", tmp / "jq4")
    return tmp, hf


@pytest.fixture(scope="module")
def bert(tmp_path_factory):
    from tokenizers import BertWordPieceTokenizer
    from transformers import BertConfig, BertForSequenceClassification

    tmp = tmp_path_factory.mktemp("torch_bert")
    tok = BertWordPieceTokenizer(lowercase=True)
    tok.train_from_iterator(CORPUS * 10, vocab_size=200, show_progress=False)
    tok.save(str(tmp / "tokenizer.json"))
    cfg = dict(BERT, vocab_size=tok.get_vocab_size())
    torch.manual_seed(11)
    hf = BertForSequenceClassification(
        BertConfig(**{k: v for k, v in cfg.items() if k != "model_type"})).eval()
    _perturb(hf, 12)
    save_torch_model(hf, tmp, cfg)
    return tmp, hf


def _port(model_dir):
    from jlama_tpu_torch.models.loader import load_params

    return load_params(model_dir, device="cpu", float_dtype=torch.float32)


def _jax(model_dir):
    from jlama_tpu.models.loader import load_params

    return load_params(model_dir, float_dtype=jnp.float32)


# ---------------------------------------------------------------------------
# loader and forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["gpt2", "gpt2_jq4", "bert"])
def test_load_params_matches_jax(which, gpt2, bert):
    """The same config and tree as jlama_tpu's loader: GPT-2's split and
    transposed Conv1D weights and biases (a JQ4 checkpoint's layers
    dequantized, its wte q4), BERT's embedding leaves, pooler and f32
    classifier, under their `transformer.` and `bert.` prefixes."""
    from jlama_tpu_torch.nn.qarray import QArray

    model_dir = {"gpt2": gpt2[0] / "f32", "gpt2_jq4": gpt2[0] / "jq4", "bert": bert[0]}[which]
    (tp, tcfg), (jp, jcfg) = _port(model_dir), _jax(model_dir)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(jp, tp)
    layer = tp["layers"][0]
    assert {"wq.bias", "wo.bias", "w1.bias", "w2.bias", "attn_norm.bias"} <= set(layer)
    assert "w3" not in layer
    if which == "gpt2_jq4":
        assert isinstance(tp["embed"], QArray)
        assert not any(isinstance(v, QArray) for d in tp["layers"] for v in d.values())
    if which == "bert":
        assert tp["classifier.weight"].dtype == torch.float32
        assert {"wpe", "token_type_embed", "embed_norm.weight", "pooler.weight"} <= set(tp)
        assert "final_norm.weight" not in tp


@pytest.mark.parametrize("fused", [False, True])
def test_gpt2_logits_match_transformers_and_jax(gpt2, fused):
    """tests/test_archs.py::test_gpt2's analog, through the port's loader and
    forward (the fused wqkv keeps its three biases)."""
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu_torch.models.base import forward_logits, fuse_params

    model_dir, hf = gpt2[0] / "f32", gpt2[1]
    tp, tcfg = _port(model_dir)
    if fused:
        tp = fuse_params(tp)
        assert "wqkv.bias" in tp["layers"][0] and "w13" not in tp["layers"][0]
    pos = np.arange(TOKENS.shape[1])[None, :]
    got, _ = forward_logits(tp, tcfg, torch.from_numpy(TOKENS), torch.from_numpy(pos),
                            dtype=torch.float32)
    with torch.no_grad():
        ref = hf(torch.from_numpy(TOKENS)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=HF_TOL, atol=HF_TOL)
    jp, jcfg = _jax(model_dir)
    jref, _ = jforward(jp, jcfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos, jnp.int32),
                       dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("token_types", [False, True])
def test_bert_hidden_matches_transformers_and_jax(bert, token_types):
    """tests/test_archs.py::test_bert_classifier's analog: the post-norm
    encoder's hidden states, with and without token types."""
    from jlama_tpu.models.base import forward_hidden as jforward
    from jlama_tpu_torch.models.base import forward_hidden

    model_dir, hf = bert
    tp, tcfg = _port(model_dir)
    assert tcfg.classification_labels == {0: "negative", 1: "positive"}
    toks = TOKENS % tcfg.vocab_size
    pos = np.arange(toks.shape[1])[None, :]
    tt = np.array([[0, 0, 0, 1, 1, 1, 1, 0]]) if token_types else None
    got, _ = forward_hidden(tp, tcfg, torch.from_numpy(toks), torch.from_numpy(pos), None,
                            dtype=torch.float32,
                            token_types=None if tt is None else torch.from_numpy(tt))
    with torch.no_grad():
        ref = hf.bert(torch.from_numpy(toks), token_type_ids=None if tt is None
                      else torch.from_numpy(tt)).last_hidden_state.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=HF_TOL, atol=HF_TOL)
    jp, jcfg = _jax(model_dir)
    jref, _ = jforward(jp, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
                       None, None if tt is None else jnp.asarray(tt, jnp.int32),
                       dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=JAX_TOL, atol=JAX_TOL)


def test_learned_positions_past_the_table_clamp(gpt2):
    """A position past `wpe` reads its last row, as JAX's gather clamps (a
    chunked prefill's pads reach such positions); the hidden states equal
    jlama_tpu's there."""
    from jlama_tpu.models.base import forward_hidden as jforward
    from jlama_tpu_torch.models.base import forward_hidden

    tp, tcfg = _port(gpt2[0] / "f32")
    jp, jcfg = _jax(gpt2[0] / "f32")
    pos = np.array([[120, 126, 127, 128, 131, 140, 200, 127]])
    got, _ = forward_hidden(tp, tcfg, torch.from_numpy(TOKENS), torch.from_numpy(pos), None,
                            dtype=torch.float32)
    ref, _ = jforward(jp, jcfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos, jnp.int32),
                      None, dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=JAX_TOL, atol=JAX_TOL)
    clamped, _ = forward_hidden(tp, tcfg, torch.from_numpy(TOKENS),
                                torch.from_numpy(np.minimum(pos, 127)), None,
                                dtype=torch.float32)
    assert torch.equal(got, clamped)


# ---------------------------------------------------------------------------
# GPT-2 served: Engine and BatchScheduler (q4, q4s) against jlama_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gpt2_q4(gpt2):
    """(cfg, the JAX tree): the float checkpoint with every layer matrix and
    the tied embedding quantized to JQ4, so that each projection takes K1's
    plain version and, converted, K5's."""
    from jlama_tpu.nn.qarray import quantize_q4 as jquantize_q4

    jp, jcfg = _jax(gpt2[0] / "f32")
    layers = {k: jquantize_q4(np.asarray(v, np.float32))
              if k in ("wq", "wk", "wv", "wo", "w1", "w2") else v
              for k, v in jp["layers"].items()}
    return jcfg, dict(jp, layers=layers, embed=jquantize_q4(np.asarray(jp["embed"])))


def _served_port(gpt2_q4):
    from jlama_tpu_torch.config import from_hf_config

    return port_tree(gpt2_q4[1]), from_hf_config(GPT2)


def test_gpt2_engine_greedy_ids_match_jax(gpt2_q4):
    """The port's Engine (dense cache: K4 without RoPE, K3 and K2 at 4 heads
    on 4 KV heads) against jlama_tpu's: a 12-token prompt, and a 100-token
    prompt whose generation runs to the last position of the context."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.runtime.engine import Engine

    jcfg, jp = gpt2_q4
    jeng = JEngine(jp, jcfg, max_seq_len=128, kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    params, cfg = _served_port(gpt2_q4)
    eng = Engine(params, cfg, device="cpu", max_seq_len=128, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    assert eng.inv_freq is None
    for prompt, n in ((PROMPT, 6), (LONG, 64)):
        ref = jeng.generate_tokens(prompt, max_new_tokens=n, stop_ids=set())
        got = eng.generate_tokens(prompt, max_new_tokens=n, stop_ids=set())
        assert got.token_ids == ref.token_ids
    assert len(got.token_ids) == 128 - len(LONG)  # to the end of the context


@pytest.fixture(scope="module")
def jax_gpt2_ids(gpt2_q4):
    """jlama_tpu's scheduler ids: q4 (its f32 dequantization, the function of
    K1's plain version) and q4s (its w8a8 kernel in interpret mode)."""
    from jax.experimental.pallas import tpu as pltpu

    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    jcfg, jp = gpt2_q4
    kw = dict(kv_dtype=jnp.float32, compute_dtype=jnp.float32, layer_mode="unrolled")
    out = {}
    js = JSched(jp, jcfg, n_slots=2, n_pages=32, page_size=8, max_seq_len=128, **kw)
    out["q4", "single"] = js.generate(PROMPT, max_new_tokens=6).token_ids
    reqs = [JReq(prompt_ids=p, max_new_tokens=6) for p in (PROMPT[:5], PROMPT[3:])]
    for r in reqs:
        js.submit(r)
    while any(r.state.value != "DONE" for r in reqs):
        js.step()
    out["q4", "pair"] = [r.out_ids for r in reqs]
    pad_kw = dict(kw, n_slots=2, n_pages=8, page_size=48, max_seq_len=128, prefill_chunk=40)
    out["q4", "pad_cross"] = JSched(jp, jcfg, **pad_kw).generate(
        PAD_CROSS, max_new_tokens=8).token_ids
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setenv("JLAMA_Q4S_KERNEL", "1")  # the w8a8 kernel, not the f32 dequant
        js = JSched(jp, jcfg, weight_format="q4s", **pad_kw)
        assert js.params["lm_head"].fmt == "q4s"
        out["q4s", "pad_cross"] = js.generate(PAD_CROSS, max_new_tokens=8).token_ids
    return out


@pytest.mark.parametrize("weight_format", [None, "q4s"])
def test_gpt2_scheduler_greedy_ids_match_jax(gpt2_q4, jax_gpt2_ids, weight_format):
    """The port's BatchScheduler (paged f32 pool) against jlama_tpu's: q4 a
    request alone (pages of 8) and two at once; q4 and q4s (every projection
    and the 256-row lm_head through K5's plain version) a 126-token prompt in
    chunks of 40 on pages of 48, whose last chunk's pads cross the 128-row
    position table (to position 135), generating to the end of the context."""
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    params, cfg = _served_port(gpt2_q4)
    kw = dict(kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
              weight_format=weight_format)
    fmt = weight_format or "q4"
    if weight_format is None:
        sched = BatchScheduler(params, cfg, n_slots=2, n_pages=32, page_size=8,
                               max_seq_len=128, **kw)
        assert sched.inv_freq is None
        assert sched.generate(PROMPT, max_new_tokens=6).token_ids == jax_gpt2_ids[fmt, "single"]
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=6) for p in (PROMPT[:5], PROMPT[3:])]
        for r in reqs:
            sched.submit(r)
        while not all(r.state == RequestState.DONE for r in reqs):
            sched.step()
        assert [r.out_ids for r in reqs] == jax_gpt2_ids[fmt, "pair"]
    sched = BatchScheduler(params, cfg, n_slots=2, n_pages=8, page_size=48, max_seq_len=128,
                           prefill_chunk=40, **kw)
    if weight_format == "q4s":
        layer = sched.params["layers"][0]
        assert {layer[k].fmt for k in ("wqkv", "wo", "w1", "w2")} == {"q4s"}
        assert sched.params["lm_head"].fmt == "q4s"
    seen = []
    inner = sched._call_prefill

    def call(toks, pos, pt, win):
        seen.append(int(np.max(pos)))
        return inner(toks, pos, pt, win)

    sched._call_prefill = call
    got = sched.generate(PAD_CROSS, max_new_tokens=8).token_ids
    assert max(seen) >= cfg.context_length  # pads past the position table
    assert got == jax_gpt2_ids[fmt, "pad_cross"]
    assert len(got) == 128 - len(PAD_CROSS)


# ---------------------------------------------------------------------------
# embeddings and classification
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert_engines(bert):
    """(the port's Engine, jlama_tpu's Engine, the port's tokenizer) over the
    BERT checkpoint, f32."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu.tokenizers import load_tokenizer as jload_tokenizer
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.tokenizers import load_tokenizer

    model_dir = bert[0]
    tp, tcfg = _port(model_dir)
    jp, jcfg = _jax(model_dir)
    tok = load_tokenizer(model_dir)
    eng = Engine(tp, tcfg, tok, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    jeng = JEngine(jp, jcfg, jload_tokenizer(model_dir), max_seq_len=64,
                   kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    return eng, jeng, tok


def test_classify_matches_transformers_and_jax(bert, bert_engines):
    """tests/test_classify.py::test_classify_matches_torch's analog: CLS
    pooling, the pooler, the classifier and a softmax."""
    eng, jeng, tok = bert_engines
    hf = bert[1]
    for text in TEXTS:
        probs = eng.classify(text)
        assert set(probs) == {"negative", "positive"}
        assert abs(sum(probs.values()) - 1.0) < 1e-5
        ids = tok.encode(text)
        with torch.no_grad():
            logits = hf(torch.tensor([ids])).logits[0].numpy()
        ref = np.exp(logits - logits.max())
        ref /= ref.sum()
        got = [probs["negative"], probs["positive"]]
        np.testing.assert_allclose(got, ref, rtol=CLS_TOL, atol=CLS_TOL)
        jprobs = jeng.classify(text)
        np.testing.assert_allclose(got, [jprobs["negative"], jprobs["positive"]],
                                   rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_embed_batch_matches_jax(bert_engines, pooling):
    """Every pooling of a ragged batch (with token types on one call) against
    jlama_tpu's embed_batch; AVG, MAX and SUM L2-normalized."""
    eng, jeng, tok = bert_engines
    lists = [tok.encode(t) for t in TEXTS]
    assert len({len(t) for t in lists}) > 1  # genuinely ragged
    types = [[0] * (len(t) // 2) + [1] * (len(t) - len(t) // 2) for t in lists]
    for tt in (None, types):
        got = eng.embed_batch(lists, pooling=pooling, token_types=tt)
        ref = jeng.embed_batch(lists, pooling=pooling, token_types=tt)
        for g, r in zip(got, ref, strict=True):
            assert g.shape == (64,) and g.dtype == np.float32
            np.testing.assert_allclose(g, r, rtol=JAX_TOL, atol=JAX_TOL)
            if pooling in ("AVG", "MAX", "SUM"):
                assert abs(np.linalg.norm(g) - 1.0) < 1e-5


@pytest.mark.parametrize("pooling", ["AVG", "MAX", "CLS"])
def test_embed_batch_matches_single(bert_engines, pooling):
    """tests/test_classify.py::test_embed_batch_matches_single's analog: a
    batched row's vector is the one it gets alone (pad keys masked)."""
    eng, _, tok = bert_engines
    lists = [tok.encode(t) for t in TEXTS]
    for ids, got in zip(lists, eng.embed_batch(lists, pooling=pooling)):
        one = eng.embed_batch([ids], pooling=pooling)[0]
        np.testing.assert_allclose(got, one, rtol=BATCH_TOL, atol=BATCH_TOL)
    np.testing.assert_allclose(eng.embed(TEXTS[0], pooling=pooling),
                               eng.embed_tokens(lists[0], pooling=pooling))


def test_embed_batch_chunks_rows(bert_engines):
    """More rows than max_rows: each chunk its own forward, the order kept."""
    eng, jeng, tok = bert_engines
    lists = [tok.encode(t) for t in TEXTS * 3]
    got = eng.embed_batch(lists, pooling="AVG", max_rows=4)
    ref = jeng.embed_batch(lists, pooling="AVG", max_rows=4)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_allclose(g, r, rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("pooling", ["AVG", "MODEL"])
def test_embed_batch_causal_llama_matches_jax(pooling):
    """A tiny Llama at head size 64 behind embed_batch: the port keeps K3
    (its plain version here) for the ragged causal batch, where jlama_tpu
    takes the masked dense path; the valid rows agree."""
    from jlama_tpu.config import from_hf_config as jfrom_hf_config
    from jlama_tpu.models.init import init_params as jinit
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.ops import attention
    from jlama_tpu_torch.runtime.engine import Engine
    from tests.helpers import TINY_LLAMA_CONFIG

    hf_cfg = dict(TINY_LLAMA_CONFIG, hidden_size=128, num_attention_heads=2,
                  num_key_value_heads=1)
    jcfg = jfrom_hf_config(hf_cfg)
    jp = jinit(jcfg, seed=4, dtype=jnp.float32)
    cfg = from_hf_config(hf_cfg)
    eng = Engine(port_tree(jp), cfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    jeng = JEngine(jp, jcfg, max_seq_len=64, kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    lists = [PROMPT, PROMPT[:3], LONG[:20], [7]]
    calls = [0]
    inner = attention.flash_prefill_plain

    def counting(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_prefill_plain", counting)
        got = eng.embed_batch(lists, pooling=pooling)
    assert calls[0] == cfg.n_layers  # one forward, K3 in each layer
    for g, r in zip(got, jeng.embed_batch(lists, pooling=pooling), strict=True):
        np.testing.assert_allclose(g, r, rtol=JAX_TOL, atol=JAX_TOL)


def test_embed_and_classify_without_head(gpt2_q4):
    """A model without a classifier refuses classify; GPT-2's MODEL pooling
    is its last valid token's final hidden state (no final norm: the JAX
    package pools forward_hidden's output)."""
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.runtime.engine import Engine

    params, cfg = _served_port(gpt2_q4)
    eng = Engine(params, cfg, device="cpu", max_seq_len=128, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="classification head"):
        eng.classify("x")
    jeng = JEngine(gpt2_q4[1], gpt2_q4[0], max_seq_len=128, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    lists = [PROMPT, LONG[:40]]
    for pooling in ("MODEL", "AVG"):
        for g, r in zip(eng.embed_batch(lists, pooling), jeng.embed_batch(lists, pooling)):
            np.testing.assert_allclose(g, r, rtol=JAX_TOL, atol=JAX_TOL)


# ---------------------------------------------------------------------------
# the scheduler's embedding engine and random weights
# ---------------------------------------------------------------------------


def test_embed_engine_shares_scheduler_weights(bert):
    """tests/test_server.py::test_embed_engine_shares_scheduler_weights's
    analog: the JAX CLI's serve wiring, an Engine over the scheduler's fused
    tree with fuse=False, copies no layer leaf."""
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler
    from jlama_tpu_torch.tokenizers import load_tokenizer

    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.nn.qarray import QArray

    tp, tcfg = _port(bert[0])
    tok = load_tokenizer(bert[0])
    q4 = init_params(tcfg, seed=0, quantize="q4", dtype=torch.float32, device="cpu")
    for params in (tp, q4):  # float leaves, and q4 QArrays
        sched = BatchScheduler(params, tcfg, tok, n_slots=2, n_pages=16, page_size=8,
                               max_seq_len=64, kv_dtype=torch.float32,
                               compute_dtype=torch.float32, device="cpu")
        assert sched.embed_engine is None
        sched.embed_engine = Engine(sched.params, sched.cfg, tok, device=sched.device,
                                    max_seq_len=64, kv_dtype=torch.float32,
                                    compute_dtype=torch.float32, fuse=False, moe_ragged=False)
        a, b = sched.embed_engine.params["layers"], sched.params["layers"]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.keys() == y.keys() and "wqkv" in x
            assert all(x[k] is y[k] for k in x)
        assert all(sched.embed_engine.params[k] is v for k, v in sched.params.items()
                   if k != "layers")
        assert isinstance(b[0]["wqkv"], QArray) == (params is q4)
        assert sched.embed_engine.embed("great movie").shape == (64,)


@pytest.mark.parametrize("which", ["gpt2", "bert"])
def test_random_weights_have_the_loader_layout(which, gpt2, bert):
    """random_q4_params and init_params on GPT-2's and BERT's configs: the
    loader's keys (no w3, LayerNorm and projection biases, wpe; BERT's token
    types, embedding norm, pooler and classifier, no final norm), norm
    weights and biases away from ones and zeros, and a forward with finite
    outputs, fused and not (random_q4_params built a gated MLP and raised on
    the first LayerNorm's missing bias)."""
    from jlama_tpu_torch.models.base import forward_hidden, fuse_params, lm_logits
    from jlama_tpu_torch.models.init import init_params, random_q4_params

    model_dir = gpt2[0] / "f32" if which == "gpt2" else bert[0]
    loaded, cfg = _port(model_dir)
    rand = random_q4_params(cfg, seed=0, device="cpu")
    ref = init_params(cfg, seed=0, device="cpu")
    for p in (rand, ref):
        assert set(p) == set(loaded)
        assert [set(d) for d in p["layers"]] == [set(d) for d in loaded["layers"]]
    for p in (rand, ref):
        layer = p["layers"][1]
        assert not torch.equal(layer["attn_norm.weight"], torch.ones_like(layer["attn_norm.weight"]))
        assert (layer["wo.bias"] != 0).all() and (p["wpe"] != 0).all()
    assert rand["pooler.weight"].dtype == torch.float32 if which == "bert" else True
    toks = torch.from_numpy(TOKENS % cfg.vocab_size)
    pos = torch.arange(TOKENS.shape[1])[None, :]
    for p in (rand, fuse_params(rand), ref):
        h, _ = forward_hidden(p, cfg, toks, pos, None, dtype=torch.float32)
        out = lm_logits(p, cfg, h) if which == "gpt2" else h
        assert torch.isfinite(out).all() and out.shape[:2] == (1, TOKENS.shape[1])


def test_random_weights_of_other_configs_unchanged():
    """The draws of a config without learned positions are as they were:
    ones and zeros for its norms and biases, and its matrices the same
    generator stream (the first layer's wq of a qwen2 and of a Llama equal a
    replay of the draws that make them)."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.init import random_q4_params
    from tests.helpers import TINY_LLAMA_CONFIG

    for hf_cfg in (TINY_LLAMA_CONFIG, dict(TINY_LLAMA_CONFIG, model_type="qwen2")):
        cfg = from_hf_config(hf_cfg)
        p = random_q4_params(cfg, seed=3, device="cpu")
        g = torch.Generator().manual_seed(3)
        data = torch.randint(0, 256, (cfg.n_heads * cfg.head_size, cfg.embedding_length // 2),
                             generator=g, dtype=torch.uint8)
        scales = (torch.rand((data.shape[0], cfg.embedding_length // 32), generator=g) + 0.5)
        assert torch.equal(p["layers"][0]["wq"].data, data)
        assert torch.equal(p["layers"][0]["wq"].scales, scales * 0.0043)
        for d in p["layers"]:
            for k, v in d.items():
                if k.endswith(".weight"):
                    assert torch.equal(v, torch.ones_like(v)), k
                if k.endswith(".bias"):
                    assert not v.any(), k
        assert set(p) == {"embed", "layers", "final_norm.weight", "lm_head"}
