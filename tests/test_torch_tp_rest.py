"""The rest of tensor parallelism on the port, held against jlama_tpu on the
CPU at tp = 2: q4s (K5's plain version on each rank's slice), GPT-2 and
BERT, and the Engine on a mesh. The ranks are threads
(tests/test_torch_tp_forward.py's `ThreadGroup`), each running the same
calls (SPMD: every rank's scheduler or Engine gets the same requests, as a
follower replaying the leader's steps would); the multi-process path with
the step channel is tests/test_torch_tp_serving.py, and
tests/test_torch_tp_cli.py serves `/v1/embeddings` from a mesh server.

- q4s: a rank's q4s tree is the cut of the whole converted tree (its
  column-parallel rows, its 256-groups of wo's and w2's K, its vocabulary
  rows of the tied lm_head); greedy ids equal jlama_tpu's q4s scheduler
  (its w8a8 kernel in interpret mode). K5 needs each rank's K a multiple of
  256, so this model is wider than the other tiny ones: hidden 512,
  intermediate 1,024, 8 heads of 64 on 4;
- GPT-2: greedy ids equal jlama_tpu's scheduler on a tp = 2 mesh (GSPMD on
  two of the host devices tests/conftest.py makes); its vocabulary of 256
  divides, so this also takes the vocabulary-sharded tied head, and a
  vocabulary that does not divide stays whole on both ranks;
- BERT: embeddings under every pooling and `classify` within 1e-4 of
  jlama_tpu's Engine; its row-parallel biases are nonzero, and adding them
  on every rank (before the all-reduce) moves the vectors past that limit;
- the Engine: `Engine(mesh=)` greedy ids equal jlama_tpu's `Engine(mesh=)`
  at tp = 2, its steps eager and saying why.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlama_tpu.nn.qarray import quantize_q4 as jquantize_q4
from jlama_tpu_torch.config import from_hf_config
from jlama_tpu_torch.models.base import fuse_params
from jlama_tpu_torch.models.convert import from_jax_params
from jlama_tpu_torch.nn import layers as tlayers
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.ops import w8a8
from jlama_tpu_torch.parallel import mesh as tmesh
from jlama_tpu_torch.runtime.engine import Engine
from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState
from tests.test_torch_bridge import jax_tree_to_numpy, port_tree
from tests.test_torch_gpt2_bert import (GPT2, POOLINGS, PROMPT, TEXTS, bert,  # noqa: F401
                                        gpt2, gpt2_q4)
from tests.test_torch_tp_forward import CONFIGS, make_model, run_ranks

TP = 2
EMBED_TOL = 1e-4  # tests/test_torch_gpt2_bert.py's JAX_TOL
BERT_ENGINE_KW = {"port": dict(device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                               compute_dtype=torch.float32),
                  "jax": dict(max_seq_len=64, kv_dtype=jnp.float32, compute_dtype=jnp.float32)}

Q4S_TP_CONFIG = {
    "model_type": "llama", "hidden_size": 512, "intermediate_size": 1024,
    "num_attention_heads": 8, "num_key_value_heads": 4, "num_hidden_layers": 2,
    "rms_norm_eps": 1e-5, "vocab_size": 512, "max_position_embeddings": 64,
    "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "tie_word_embeddings": True,
}
Q4S_PROMPTS = [[1, 5, 9, 42, 7], [1, 7, 30, 12]]
SERVE = dict(n_slots=2, n_pages=32, page_size=8, max_seq_len=56)


def _mesh(group):
    return tmesh.Mesh(1, 1, TP, group)


def _serve(sched, prompts, n):
    reqs = [sched.submit(GenRequest(prompt_ids=list(p), max_new_tokens=n)) for p in prompts]
    for _ in range(400):
        if all(r.state == RequestState.DONE for r in reqs):
            return [list(r.out_ids) for r in reqs]
        sched.step()
    raise AssertionError("requests did not finish")


# ---------------------------------------------------------------------------
# q4s under tp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def q4s_tp_model():
    """(jax cfg, jax tree): every layer matrix and the tied embedding JQ4."""
    from jlama_tpu.config import from_hf_config as jax_config
    from jlama_tpu.models.init import init_params

    cfg = jax_config(Q4S_TP_CONFIG)
    params = init_params(cfg, seed=0, dtype=jnp.float32)
    layers = {k: jquantize_q4(np.asarray(v, np.float32))
              if k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3") else v
              for k, v in params["layers"].items()}
    return cfg, dict(params, layers=layers, embed=jquantize_q4(np.asarray(params["embed"])))


def _port_q4s(q4s_tp_model):
    return (from_jax_params(jax_tree_to_numpy(q4s_tp_model[1]), device="cpu"),
            from_hf_config(Q4S_TP_CONFIG))


def _cut_q4s(w: QArray, dim: int, rank: int) -> QArray:
    """A q4s leaf's rank slice of its output rows (dim -2) or its K (dim -1:
    the payload's K/2 bytes, sigma's K/32 and swk's K/256 columns)."""
    sigma, swk = w.scales

    def cut(t):
        n = t.shape[dim] // TP
        return t.narrow(dim, rank * n, n)

    return QArray(cut(w.data), (cut(sigma), cut(swk)), "q4s")


def test_q4s_rank_tree_is_the_cut_of_the_whole_converted_tree(q4s_tp_model):
    """Each rank's q4s tree equals the corresponding cut of the whole fused
    tree (rows interleaved per rank) converted once: q4s works per row and
    per 256-group of K, so converting the slice is converting the whole."""
    params, cfg = _port_q4s(q4s_tp_model)
    whole = w8a8.prepare_params_for_w8a8(fuse_params(params, TP))
    for rank in range(TP):
        group = type("G", (), {"rank": rank, "size": TP, "device": torch.device("cpu")})()
        sched = BatchScheduler(params, cfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                               device="cpu", weight_format="q4s", mesh=_mesh(group), **SERVE)
        got = sched.params
        assert got.vocab == (True, True)
        pairs = [(got["lm_head"], _cut_q4s(whole["lm_head"], -2, rank))]
        for lg, lw in zip(got["layers"], whole["layers"]):
            pairs += [(lg[k], _cut_q4s(lw[k], -2, rank)) for k in ("wqkv", "w13")]
            pairs += [(lg[k], _cut_q4s(lw[k], -1, rank)) for k in ("wo", "w2")]
        for a, b in pairs:
            assert a.fmt == "q4s"
            assert torch.equal(a.data, b.data)
            assert all(torch.equal(x, y) for x, y in zip(a.scales, b.scales))
        assert got["embed"].fmt == "q4"  # the row gather reads the q4 table


@pytest.fixture(scope="module")
def jax_q4s_ids(q4s_tp_model):
    """jlama_tpu's single-device q4s scheduler, its w8a8 kernel in interpret
    mode: a request alone, then two at once."""
    from jax.experimental.pallas import tpu as pltpu

    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    cfg, params = q4s_tp_model
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setenv("JLAMA_Q4S_KERNEL", "1")  # the w8a8 kernel, not the f32 dequant
        js = JSched(params, cfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                    weight_format="q4s", **SERVE)
        assert js.params["lm_head"].fmt == "q4s"
        out = {"single": js.generate(Q4S_PROMPTS[0], max_new_tokens=6).token_ids}
        reqs = [JReq(prompt_ids=p, max_new_tokens=4) for p in Q4S_PROMPTS]
        for r in reqs:
            js.submit(r)
        while any(r.state.value != "DONE" for r in reqs):
            js.step()
        out["pair"] = [r.out_ids for r in reqs]
    return out


def test_q4s_tp2_greedy_ids_match_jax(q4s_tp_model, jax_q4s_ids):
    """Both ranks' q4s schedulers give jlama_tpu's q4s greedy ids, a
    request alone and two at once; every projection and the lm_head q4s."""
    params, cfg = _port_q4s(q4s_tp_model)

    def rank_fn(group):
        sched = BatchScheduler(params, cfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                               device="cpu", weight_format="q4s", mesh=_mesh(group), **SERVE)
        lay = sched.params["layers"][0]
        assert {lay[k].fmt for k in ("wqkv", "wo", "w13", "w2")} == {"q4s"}
        assert lay["wo"].shape[-1] == 256 and lay["w2"].shape[-1] == 512  # K a rank
        return {"single": sched.generate(Q4S_PROMPTS[0], max_new_tokens=6).token_ids,
                "pair": _serve(sched, Q4S_PROMPTS, 4)}

    got = run_ranks(TP, rank_fn)
    assert got[0] == got[1] == jax_q4s_ids


def test_q4s_distance_from_q4_is_jax_on_a_normal_draw(q4s_tp_model):
    """On this normal(0, 0.02) draw (jlama_tpu's `init_params`, quantized)
    one device's q4s (W4A8) prefill logits lie far from its q4 (W4A16)
    logits, and jlama_tpu's lie as far: the port's q4 logits are within
    1e-5 of jlama_tpu's and the port's q4s-to-q4 distance within 5 % of
    jlama_tpu's (its w8a8 kernel in interpret mode). The distance is the
    draw's and W4A8's, not the port's."""
    from jax.experimental.pallas import tpu as pltpu

    from jlama_tpu.models.base import forward_logits as jforward_logits
    from jlama_tpu.ops import pallas_w8a8 as jw8
    from jlama_tpu_torch.models.base import forward_logits

    jcfg, jp = q4s_tp_model
    toks = np.array([[1, 5, 9, 42, 7, 13, 2, 30, 77, 4, 100, 8, 250, 3, 61, 19]], np.int64)
    pos = np.arange(toks.shape[1])[None]
    jargs = (jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32))
    jq4 = np.asarray(jforward_logits(jp, jcfg, *jargs, dtype=jnp.float32)[0])
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setenv("JLAMA_Q4S_KERNEL", "1")  # the w8a8 kernel, not the f32 dequant
        jq4s = np.asarray(jforward_logits(jw8.prepare_params_for_w8a8(jp), jcfg, *jargs,
                                          dtype=jnp.float32)[0])
    params, cfg = _port_q4s(q4s_tp_model)
    fused = fuse_params(params)
    targs = (torch.from_numpy(toks), torch.from_numpy(pos))
    tq4 = forward_logits(fused, cfg, *targs, dtype=torch.float32)[0].numpy()
    tq4s = forward_logits(w8a8.prepare_params_for_w8a8(fused), cfg, *targs,
                          dtype=torch.float32)[0].numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(tq4, jq4) < 1e-5
    d_port, d_jax = rel(tq4s, tq4), rel(jq4s, jq4)
    assert abs(d_port / d_jax - 1) < 0.05, (d_port, d_jax)


# ---------------------------------------------------------------------------
# GPT-2 under tp
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_gpt2_tp_ids(gpt2_q4):
    """jlama_tpu's q4 GPT-2 scheduler on a tp = 2 mesh (GSPMD)."""
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched

    jcfg, jp = gpt2_q4
    mesh = make_mesh(jax.devices()[:TP], dp=1, pp=1, tp=TP)
    js = JSched(shard_params(jp, jcfg, mesh), jcfg, mesh=mesh, kv_dtype=jnp.float32,
                compute_dtype=jnp.float32, layer_mode="unrolled", n_slots=2, n_pages=32,
                page_size=8, max_seq_len=128)
    out = {"single": js.generate(PROMPT, max_new_tokens=6).token_ids}
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    reqs = [JReq(prompt_ids=p, max_new_tokens=6) for p in (PROMPT[:5], PROMPT[3:])]
    for r in reqs:
        js.submit(r)
    while any(r.state.value != "DONE" for r in reqs):
        js.step()
    out["pair"] = [r.out_ids for r in reqs]
    return out


@pytest.mark.parametrize("vocab", ["sharded", "replicated"])
def test_gpt2_tp2_greedy_ids_match_jax(gpt2_q4, jax_gpt2_tp_ids, vocab):
    """GPT-2 (learned positions, LayerNorms, biased c_attn and c_fc cut with
    their rows, c_proj's biases added once) at tp = 2 gives jlama_tpu's tp
    ids; with a vocabulary that does not divide (the table cut to 255 rows,
    as GPT-2's 50,257 would be), its tied embedding and lm_head stay whole
    on both ranks and the forward takes no vocabulary collective."""
    jcfg, jp = gpt2_q4
    params = port_tree(jp)
    cfg = from_hf_config(GPT2)
    if vocab == "replicated":
        params = dict(params, embed=params["embed"][:255])
        cfg = replace(cfg, vocab_size=255)

    def rank_fn(group):
        sched = BatchScheduler(params, cfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                               device="cpu", mesh=_mesh(group), n_slots=2, n_pages=32,
                               page_size=8, max_seq_len=128)
        assert sched.params.vocab == ((True, True) if vocab == "sharded" else (False, False))
        return {"single": sched.generate(PROMPT, max_new_tokens=6).token_ids,
                "pair": _serve(sched, (PROMPT[:5], PROMPT[3:]), 6), "params": sched.params}

    got = run_ranks(TP, rank_fn)
    ids = [{k: v for k, v in g.items() if k != "params"} for g in got]
    assert ids[0] == ids[1]
    if vocab == "sharded":
        assert ids[0] == jax_gpt2_tp_ids
    else:  # the whole table on each rank; the ids of one device on the same table
        assert got[0]["params"]["embed"].shape[0] == 255
        one = BatchScheduler(params, cfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                             device="cpu", n_slots=2, n_pages=32, page_size=8, max_seq_len=128)
        assert ids[0]["single"] == one.generate(PROMPT, max_new_tokens=6).token_ids


# ---------------------------------------------------------------------------
# BERT under tp: embeddings and classify
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert_jax(bert):
    """jlama_tpu's Engine over the BERT checkpoint (f32), the port's config,
    tree and tokenizer."""
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu.tokenizers import load_tokenizer as jload_tokenizer
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.tokenizers import load_tokenizer

    model_dir = bert[0]
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    jeng = JEngine(jp, jcfg, jload_tokenizer(model_dir), **BERT_ENGINE_KW["jax"])
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return jeng, params, cfg, load_tokenizer(model_dir)


def _bert_tp(params, cfg, tok):
    """Each rank's embeddings under every pooling and classify of TEXTS."""
    def rank_fn(group):
        eng = Engine(params, cfg, tok, mesh=_mesh(group), **BERT_ENGINE_KW["port"])
        ids = [tok.encode(t) for t in TEXTS]
        out = {p: np.stack(eng.embed_batch(ids, pooling=p)) for p in POOLINGS}
        out["classify"] = [eng.classify(t) for t in TEXTS]
        return out

    return run_ranks(TP, rank_fn)


def test_bert_tp2_embeddings_and_classify_match_jax(bert_jax):
    """BERT's post-norm encoder on the ranks' heads (its embedding table
    vocabulary-sharded, positions, token types, norms, pooler and
    classifier whole) gives jlama_tpu's vectors within 1e-4 under every
    pooling, and its classify probabilities, both ranks the same."""
    jeng, params, cfg, tok = bert_jax
    got = _bert_tp(params, cfg, tok)
    ids = [tok.encode(t) for t in TEXTS]
    for p in POOLINGS:
        np.testing.assert_array_equal(got[0][p], got[1][p])
        ref = np.stack(jeng.embed_batch(ids, pooling=p))
        np.testing.assert_allclose(got[0][p], ref, atol=EMBED_TOL, rtol=0, err_msg=p)
    for a, t in zip(got[0]["classify"], TEXTS):
        b = jeng.classify(t)
        assert set(a) == set(b) and all(abs(a[k] - b[k]) < EMBED_TOL for k in a)


def test_bert_row_parallel_biases_are_added_once(bert_jax, monkeypatch):
    """wo's and w2's biases are nonzero, so a forward that adds them on
    every rank before the sum (twice in all) leaves 1e-4 of jlama_tpu's
    vectors: the limit above sees the bias added once."""
    jeng, params, cfg, tok = bert_jax
    lay = params["layers"][0]
    assert lay["wo.bias"].abs().max() > 1e-2 and lay["w2.bias"].abs().max() > 1e-2

    def twice(x, w, bias=None):
        y = tlayers.tp_reduce(tlayers.linear(x, w, bias, out_dtype=torch.float32))
        return y.to(x.dtype)

    monkeypatch.setattr(tlayers, "_row_parallel_linear", twice)
    got = _bert_tp(params, cfg, tok)
    ref = np.stack(jeng.embed_batch([tok.encode(t) for t in TEXTS], pooling="AVG"))
    assert np.abs(got[0]["AVG"] - ref).max() > 10 * EMBED_TOL


# ---------------------------------------------------------------------------
# the Engine on a mesh
# ---------------------------------------------------------------------------


def test_engine_tp2_greedy_ids_match_jax_engine_mesh():
    """`Engine(mesh=)` at tp = 2 (each rank its heads and n_kv/2 of each
    cache slot, the decode loop SPMD on both ranks) gives the greedy ids of
    jlama_tpu's `Engine(mesh=)` at tp = 2; its graphs are on (the CPU runs
    them eagerly, giving no reason), and a session's second turn continues
    from its cache."""
    from jlama_tpu.parallel.mesh import make_mesh
    from jlama_tpu.runtime.engine import Engine as JEngine

    jparams, jcfg, tparams, tcfg = make_model("llama", "q4")
    mesh = make_mesh(jax.devices()[:TP], dp=1, pp=1, tp=TP)
    jeng = JEngine(jparams, jcfg, max_seq_len=64, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32, mesh=mesh)
    ref = [jeng.generate_tokens([1, 5, 9, 42, 7], max_new_tokens=8, session_id="s").token_ids,
           jeng.generate_tokens([3, 8], max_new_tokens=5, session_id="s").token_ids]

    def rank_fn(group):
        eng = Engine(tparams, tcfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                     compute_dtype=torch.float32, mesh=_mesh(group))
        ids = [eng.generate_tokens([1, 5, 9, 42, 7], max_new_tokens=8, session_id="s").token_ids,
               eng.generate_tokens([3, 8], max_new_tokens=5, session_id="s").token_ids]
        stats = eng.graphs.stats()
        return ids, stats["graphs"], stats.get("eager_reason"), eng._slot_bufs[0].shape

    got = run_ranks(TP, rank_fn)
    for ids, graphs, reason, shape in got:
        assert ids == ref
        assert graphs == 0 and reason is None  # graphs on; the CPU never captures
        assert shape[3] == CONFIGS["llama"]["num_key_value_heads"] // TP
