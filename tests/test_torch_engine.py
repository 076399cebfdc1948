"""The port's Engine against jlama_tpu's Engine on the same tiny checkpoint
(analogs of tests/test_engine.py), on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import make_tiny_llama

PROMPT = [1, 5, 9, 42, 7]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tiny_torch_eng"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    jeng = JEngine(jp, jcfg, max_seq_len=128, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    tp, tcfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    teng = Engine(tp, tcfg, device="cpu", max_seq_len=128, kv_dtype=torch.float32,
                  compute_dtype=torch.float32)
    return jeng, teng


def test_greedy_ids_match_jax(engines):
    jeng, teng = engines
    for prompt, n in ((PROMPT, 12), ([1, 3, 7, 12, 30, 44, 100, 9, 17, 2, 5, 88, 41, 6, 3,
                                      77, 200, 12], 9)):
        ref = jeng.generate_tokens(prompt, max_new_tokens=n, temperature=0.0,
                                   stop_ids=set())
        got = teng.generate_tokens(prompt, max_new_tokens=n, temperature=0.0,
                                   stop_ids=set())
        assert got.token_ids == ref.token_ids
        assert got.prompt_tokens == len(prompt) and got.generated_tokens == n
        assert got.finish_reason.name == "MAX_TOKENS"


def test_session_resume_equals_one_shot_and_jax(engines):
    jeng, teng = engines
    prompt = [1, 3, 7, 12, 30, 44, 100, 9]
    full = teng.generate_tokens(prompt, max_new_tokens=6, session_id="one", stop_ids=set())
    teng.generate_tokens(prompt[:4], max_new_tokens=0, session_id="resume")
    r2 = teng.generate_tokens(prompt[4:], max_new_tokens=6, session_id="resume",
                              stop_ids=set())
    assert r2.token_ids == full.token_ids
    # a third turn continues the same session on both packages
    jeng.generate_tokens(prompt[:4], max_new_tokens=0, session_id="jresume")
    j2 = jeng.generate_tokens(prompt[4:], max_new_tokens=6, session_id="jresume",
                              stop_ids=set())
    assert j2.token_ids == r2.token_ids
    j3 = jeng.generate_tokens([5, 6, 7], max_new_tokens=5, session_id="jresume",
                              stop_ids=set())
    t3 = teng.generate_tokens([5, 6, 7], max_new_tokens=5, session_id="resume",
                              stop_ids=set())
    assert t3.token_ids == j3.token_ids
    assert teng.sessions["resume"].position == jeng.sessions["jresume"].position
    assert teng.sessions["resume"].pending == jeng.sessions["jresume"].pending


def test_chunk_size_invariance(engines, monkeypatch):
    _, teng = engines

    def run(chunk, **kw):
        monkeypatch.setenv("JLAMA_DEVICE_CHUNK", str(chunk))
        return teng.generate_tokens(PROMPT, max_new_tokens=11, stop_ids=set(), **kw).token_ids

    greedy = [run(c, temperature=0.0) for c in (1, 3, 32)]
    assert greedy[0] == greedy[1] == greedy[2]
    sampled = [run(c, temperature=0.9, top_p=0.9, seed=7) for c in (1, 4, 32)]
    assert sampled[0] == sampled[1] == sampled[2]


def test_early_stop_matches_jax(engines, monkeypatch):
    jeng, teng = engines
    monkeypatch.setenv("JLAMA_DEVICE_CHUNK", "32")
    full = teng.generate_tokens(PROMPT, max_new_tokens=12, stop_ids=set())
    stop_tok = full.token_ids[2]
    got = teng.generate_tokens(PROMPT, max_new_tokens=12, stop_ids={stop_tok},
                               session_id="stop")
    ref = jeng.generate_tokens(PROMPT, max_new_tokens=12, stop_ids={stop_tok},
                               session_id="jstop")
    assert got.token_ids == full.token_ids[: full.token_ids.index(stop_tok) + 1]
    assert got.token_ids == ref.token_ids
    assert got.finish_reason.name == ref.finish_reason.name == "STOP_TOKEN"
    assert teng.sessions["stop"].position == jeng.sessions["jstop"].position


def test_top_k_one_is_greedy_and_streaming(engines):
    _, teng = engines
    greedy = teng.generate_tokens(PROMPT, max_new_tokens=6, stop_ids=set())
    k1 = teng.generate_tokens(PROMPT, max_new_tokens=6, temperature=1.3, top_k=1, seed=7,
                              stop_ids=set())
    assert k1.token_ids == greedy.token_ids
    seen = []
    resp = teng.generate_tokens([1, 5, 9], max_new_tokens=5,
                                on_token=lambda t, ms: seen.append(t))
    assert seen == resp.token_ids or seen == resp.token_ids[:-1]
    r = teng.generate_tokens([1, 5], max_new_tokens=5, temperature=0.8, top_p=0.9,
                             top_k=50, seed=3, stop_ids=set())
    assert len(r.token_ids) == 5 and all(0 <= t < 256 for t in r.token_ids)


def test_lru_offload_keeps_sessions(engines):
    from jlama_tpu_torch.runtime.engine import Engine

    _, teng = engines
    eng = Engine(teng.params, teng.cfg, device="cpu", max_seq_len=64,
                 kv_dtype=torch.float32, compute_dtype=torch.float32,
                 max_device_sessions=1, fuse=False)
    a1 = eng.generate_tokens(PROMPT, max_new_tokens=3, session_id="a", stop_ids=set())
    eng.generate_tokens([1, 2, 3], max_new_tokens=3, session_id="b", stop_ids=set())
    assert eng.sessions["a"].on_host and not eng.sessions["b"].on_host
    a2 = eng.generate_tokens([4], max_new_tokens=4, session_id="a", stop_ids=set())
    assert not eng.sessions["a"].on_host and eng.sessions["b"].on_host
    ref = teng.generate_tokens(PROMPT, max_new_tokens=3, session_id="ref", stop_ids=set())
    ref2 = teng.generate_tokens([4], max_new_tokens=4, session_id="ref", stop_ids=set())
    assert (a1.token_ids, a2.token_ids) == (ref.token_ids, ref2.token_ids)


def test_q4_engine_matches_jax(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu.quant.quantizer import quantize_model
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine

    base = tmp_path_factory.mktemp("tiny_torch_eng_q4")
    model_dir, _ = make_tiny_llama(base / "f32", seed=5)
    q4_dir = quantize_model(model_dir, base / "jq4")
    jp, jcfg = jload(q4_dir, float_dtype=jnp.float32)
    jeng = JEngine(jp, jcfg, max_seq_len=64, kv_dtype=jnp.float32, compute_dtype=jnp.float32)
    tp, tcfg = load_params(q4_dir, device="cpu", float_dtype=torch.float32)
    teng = Engine(tp, tcfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                  compute_dtype=torch.float32)
    prompt = [1, 9, 33, 2, 71, 18, 4, 100, 3]
    ref = jeng.generate_tokens(prompt, max_new_tokens=10, stop_ids=set())
    got = teng.generate_tokens(prompt, max_new_tokens=10, stop_ids=set())
    assert got.token_ids == ref.token_ids


def test_text_generate_and_builder(tmp_path_factory):
    from tests.helpers import make_tiny_chat_model
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.tokenizers import load_tokenizer

    model_dir, _ = make_tiny_chat_model(tmp_path_factory.mktemp("tiny_torch_text"))
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    eng = Engine(params, cfg, load_tokenizer(model_dir), device="cpu", max_seq_len=96,
                 kv_dtype=torch.float32, compute_dtype=torch.float32)
    pieces = []
    resp = eng.generate("Hello there", max_new_tokens=6,
                        on_token=lambda text, ms: pieces.append(text))
    assert resp.generated_tokens >= 1
    assert isinstance(resp.response_text, str)
    assert resp.response_text.startswith("".join(pieces)[: len(resp.response_text)])
    r2 = eng.builder().prompt("Hello").temperature(0.0).max_tokens(4).generate()
    assert r2.generated_tokens >= 1


def test_bucket_geometric_past_8k():
    from jlama_tpu_torch.runtime.engine import _bucket

    assert (_bucket(100), _bucket(8192), _bucket(8193), _bucket(20000)) == (
        128, 8192, 16384, 32768)


def test_sampling_masks_and_distribution():
    """Greedy equals JAX; top-k/top-p keep the same support as JAX's draws;
    seeded draws follow the filtered softmax (JAX's threefry bits cannot be
    reproduced, so draws are held to the distribution only)."""
    import jax
    from jlama_tpu.nn.sampling import sample_token as jsample
    from jlama_tpu_torch.nn.sampling import _filter, sample_token

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((1, 16)).astype(np.float32) * 2
    tl = torch.from_numpy(logits)
    assert int(sample_token(tl)[0]) == int(jsample(jnp.asarray(logits), None)[0])
    n = 4000
    for top_k, top_p in ((3, 1.0), (0, 0.8), (5, 0.7)):
        rows = np.repeat(logits, n, axis=0)
        jd = np.asarray(jsample(jnp.asarray(rows), jax.random.PRNGKey(1), 1.0, top_k, top_p))
        g = torch.Generator().manual_seed(1)
        td = sample_token(torch.from_numpy(rows), g, 1.0, top_k, top_p).numpy()
        kept = _filter(tl.clone(), top_k, top_p)[0]
        support = set(np.flatnonzero(torch.isfinite(kept).numpy()))
        assert set(jd) <= support and set(td) == support
        p = torch.softmax(kept, -1).numpy()
        freq = np.bincount(td, minlength=16) / n
        assert np.abs(freq - p).max() < 0.04
