"""The port's paged KV cache (jlama_tpu_torch.kv.paged), its KV write (K4's
plain version) and paged decode attention (K2's plain version) against
jlama_tpu's, on the CPU; and the cases of tests/test_paged_kv.py on the port."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import make_tiny_llama
from tests.test_torch_bridge import jax_tree_to_numpy

from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu_torch.kv.paged import PageAllocator, PagedKVCache, PagedKVState
from jlama_tpu_torch.models.convert import from_jax_kv_state
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.ops.attention import paged_decode_plain
from jlama_tpu_torch.ops.kv_write import dense_page_table, dense_pool_view, kv_write_plain


def _alloc_ops(groups):
    """A sequence of allocator calls: (op, seq, n_tokens, group)."""
    ops = [("ensure", "a", 9, 0), ("ensure", "b", 3, groups - 1), ("ensure", "a", 17, 0),
           ("release", "a", 0, 0), ("ensure", "c", 30, 0), ("ensure", "b", 12, 0),
           ("ensure", "d", 1, groups - 1), ("release", "b", 0, 0), ("ensure", "e", 8, 0),
           ("ensure", "big", 10_000, 0)]
    return ops


@pytest.mark.parametrize("groups", [1, 2])
def test_allocator_and_page_tables_match_jax(groups):
    from jlama_tpu.config import from_hf_config as jcfg
    from jlama_tpu.kv.paged import PageAllocator as JAlloc
    from jlama_tpu.kv.paged import PagedKVCache as JCache
    from jlama_tpu_torch.config import from_hf_config
    from tests.helpers import TINY_LLAMA_CONFIG

    assert PageAllocator(16, groups).free == JAlloc(16, groups).free
    ours = PagedKVCache(from_hf_config(TINY_LLAMA_CONFIG), n_pages=16, page_size=4,
                        max_pages_per_seq=8, dtype=torch.float32, groups=groups, device="cpu")
    ref = JCache(jcfg(TINY_LLAMA_CONFIG), n_pages=16, page_size=4, max_pages_per_seq=8,
                 dtype=jnp.float32, groups=groups)
    raised = []
    for op, seq, n, g in _alloc_ops(groups):
        outcome = []
        for cache in (ours, ref):
            try:
                if op == "release":
                    cache.alloc.release(seq)
                else:
                    cache.alloc.ensure_capacity(seq, n, 4, group=g)
                outcome.append(None)
            except MemoryError:
                outcome.append("MemoryError")
        assert outcome[0] == outcome[1]
        raised.append(outcome[0])
        a, b = ours.alloc, ref.alloc
        assert (a.free, a.by_seq, a.group_of, a.n_free) == (b.free, b.by_seq, b.group_of, b.n_free)
        seqs = ["a", "b", "c", "d", "e", "__empty__"]
        row_groups = [i % groups for i in range(len(seqs))]
        np.testing.assert_array_equal(ours.page_table(seqs), ref.page_table(seqs))
        np.testing.assert_array_equal(ours.page_table(seqs, row_groups),
                                      ref.page_table(seqs, row_groups))
        assert [a.scratch(g) for g in range(groups)] == [b.scratch(g) for g in range(groups)]
    assert raised[-1] == "MemoryError" and raised.count(None) >= 6


def _q8_pool_np(rng, shape):
    from jlama_tpu.quant.blockq import q8_quantize

    d, s = q8_quantize(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return JQArray(d, s, "q8")


def _assert_pools_match(ours, ref, skip_page0):
    """Port pool (tensor or QArray) against a JAX pool: float pools, q8
    payloads and q8 scales exactly; page 0 is left out where pad rows race on
    it (which writer wins is unspecified in both)."""
    sl = slice(1, None) if skip_page0 else slice(None)
    if isinstance(ours, QArray):
        np.testing.assert_array_equal(ours.data.numpy()[:, sl], np.asarray(ref.data)[:, sl])
        np.testing.assert_array_equal(ours.scales.numpy()[:, sl].view(np.int32),
                                      np.asarray(ref.scales)[:, sl].view(np.int32))
    else:
        np.testing.assert_array_equal(ours.numpy()[:, sl], np.asarray(ref)[:, sl])


@pytest.mark.parametrize("kind", ["f32", "q8"])
def test_kv_write_plain_matches_write_kv_layer(kind):
    from jlama_tpu.kv.paged import write_kv_layer

    rng = np.random.default_rng(11)
    n_kv, n_pages, ps, hd, B, T = 2, 9, 4, 64, 4, 6
    shape = (n_kv, n_pages, ps, hd)
    if kind == "q8":
        jk, jv = _q8_pool_np(rng, shape), _q8_pool_np(rng, shape)
    else:
        jk = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
        jv = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    pk, pv = from_jax_kv_state(jax_tree_to_numpy((jk, jv)), device="cpu")
    # row 0 from 0, row 1 across a page boundary, row 2 a pad row on the
    # scratch page, row 3 partly past its 3-column table (dropped in both)
    pt = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0], [6, 7, 8]], np.int32)
    pos = np.stack([np.arange(0, T), np.arange(3, 3 + T), np.arange(0, T),
                    np.arange(9, 9 + T)]).astype(np.int32)
    kn = rng.standard_normal((B, T, n_kv, hd)).astype(np.float32)
    vn = rng.standard_normal((B, T, n_kv, hd)).astype(np.float32)
    rk, rv = write_kv_layer(jk, jv, jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pt),
                            jnp.asarray(pos))
    kv_write_plain(pk, pv, torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(pt),
                   torch.from_numpy(pos))
    _assert_pools_match(pk, rk, skip_page0=True)
    _assert_pools_match(pv, rv, skip_page0=True)


def test_kv_write_plain_dense_view_matches_kv_write_dense1():
    from jlama_tpu.ops.pallas_kv import kv_write_dense1

    rng = np.random.default_rng(3)
    pool = rng.normal(size=(1, 4, 32, 64)).astype(np.float32)
    new = rng.normal(size=(1, 4, 1, 64)).astype(np.float32)
    for pos in (0, 7, 8, 31):
        ref = kv_write_dense1(jnp.asarray(pool), jnp.asarray(new), jnp.int32(pos),
                              interpret=True)
        k = torch.from_numpy(pool.copy())
        v = torch.from_numpy(pool.copy())
        rows = torch.from_numpy(new).permute(0, 2, 1, 3)  # [B, T, n_kv, hd]
        kv_write_plain(dense_pool_view(k), dense_pool_view(v), rows, rows,
                       dense_page_table(1, "cpu"), torch.tensor([[pos]]))
        np.testing.assert_array_equal(k.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref))


# quantized: False an f32 pool, True a q8 pool, "bf16" a bf16 pool (whose
# probabilities the JAX kernel rounds to bf16 before P.V, as it does for q8:
# the q8 tolerance)
@pytest.mark.parametrize("quantized,hd,softcap,window", [
    (False, 64, None, None), (True, 64, None, None),  # tests/test_pallas_attention.py:77-105
    (False, 64, 30.0, None), (False, 64, None, 7), (True, 64, 20.0, 5),
    (False, 128, None, None), (True, 128, None, None),
    # Gemma 2's head size and softcap
    (False, 256, None, None), (True, 256, None, None), ("bf16", 256, None, None),
    (False, 256, 50.0, 7), (True, 256, 50.0, 5), ("bf16", 256, 50.0, 7),
])
def test_paged_decode_plain_matches_jax_kernel(quantized, hd, softcap, window):
    from jlama_tpu.ops.pallas_attention import paged_decode

    rng = np.random.default_rng(2 + hd)
    B, H, n_kv, ps, n_pages = 3, 4, 2, 8, 9
    shape = (n_kv, n_pages, ps, hd)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    if quantized is True:
        jk, jv = _q8_pool_np(rng, shape), _q8_pool_np(rng, shape)
        jargs = ((jk.data, jk.scales), (jv.data, jv.scales))
    else:
        dt = jnp.bfloat16 if quantized == "bf16" else jnp.float32
        jk = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dt)
        jv = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dt)
        jargs = (jk, jv)
    # the third row is an empty decode slot: length 1 on the scratch page
    pt = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    lengths = np.array([19, 12, 1], np.int32)
    scale = hd ** -0.5
    ref = paged_decode(jnp.asarray(q), *jargs, jnp.asarray(pt), jnp.asarray(lengths), scale,
                       softcap=softcap, window=window, interpret=True)
    if quantized == "bf16":
        pk, pv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jk, jv))
    else:
        pk, pv = from_jax_kv_state(jax_tree_to_numpy((jk, jv)), device="cpu")
    got = paged_decode_plain(torch.from_numpy(q), pk, pv, torch.from_numpy(pt),
                             torch.from_numpy(lengths), scale, softcap, window)
    tol = 3e-3 if quantized else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None), (None, 7), (20.0, 5)])
def test_paged_decode_plain_dense_view_matches_jax_dense_decode(softcap, window):
    """K2's route for the Engine's dense T = 1 attention: the dense cache [B,
    n_kv, S, hd] cut to its window and seen as B pages of that many slots
    (dense_pool_view, dense_page_table, lengths = position + 1), against the
    JAX package's dense decode step (multi_head_attention under that step's
    attention_scores_mask), in f32."""
    from jlama_tpu.nn.layers import attention_scores_mask, multi_head_attention

    rng = np.random.default_rng(11)
    B, H, n_kv, hd, S, W = 3, 8, 2, 64, 40, 24
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    pos = np.array([[0], [13], [23]], np.int32)  # each row's new token
    scale = hd ** -0.5
    mask = attention_scores_mask(jnp.asarray(pos), W, True, window)
    ref = multi_head_attention(jnp.asarray(q[:, None]), jnp.asarray(k[:, :, :W]),
                               jnp.asarray(v[:, :, :W]), mask, scale, softcap)[:, 0]
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    got = paged_decode_plain(torch.from_numpy(q), dense_pool_view(kt[:, :, :W]),
                             dense_pool_view(vt[:, :, :W]), dense_page_table(B, kt.device),
                             torch.from_numpy(pos[:, 0] + 1), scale, softcap, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_paged_decode_plain_zero_length_rows_are_zero():
    pool = torch.randn((1, 2, 4, 64))
    out = paged_decode_plain(torch.randn((2, 2, 64)), pool, pool,
                             torch.tensor([[1], [1]]), torch.tensor([0, 3]), 0.125)
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out[1]))


# ---------------------------------------------------------------------------
# the cases of tests/test_paged_kv.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from jlama_tpu_torch.models.loader import load_params

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tiny_torch_paged"))
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return model_dir, params, cfg


@pytest.fixture(scope="module")
def tiny_hd32(tmp_path_factory):
    """head_size 32 so the q8 KV cache's block-32 quantization axis fits."""
    from jlama_tpu_torch.models.loader import load_params

    model_dir, _ = make_tiny_llama(
        tmp_path_factory.mktemp("tiny_torch_hd32"),
        config_overrides={"hidden_size": 128, "num_attention_heads": 4,
                          "num_key_value_heads": 2})
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    assert cfg.head_size == 32
    return params, cfg


def _paged(cfg, dtype=torch.float32, n_pages=8, ps=4, P=4):
    return PagedKVCache(cfg, n_pages=n_pages, page_size=ps, max_pages_per_seq=P, dtype=dtype,
                        device="cpu")


def _pt(cache, seqs):
    return torch.from_numpy(cache.page_table(seqs))


def test_paged_matches_dense_and_jax(tiny):
    from jlama_tpu.kv.paged import PagedKVCache as JCache
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.base import KVCache, forward_logits

    model_dir, params, cfg = tiny
    tokens = torch.tensor([[1, 5, 9, 42, 7, 13]])
    pos = torch.arange(6)[None, :]
    dense = KVCache.init(cfg, 1, 16, torch.float32)
    dlog, _ = forward_logits(params, cfg, tokens[:, :4], pos[:, :4], dense, dtype=torch.float32)
    paged = _paged(cfg)
    paged.alloc.ensure_capacity("s1", 4, 4)
    plog, _ = forward_logits(params, cfg, tokens[:, :4], pos[:, :4],
                             (paged.layer_states(), _pt(paged, ["s1"])), dtype=torch.float32)
    torch.testing.assert_close(plog, dlog, rtol=1e-4, atol=1e-4)
    # the JAX package's paged forward, and its pools after the same writes
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    jc = JCache(jcfg, n_pages=8, page_size=4, max_pages_per_seq=4, dtype=jnp.float32)
    jc.alloc.ensure_capacity("s1", 4, 4)
    jlog, jstate = jforward(jp, jcfg, jnp.asarray(tokens[:, :4].numpy()),
                            jnp.asarray(pos[:, :4].numpy()),
                            (jc.state, jnp.asarray(jc.page_table(["s1"]))), dtype=jnp.float32)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
    jk = from_jax_kv_state(jax_tree_to_numpy(tuple(jstate[0])), device="cpu")
    for a, b in zip(paged.state, jk):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    # decode two more tokens, crossing a page boundary (page_size=4)
    for t in range(4, 6):
        dl, _ = forward_logits(params, cfg, tokens[:, t:t + 1], pos[:, t:t + 1], dense,
                               dtype=torch.float32)
        paged.alloc.ensure_capacity("s1", t + 1, 4)
        pl, _ = forward_logits(params, cfg, tokens[:, t:t + 1], pos[:, t:t + 1],
                               (paged.layer_states(), _pt(paged, ["s1"])), dtype=torch.float32)
        torch.testing.assert_close(pl, dl, rtol=1e-4, atol=1e-4)


def test_paged_batch_isolation(tiny):
    from jlama_tpu_torch.models.base import forward_logits

    _, params, cfg = tiny
    paged = _paged(cfg, n_pages=16)
    paged.alloc.ensure_capacity("a", 3, 4)
    paged.alloc.ensure_capacity("b", 3, 4)
    toks = torch.tensor([[1, 5, 9], [1, 7, 30]])
    pos = torch.tensor([[0, 1, 2], [0, 1, 2]])
    l2, _ = forward_logits(params, cfg, toks, pos, (paged.layer_states(),
                                                    _pt(paged, ["a", "b"])), dtype=torch.float32)
    single = _paged(cfg, n_pages=16)
    single.alloc.ensure_capacity("a", 3, 4)
    l1, _ = forward_logits(params, cfg, toks[:1], pos[:1],
                           (single.layer_states(), _pt(single, ["a"])), dtype=torch.float32)
    torch.testing.assert_close(l2[0], l1[0], rtol=1e-4, atol=1e-4)


def test_allocator_reuse():
    a = PageAllocator(8)
    assert a.n_free == 7  # page 0 reserved
    assert len(a.ensure_capacity("x", 10, 4)) == 3
    a.release("x")
    assert a.n_free == 7
    assert len(a.ensure_capacity("y", 4, 4)) == 1
    with pytest.raises(MemoryError):
        a.ensure_capacity("z", 1000, 4)


def test_q8_kv_pool_matches_f32_within_tolerance(tiny_hd32):
    from jlama_tpu_torch.models.base import forward_logits

    params, cfg = tiny_hd32
    toks = torch.tensor([[1, 5, 9, 42, 7, 13, 2, 8]])
    pos = torch.arange(8)[None, :]
    ref = _paged(cfg)
    ref.alloc.ensure_capacity("s", 8, 4)
    rlog, _ = forward_logits(params, cfg, toks, pos, (ref.layer_states(), _pt(ref, ["s"])),
                             dtype=torch.float32)
    q8 = _paged(cfg, dtype="q8")
    assert isinstance(q8.state.k_pool, QArray)
    # q8 pool bytes = about half of a bf16 pool of the same token capacity
    bf16 = _paged(cfg, dtype=torch.bfloat16)
    q8_bytes = q8.state.k_pool.data.nbytes + q8.state.k_pool.scales.nbytes
    assert q8_bytes < bf16.state.k_pool.nbytes * 0.6 + 1
    q8.alloc.ensure_capacity("s", 8, 4)
    qlog, _ = forward_logits(params, cfg, toks, pos, (q8.layer_states(), _pt(q8, ["s"])),
                             dtype=torch.float32)
    assert (rlog - qlog).abs().max() / (rlog.abs().max() + 1e-9) < 0.02


def test_q8_kv_decode_steps(tiny_hd32):
    from jlama_tpu_torch.models.base import forward_logits

    params, cfg = tiny_hd32
    toks = torch.tensor([[1, 5, 9, 42, 7, 13]])
    pos = torch.arange(6)[None, :]
    outs = {}
    for name, dt in (("f32", torch.float32), ("q8", "q8")):
        c = _paged(cfg, dtype=dt)
        c.alloc.ensure_capacity("s", 4, 4)
        forward_logits(params, cfg, toks[:, :4], pos[:, :4], (c.layer_states(), _pt(c, ["s"])),
                       dtype=torch.float32)
        logs = []
        for t in range(4, 6):
            c.alloc.ensure_capacity("s", t + 1, 4)
            lg, _ = forward_logits(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                                   (c.layer_states(), _pt(c, ["s"])), dtype=torch.float32)
            logs.append(lg[0, -1])
        outs[name] = logs
    for a, b in zip(outs["f32"], outs["q8"]):
        assert torch.argmax(a) == torch.argmax(b)
        assert (a - b).abs().max() / (a.abs().max() + 1e-9) < 0.02


def test_from_jax_kv_state_q8_and_layer_views():
    rng = np.random.default_rng(0)
    jk = _q8_pool_np(rng, (2, 2, 3, 4, 32))
    st = from_jax_kv_state(jax_tree_to_numpy((jk, jk)), device="cpu")
    assert isinstance(st, PagedKVState) and isinstance(st.k_pool, QArray)
    assert st.k_pool.data.dtype == torch.int8 and st.k_pool.scales.shape == (2, 2, 3, 4, 1)
    np.testing.assert_array_equal(st.v_pool.data.numpy(), np.asarray(jk.data))
    with pytest.raises(ValueError, match="q8"):
        from_jax_kv_state(((np.zeros(4, np.uint8), np.zeros(1, np.float32), "q4"),) * 2,
                          device="cpu")


@pytest.mark.parametrize("case", ["f32", "q8", "q4", "f16 scales", "ragged blocks"])
def test_pool_parts_takes_float_and_q8_pools_only(case):
    """The kernels' wrappers read a pool through `pool_parts`: a float pool
    (blk = hd) or a q8 pool with f32 block scales; anything else raises."""
    from jlama_tpu_torch.ops.kv_write import pool_parts

    d = torch.zeros((2, 3, 4, 64), dtype=torch.int8)
    s = torch.zeros((2, 3, 4, 2))
    pool = {"f32": torch.zeros((2, 3, 4, 64)), "q8": QArray(d, s, "q8"),
            "q4": QArray(d, s, "q4"), "f16 scales": QArray(d, s.half(), "q8"),
            "ragged blocks": QArray(d, torch.zeros((2, 3, 4, 3)), "q8")}[case]
    if case == "f32":
        assert pool_parts(pool, "t")[1:] == (None, torch.float32, 64)
    elif case == "q8":
        assert pool_parts(pool, "t")[2:] == ("q8", 32)
    else:
        with pytest.raises(ValueError, match="q8 pool"):
            pool_parts(pool, "t")
