"""K4 with RoPE fused in (jlama_tpu_torch.ops.kv_write with q=, cos=, sin=) on
the CPU, through its plain version: bit for bit against the unfused chain it
replaces (the port's `apply_rope` on q and k, then the plain write), and
against the JAX chain `jlama_tpu.nn.rope.apply_rope` +
`jlama_tpu.kv.paged.write_kv_layer` (on the dense view `kv_write_dense1` in
interpret mode). Also: the cached forward paths call no separate RoPE.

Tolerances against JAX: f32 values within 1e-6 of max |JAX|; bf16 values
within one bf16 ulp (2^-7 of the larger magnitude); q8 payloads within 1 code
and scales within 1 ulp, as `chip_smoke.py` holds K4's q8 pools."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.nn.rope import apply_rope
from jlama_tpu_torch.ops.kv_write import (
    dense_page_table, dense_pool_view, kv_write, kv_write_plain)
from jlama_tpu_torch.quant.blockq import q8_quantize

N_KV, H, N_PAGES, PS, P = 2, 4, 12, 4, 3
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(hd, B, T, act, seed):
    """numpy f32 q, k, v, cos, sin, page tables and positions: row 0 crosses a
    page boundary (T = 5), row 1 is a pad row on the scratch page 0, row 2
    runs past its page table (dropped from there on)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, N_KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, N_KV, hd)).astype(np.float32)
    pt = (rng.permutation(N_PAGES - 1)[: 3 * P] + 1).astype(np.int32).reshape(3, P)[:B]
    starts = [3, 0, P * PS - T + 2][:B]
    if B > 1:
        pt[1] = 0
    pos = (np.array(starts)[:, None] + np.arange(T)[None, :]).astype(np.int64)
    inv = (1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))).astype(np.float32)
    ang = pos[..., None].astype(np.float32) * inv
    if act == "bf16":  # values the activation dtype holds exactly
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v))
    return q, k, v, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32), pt, pos


def _pool_np(kind, hd, seed):
    """(f32 values, q8 payload, q8 scales) of one pool [N_KV, N_PAGES, PS, hd]."""
    x = np.random.default_rng(seed).standard_normal((N_KV, N_PAGES, PS, hd)).astype(np.float32)
    if kind != "q8":
        return x, None, None
    d, s = q8_quantize(torch.from_numpy(x))
    return x, d.numpy(), s.numpy()


def _torch_pool(kind, pool):
    x, d, s = pool
    if kind == "q8":
        return QArray(torch.from_numpy(d.copy()), torch.from_numpy(s.copy()), "q8")
    return torch.from_numpy(x.copy()).to(DTYPES[kind][0])


def _jax_pool(kind, pool):
    x, d, s = pool
    if kind == "q8":
        return JQArray(jnp.asarray(d), jnp.asarray(s), "q8")
    return jnp.asarray(x).astype(DTYPES[kind][1])


def _parent_chain(k_pool, v_pool, q, k, v, pt, pos, cos, sin):
    """The unfused chain: the port's `apply_rope` on q and k, then the
    plain KV write of the tree before the fusion."""
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    _old_write(k_pool, v_pool, k, v, pt, pos)
    return q


def _old_write(k_pool, v_pool, k, v, pt, pos):
    """The plain KV write before the fusion, spelled out."""
    ps = (k_pool.data if isinstance(k_pool, QArray) else k_pool).shape[2]
    col = pos.long() // ps
    pages = torch.gather(pt.long(), 1, torch.clamp(col, max=pt.shape[1] - 1)).reshape(-1)
    offs, keep = (pos.long() % ps).reshape(-1), (col < pt.shape[1]).reshape(-1)
    for pool, new in ((k_pool, k), (v_pool, v)):
        B, T, n_kv, hd = new.shape
        rows = new.reshape(B * T, n_kv, hd).transpose(0, 1)[:, keep]
        if isinstance(pool, QArray):
            d, s = q8_quantize(rows, block=hd // pool.scales.shape[-1])
            pool.data[:, pages[keep], offs[keep]] = d
            pool.scales[:, pages[keep], offs[keep]] = s
        else:
            pool[:, pages[keep], offs[keep]] = rows.to(pool.dtype)


def _torch_args(inp, act):
    q, k, v, cos, sin, pt, pos = inp
    dt = DTYPES[act][0]
    return ([torch.from_numpy(x).to(dt) for x in (q, k, v)],
            [torch.from_numpy(x) for x in (cos, sin, pt, pos)])


CASES = [(hd, B, T) for hd in (64, 128) for B in (1, 3) for T in (1, 5)]


@pytest.mark.parametrize("hd,B,T", CASES)
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_fused_plain_equals_parent_chain(act, kind, hd, B, T):
    """q_rot, both pools and the q8 scales equal the unfused chain's bit for
    bit, and `kv_write` on CPU tensors is the plain version."""
    inp = _inputs(hd, B, T, act, seed=hd + 10 * B + T)
    (q, k, v), (cos, sin, pt, pos) = _torch_args(inp, act)
    pools = [_pool_np(kind, hd, s) for s in (1, 2)]
    ref = [_torch_pool(kind, p) for p in pools]
    ref_q = _parent_chain(*ref, q, k, v, pt, pos, cos, sin)
    for fn in (kv_write_plain, kv_write):
        got = [_torch_pool(kind, p) for p in pools]
        got_q = fn(*got, k, v, pt, pos, q=q, cos=cos, sin=sin)
        assert got_q.dtype == q.dtype and torch.equal(got_q, ref_q)
        for a, b in zip(got, ref):
            if kind == "q8":
                assert torch.equal(a.data, b.data)
                assert torch.equal(a.scales.view(torch.int32), b.scales.view(torch.int32))
            else:
                assert torch.equal(a, b)


def test_without_cos_nothing_rotates():
    """cos=None: q comes back as given (the same tensor), k is written as it
    is, as the write did before the fusion."""
    inp = _inputs(64, 3, 5, "f32", seed=0)
    (q, k, v), (_, _, pt, pos) = _torch_args(inp, "f32")
    pools = [_pool_np("f32", 64, s) for s in (1, 2)]
    got = [_torch_pool("f32", p) for p in pools]
    ref = [_torch_pool("f32", p) for p in pools]
    assert kv_write(*got, k, v, pt, pos, q=q) is q
    _old_write(*ref, k, v, pt, pos)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert kv_write_plain(*got, k, v, pt, pos) is None


def _close(got, ref, kind):
    """Within the stated tolerance of the JAX value (see the module docstring)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if kind == "f32":
        assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref).max())
    else:
        assert np.all(np.abs(got - ref) <= 2.0 ** -7 * np.maximum(np.abs(got), np.abs(ref)))


def _jax_rows(x, act):
    return jnp.asarray(x).astype(DTYPES[act][1])


@pytest.mark.parametrize("hd,B,T", [(64, 1, 1), (64, 3, 5), (128, 3, 1), (128, 3, 5)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("act", ["f32", "bf16"])
def test_fused_plain_matches_jax_chain(act, kind, hd, B, T):
    from jlama_tpu.kv.paged import write_kv_layer
    from jlama_tpu.nn.rope import apply_rope as japply_rope

    inp = _inputs(hd, B, T, act, seed=7 * hd + B + T)
    (q, k, v), (cos, sin, pt, pos) = _torch_args(inp, act)
    pools = [_pool_np(kind, hd, s) for s in (3, 4)]
    got = [_torch_pool(kind, p) for p in pools]
    got_q = kv_write_plain(*got, k, v, pt, pos, q=q, cos=cos, sin=sin)

    jq, jk, jv, jcos, jsin, jpt, jpos = inp
    jcos, jsin = jnp.asarray(jcos), jnp.asarray(jsin)
    ref_q = japply_rope(_jax_rows(jq, act), jcos, jsin)
    ref = write_kv_layer(*[_jax_pool(kind, p) for p in pools],
                         japply_rope(_jax_rows(jk, act), jcos, jsin), _jax_rows(jv, act),
                         jnp.asarray(jpt), jnp.asarray(jpos.astype(np.int32)))
    _close(got_q.float().numpy(), ref_q.astype(jnp.float32), act)
    live = slice(1, None)  # page 0: the pad row's writes race there
    for a, b in zip(got, ref):
        if kind == "q8":
            dd = np.abs(a.data.numpy()[:, live].astype(np.int32)
                        - np.asarray(b.data)[:, live].astype(np.int32))
            du = np.abs(a.scales.numpy()[:, live].view(np.int32).astype(np.int64)
                        - np.asarray(b.scales)[:, live].view(np.int32).astype(np.int64))
            assert dd.max() <= 1 and du.max() <= 1
        else:
            _close(a.float().numpy()[:, live], np.asarray(b.astype(jnp.float32))[:, live],
                   kind if kind == "bf16" or act == "bf16" else "f32")


@pytest.mark.parametrize("hd", [64, 128])
def test_fused_plain_dense_view_matches_kv_write_dense1(hd):
    """The `Engine`'s dense cache [1, n_kv, S, hd] as one page: q_rot and the
    cache against JAX's `apply_rope` and `kv_write_dense1(interpret=True)`
    of the rotated k and of v, at several positions."""
    from jlama_tpu.nn.rope import apply_rope as japply_rope
    from jlama_tpu.ops.pallas_kv import kv_write_dense1

    rng = np.random.default_rng(hd)
    cache = rng.standard_normal((1, N_KV, 32, hd)).astype(np.float32)
    for p in (0, 7, 8, 31):
        inp = _inputs(hd, 1, 1, "f32", seed=p)
        (q, k, v), _ = _torch_args(inp, "f32")
        inv = (1.0 / (10000.0 ** (np.arange(0, hd, 2) / hd))).astype(np.float32)
        ang = np.full((1, 1, 1), p, np.float32) * inv
        cos, sin = (torch.from_numpy(f(ang).astype(np.float32)) for f in (np.cos, np.sin))
        kc, vc = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
        got_q = kv_write_plain(dense_pool_view(kc), dense_pool_view(vc), k, v,
                               dense_page_table(1, "cpu"), torch.tensor([[p]]), q=q, cos=cos,
                               sin=sin)
        jcos, jsin = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
        jk = japply_rope(jnp.asarray(inp[1]), jcos, jsin)
        for got, new in ((kc, jk), (vc, jnp.asarray(inp[2]))):
            ref = kv_write_dense1(jnp.asarray(cache), new.transpose(0, 2, 1, 3), jnp.int32(p),
                                  interpret=True)
            _close(got.numpy(), ref, "f32")
        _close(got_q.numpy(), japply_rope(jnp.asarray(inp[0]), jcos, jsin), "f32")


@pytest.mark.parametrize("paged", [False, True])
def test_cached_forward_runs_no_separate_rope(monkeypatch, paged):
    """A forward with a cache (dense or paged) rotates q and k only inside
    the KV write (one plain K4 per layer, with cos/sin); without a cache,
    `nn.layers.apply_rope` runs twice per layer."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.kv.paged import PagedKVCache
    from jlama_tpu_torch.models.base import KVCache, forward_logits
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.nn import layers
    from jlama_tpu_torch.ops import kv_write as kvw
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(TINY_LLAMA_CONFIG)
    params = init_params(cfg, seed=0, quantize="q4", device="cpu", dtype=torch.float32)
    calls = {"rope": 0, "fused": 0}
    rope, plain = layers.apply_rope, kvw.kv_write_plain

    def counted_rope(*a):
        calls["rope"] += 1
        return rope(*a)

    def counted_plain(*a, **kw):
        calls["fused"] += kw.get("cos") is not None and kw.get("q") is not None
        return plain(*a, **kw)

    monkeypatch.setattr(layers, "apply_rope", counted_rope)
    monkeypatch.setattr(kvw, "kv_write_plain", counted_plain)
    toks, pos = torch.tensor([[3, 9, 4, 1]]), torch.arange(4)[None, :]
    if paged:
        kv = PagedKVCache(cfg, n_pages=4, page_size=4, max_pages_per_seq=2,
                          dtype=torch.float32, device="cpu")
        kv.alloc.ensure_capacity("s", 8, 4)
        cache = (kv.layer_states(), torch.from_numpy(kv.page_table(["s"])))
    else:
        cache = KVCache.init(cfg, 1, 16, torch.float32, "cpu")
    with torch.inference_mode():
        cached, _ = forward_logits(params, cfg, toks, pos, cache, dtype=torch.float32)
        assert calls == {"rope": 0, "fused": cfg.n_layers}
        alone, _ = forward_logits(params, cfg, toks, pos, None, dtype=torch.float32)
    assert calls == {"rope": 2 * cfg.n_layers, "fused": cfg.n_layers}
    torch.testing.assert_close(cached, alone, rtol=1e-5, atol=1e-5)
