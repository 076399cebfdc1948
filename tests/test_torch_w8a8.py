"""The port's q4s format and K5's plain version (jlama_tpu_torch.ops.w8a8),
held against jlama_tpu.ops.pallas_w8a8 (its numpy to_q4s and its w8a8 kernel
in interpret mode), and W4A8 serving through the port's BatchScheduler held
against jlama_tpu's with the kernel (JLAMA_Q4S_KERNEL=1) in interpret mode."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu.nn.qarray import quantize_q4 as jquantize_q4
from jlama_tpu.ops import pallas_w8a8 as jw8
from jlama_tpu.quant.blockq import q4_dequantize_np, q4_quantize_np

from jlama_tpu_torch.models.convert import from_jax_params
from jlama_tpu_torch.nn.qarray import QArray, quantize_q4
from jlama_tpu_torch.ops import w8a8
from jlama_tpu_torch.ops.linear import linear
from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState
from tests.test_torch_bridge import jax_tree_to_numpy

GROUP = w8a8.GROUP


def _weights(seed, n, k, case="random"):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    if case == "negative":  # both signs of the block extreme: signed JQ4 scales
        w[0, :32] = -w[0, :32]
        w[1::2, 32:64] *= -3.0
    elif case == "zero_group":  # an all-zero group: gmax == 0 -> 1
        w[1, :GROUP] = 0.0
        w[-1, -GROUP:] = 0.0
    return w


def _jax_q4s_np(q):
    """A JAX q4s QArray as (values int8 [N, K] in element order, sigma
    [N, K/32], swk [N, K/256])."""
    d = np.asarray(q.data)  # [ngrp, N, 128]
    inv = np.argsort(jw8._group_perm())
    lo = (d & 0x0F).astype(np.int16)[:, :, inv] - 8
    hi = (d >> 4).astype(np.int16)[:, :, inv] - 8
    ngrp, n, _ = d.shape
    vals = np.concatenate([lo, hi], axis=2).transpose(1, 0, 2).reshape(n, ngrp * GROUP)
    sigma = np.asarray(q.scales[0]).transpose(1, 0, 2).reshape(n, -1)
    swk = np.asarray(q.scales[1])[:, 0, :].T
    return vals, sigma, swk


@pytest.mark.parametrize("n,k,case", [(64, 512, "random"), (37, 1024, "random"),
                                      (8, GROUP, "negative"), (16, 768, "zero_group")])
def test_to_q4s_matches_jax(n, k, case):
    """Values, sigma and swk equal the JAX package's numpy to_q4s exactly,
    and the dequant is bit-equal to q4s_dequantize_np (tolerance 0)."""
    packed, scales = q4_quantize_np(_weights(n + k, n, k, case))
    if case == "negative":
        assert scales.min() < 0
    if case == "zero_group":
        assert (np.abs(scales).reshape(n, -1, 8).max(axis=2) == 0).any()
    jq = jw8.to_q4s(JQArray(jnp.asarray(packed), jnp.asarray(scales), "q4"))
    pq = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales), "q4"))
    vals, sigma, swk = _jax_q4s_np(jq)
    np.testing.assert_array_equal(w8a8.q4s_unpack(pq.data).numpy(), vals)
    np.testing.assert_array_equal(pq.unpack().numpy(), vals)
    np.testing.assert_array_equal(pq.scales[0].numpy(), sigma)
    np.testing.assert_array_equal(pq.scales[1].numpy(), swk)
    assert pq.shape == (n, k) and pq.data.shape == (n, k // 2)
    np.testing.assert_array_equal(w8a8.q4s_dequantize(pq).numpy(), jw8.q4s_dequantize_np(jq))
    np.testing.assert_array_equal(pq.dequantize().numpy(), jw8.q4s_dequantize_np(jq))


def test_bridge_maps_jax_q4s_layout():
    """A JAX q4s leaf through from_jax_params is the port's own to_q4s of the
    same JQ4 weight, byte for byte."""
    packed, scales = q4_quantize_np(_weights(5, 24, 512))
    jq = jw8.to_q4s(JQArray(jnp.asarray(packed), jnp.asarray(scales), "q4"))
    got = from_jax_params({"lm_head": jax_tree_to_numpy(jq), "layers": []}, device="cpu")
    want = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales), "q4"))
    assert got["lm_head"].fmt == "q4s"
    assert torch.equal(got["lm_head"].data, want.data)
    assert all(torch.equal(a, b) for a, b in zip(got["lm_head"].scales, want.scales))


@pytest.mark.parametrize("out_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [384, 1000])
@pytest.mark.parametrize("k", [256, 1024])
@pytest.mark.parametrize("m", [1, 5, 37])
def test_q4s_matmul_plain_matches_jax_kernel(m, k, n, out_dtype):
    """q4s_matmul_plain against the JAX w8a8 kernel in interpret mode: f32 out
    within 1e-5 * max|ref| (the same integer dots; f32 products and sums
    rounded in the same order, up to XLA's contractions); bf16 out within one
    bf16 ulp of the reference plus that (two f32 results that agree to ~1e-7
    can round to neighbouring bf16 values)."""
    packed, scales = q4_quantize_np(_weights(m * n + k, n, k, "negative"))
    jq = jw8.to_q4s(JQArray(jnp.asarray(packed), jnp.asarray(scales), "q4"))
    pq = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales), "q4"))
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :GROUP] = 0.0  # an all-zero activation group (scale 0)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out_dtype]
    ref = np.asarray(jw8.q4s_matmul(jnp.asarray(x), jq, out_dtype=jdt,
                                    interpret=True).astype(jnp.float32))
    got = w8a8.q4s_matmul(torch.from_numpy(x), pq, tdt).float().numpy()
    assert got.shape == (m, n)
    lim = 1e-5 * np.abs(ref).max()
    if out_dtype == "bf16":
        lim = lim + 2.0 ** -7 * np.abs(ref)  # one bf16 ulp is at most 2^-7 of |value|
    assert np.all(np.abs(got - ref) <= lim), float(np.abs(got - ref).max())


def test_q4s_rerounding_bounded():
    """Every re-rounded weight stays within 0.66 q4 steps (of the group's
    largest block scale) of the JQ4 dequantized value (analog of
    tests/test_pallas_w8a8.py)."""
    packed, scales = q4_quantize_np(_weights(0, 64, 512))
    orig = q4_dequantize_np(packed, scales)
    deq = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales))).dequantize()
    err = np.abs(deq.numpy() - orig).reshape(64, -1, GROUP)
    gmax = np.abs(scales).repeat(32, axis=1).reshape(64, -1, GROUP).max(axis=2, keepdims=True)
    assert np.all(err <= 0.66 * gmax + 1e-7), float((err - 0.66 * gmax).max())


def test_q4s_negative_scales_exact():
    """Signed JQ4 scales fold into the values: the error stays within 0.7 of
    the largest scale."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, GROUP)).astype(np.float32)
    w[0, :32] = -w[0, :32]
    packed, scales = q4_quantize_np(w)
    assert scales.min() < 0
    orig = q4_dequantize_np(packed, scales)
    deq = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales))).dequantize()
    assert np.abs(deq.numpy() - orig).max() <= 0.7 * np.abs(scales).max()


def test_q4s_matmul_plain_exact_on_lossless_activations():
    """Activations that quantize losslessly (integers in [-127, 127] times
    0.5, each group holding a +-127) give x @ dequant(q4s).T within f32
    rounding (1e-5 relative)."""
    n, k, m = 256, 512, 4
    packed, scales = q4_quantize_np(_weights(1, n, k))
    q = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales)))
    rng = np.random.default_rng(0)
    ints = rng.integers(-127, 128, (m, k)).astype(np.float32)
    ints[:, ::GROUP] = 127.0
    x = torch.from_numpy(ints * 0.5)
    xq, xs = w8a8.blockq.q8_quantize(x, block=GROUP)
    assert torch.equal(xq.float() * 0.5, x) and torch.all(xs == 0.5)
    y = w8a8.q4s_matmul_plain(x, q, torch.float32)
    ref = x.double() @ q.dequantize().double().t()
    assert ((y.double() - ref).abs().max() / ref.abs().max()).item() < 1e-5


def test_q4s_noise_within_q4_envelope():
    """q4s's weight noise and K5's output error (int8 activations included)
    stay within 1.6x of q4's own (analog of tests/test_pallas_w8a8.py)."""
    n, k, m = 128, 512, 2
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    packed, scales = q4_quantize_np(w)
    q = w8a8.to_q4s(QArray(torch.from_numpy(packed), torch.from_numpy(scales)))
    wt_q4 = q4_dequantize_np(packed, scales)
    wt_q4s = q.dequantize().numpy()
    q4_noise = np.sqrt(np.mean((wt_q4 - w) ** 2))
    assert np.sqrt(np.mean((wt_q4s - w) ** 2)) < 1.6 * q4_noise
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = w8a8.q4s_matmul_plain(torch.from_numpy(x), q, torch.float32).numpy()
    true = x @ w.T
    err_q4 = np.sqrt(np.mean((x @ wt_q4.T - true) ** 2))
    assert np.sqrt(np.mean((y - true) ** 2)) < 1.6 * err_q4


def _port_tree(k=GROUP, misaligned=96):
    """A per-layer port tree with a q4 embedding (tied head), two aligned
    layer weights and one whose K is not a multiple of 256."""
    rng = np.random.default_rng(4)

    def q(n, kk):
        return quantize_q4((rng.standard_normal((n, kk)) * 0.05).astype(np.float32))

    layers = [{"wq": q(64, k), "w2": q(k, 2 * k), "wx": q(32, misaligned),
               "attn_norm.weight": torch.ones(k)} for _ in range(2)]
    return {"embed": q(96, k), "layers": layers, "final_norm.weight": torch.ones(k)}


def test_prepare_params_for_w8a8():
    tree = _port_tree()
    out = w8a8.prepare_params_for_w8a8(tree)
    layer = out["layers"][0]
    assert layer["wq"].fmt == layer["w2"].fmt == "q4s"
    assert layer["wx"].fmt == "q4"  # K = 96: stays q4 and keeps taking K1
    assert out["embed"].fmt == "q4"  # the row gather reads it
    assert out["lm_head"].fmt == "q4s"  # a tied head gets a q4s copy
    assert "lm_head" not in tree and tree["layers"][0]["wq"].fmt == "q4"  # input untouched
    assert torch.equal(out["lm_head"].dequantize(), w8a8.to_q4s(tree["embed"]).dequantize())


def test_linear_dispatches_q4s_to_the_plain_version(monkeypatch):
    calls = []
    plain = w8a8.q4s_matmul_plain
    monkeypatch.setattr(w8a8, "q4s_matmul_plain", lambda *a: calls.append(1) or plain(*a))
    w = w8a8.prepare_params_for_w8a8(_port_tree())["layers"][1]["wq"]
    x = torch.randn((2, 3, GROUP), generator=torch.Generator().manual_seed(0))
    launches = w8a8.q4s_matmul.launches
    y = linear(x, w, out_dtype=torch.float32)
    assert calls == [1] and w8a8.q4s_matmul.launches == launches
    assert y.shape == (2, 3, 64)
    assert torch.equal(y, plain(x, w, torch.float32))


def test_fuse_refuses_q4s():
    from jlama_tpu_torch.models.base import fuse_params

    tree = _port_tree()
    for layer in tree["layers"]:
        layer.update(wk=layer["wq"], wv=layer["wq"])
    with pytest.raises(ValueError, match="q4s"):
        fuse_params(w8a8.prepare_params_for_w8a8(tree))


def test_q4s_matmul_rejects_other_devices_and_formats():
    w = w8a8.to_q4s(quantize_q4(np.ones((8, GROUP), np.float32))).to("meta")
    with pytest.raises(ValueError, match="device"):
        w8a8.q4s_matmul(torch.ones((1, GROUP), device="meta"), w)
    with pytest.raises(ValueError, match="fmt q4s"):
        w8a8.q4s_matmul(torch.ones((1, 32)), quantize_q4(np.ones((8, 32), np.float32)))


def test_jax_prepared_tree_equals_port_prepare():
    """JAX's prepare_params_for_w8a8 on a stacked tree, through the bridge,
    equals the port's own prepare of the same q4 tree, byte for byte."""
    from jlama_tpu.ops.pallas_w8a8 import prepare_params_for_w8a8 as jprepare

    rng = np.random.default_rng(6)
    L, n, k = 2, 64, 2 * GROUP
    w = (rng.standard_normal((L, n, k)) * 0.05).astype(np.float32)
    jtree = {"layers": {"wq": jquantize_q4(w)},
             "embed": jquantize_q4((rng.standard_normal((96, k)) * 0.05).astype(np.float32))}
    got = from_jax_params(jax_tree_to_numpy(jprepare(jtree)), device="cpu")
    want = w8a8.prepare_params_for_w8a8(from_jax_params(jax_tree_to_numpy(jtree), device="cpu"))
    for a, b in [(got["lm_head"], want["lm_head"])] + [
            (g["wq"], p["wq"]) for g, p in zip(got["layers"], want["layers"], strict=True)]:
        assert a.fmt == b.fmt == "q4s"
        assert torch.equal(a.data, b.data)
        assert all(torch.equal(s, t) for s, t in zip(a.scales, b.scales))
    assert got["embed"].fmt == "q4"


# ---------------------------------------------------------------------------
# W4A8 serving against jlama_tpu's BatchScheduler(weight_format="q4s")
# ---------------------------------------------------------------------------

Q4S_CONFIG = {
    "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
    "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
    "rms_norm_eps": 1e-5, "vocab_size": 512, "max_position_embeddings": 64,
    "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "tie_word_embeddings": True,
}
PROMPT = [1, 5, 9, 42, 7]
CONCURRENT = [[1, 5, 9], [1, 7, 30, 12], [1, 2], [1, 44, 17, 80, 3]]
LONG = [1] + [(i * 7) % 200 + 2 for i in range(40)]
SERVE = dict(n_slots=4, n_pages=32, page_size=8, max_seq_len=56)


@pytest.fixture(scope="module")
def q4s_model():
    """Every weight K % 256 == 0 and a q4 embedding with tied weights, so
    that every projection and the lm_head are q4s."""
    from jlama_tpu.config import from_hf_config
    from jlama_tpu.models.init import init_params

    cfg = from_hf_config(Q4S_CONFIG)
    params = init_params(cfg, seed=0, dtype=jnp.float32)
    layers = {k: jquantize_q4(np.asarray(v, np.float32))
              if k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3") else v
              for k, v in params["layers"].items()}
    return cfg, dict(params, layers=layers, embed=jquantize_q4(np.asarray(params["embed"])))


@pytest.fixture(scope="module")
def jax_q4s_ids(q4s_model):
    from jax.experimental.pallas import tpu as pltpu

    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    cfg, params = q4s_model
    kw = dict(SERVE, kv_dtype=jnp.float32, compute_dtype=jnp.float32, weight_format="q4s")
    out = {}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setenv("JLAMA_Q4S_KERNEL", "1")  # the w8a8 kernel, not the f32 dequant
        js = JSched(params, cfg, **kw)
        assert js.params["lm_head"].fmt == "q4s"
        out["single"] = js.generate(PROMPT, max_new_tokens=8).token_ids
        reqs = [JReq(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
        for r in reqs:
            js.submit(r)
        while any(r.state.value != "DONE" for r in reqs):
            js.step()
        out["concurrent"] = [r.out_ids for r in reqs]
        chunked = JSched(params, cfg, **dict(kw, n_slots=2, prefill_chunk=8))
        out["chunked"] = chunked.generate(LONG, max_new_tokens=5).token_ids
    return out


def _port_sched(q4s_model, **kw):
    cfg, params = q4s_model
    args = dict(SERVE, kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
                weight_format="q4s")
    args.update(kw)
    return BatchScheduler(from_jax_params(jax_tree_to_numpy(params), device="cpu"), cfg,
                          **args)


def test_q4s_scheduler_converts_after_fusing(q4s_model):
    sched = _port_sched(q4s_model)
    layer = sched.params["layers"][0]
    assert {layer[k].fmt for k in ("wqkv", "wo", "w13", "w2")} == {"q4s"}
    assert sched.params["lm_head"].fmt == "q4s" and sched.params["embed"].fmt == "q4"
    for bad in ("q8", "q4k"):  # q4k: K1 reads JQ4 as it is, so None serves q4
        with pytest.raises(ValueError, match="weight_format"):
            _port_sched(q4s_model, weight_format=bad)
    q4 = _port_sched(q4s_model, weight_format=None)
    assert q4.params["layers"][0]["wqkv"].fmt == "q4" and "lm_head" not in q4.params


def test_q4s_greedy_single_matches_jax(q4s_model, jax_q4s_ids):
    assert _port_sched(q4s_model).generate(PROMPT, max_new_tokens=8).token_ids \
        == jax_q4s_ids["single"]


def test_q4s_concurrent_matches_jax(q4s_model, jax_q4s_ids):
    sched = _port_sched(q4s_model)
    reqs = [GenRequest(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
    for r in reqs:
        sched.submit(r)
    for _ in range(200):
        if all(r.state == RequestState.DONE for r in reqs):
            break
        sched.step()
    assert [r.out_ids for r in reqs] == jax_q4s_ids["concurrent"]


def test_q4s_chunked_prefill_matches_jax(q4s_model, jax_q4s_ids):
    sched = _port_sched(q4s_model, n_slots=2, prefill_chunk=8)
    assert sched.generate(LONG, max_new_tokens=5).token_ids == jax_q4s_ids["chunked"]
    assert sched.n_prefill_calls == 5
