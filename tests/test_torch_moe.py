"""Mixtral MoE in the port against jlama_tpu and transformers, on the CPU
(the plain version of K6, `ops/moe_q4.py`), at the tiny config of
tests/test_archs.py::test_mixtral (hidden 64, intermediate 128, 4 experts,
top-2, 2 layers).

Tolerances. The JAX package takes two routes for q4 experts:
`_moe_gathered` at B·T·K ≤ 8 (exact f32 dequantization, as the port at every
size) and `_moe_ragged` above (the weights rounded to bf16 first). So the
port is held to 1e-4 (f32 sums in another order) on the gathered side and to
2e-3 on the ragged side, the size of a bf16 weight rounding in these logits
(its relative step is 2^-9). Routing compares ids in f32 with random
routers, where top-k ties do not occur (`jax.lax.top_k` prefers the lower
index of a tie, `torch.topk` promises no order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import save_torch_model
from tests.test_torch_bridge import assert_trees_equal, port_tree

from jlama_tpu_torch.nn.qarray import QArray, quantize_q4
from jlama_tpu_torch.ops.moe_q4 import (DECODE_TILE_ROWS, TILE_ROWS, max_tiles, moe_gather,
                                        moe_groups, moe_groups_plain, moe_q4_gate_up,
                                        moe_q4_matmul, moe_q4_matmul_plain,
                                        moe_q4_matmul_tiled_plain, row_tile)

torch.backends.cuda.matmul.allow_tf32 = False

TINY_MIXTRAL = dict(
    model_type="mixtral", hidden_size=64, intermediate_size=128,
    num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
    rms_norm_eps=1e-5, vocab_size=256, max_position_embeddings=128,
    rope_theta=10000.0, hidden_act="silu", num_local_experts=4,
    num_experts_per_tok=2,
)
TOKENS = np.array([[1, 5, 9, 42, 7, 13, 2, 30]], dtype=np.int64)
GATHERED_TOL = 1e-4
RAGGED_TOL = 2e-3


def _ids(r, n_exp, case, rng):
    if case == "one":  # every row on one expert
        return np.full(r, n_exp - 1, np.int32)
    if case == "empty":  # expert 1 chosen by no row
        return rng.choice(np.array([0, 2, 3], np.int32), r)
    return rng.integers(0, n_exp, r).astype(np.int32)


def _expert_weights(n_exp, n, k, rng):
    w = rng.standard_normal((n_exp, n, k)).astype(np.float32) * 0.1
    return quantize_q4(w)


# ---------------------------------------------------------------------------
# K6's plain version and its grouping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("r", [1, 2, 8, 9, 64])
def test_moe_q4_plain_matches_per_row_dequant(r, case):
    rng = np.random.default_rng(r)
    w = _expert_weights(4, 40, 96, rng)
    e = torch.from_numpy(_ids(r, 4, case, rng))
    x = torch.from_numpy(rng.standard_normal((r, 96)).astype(np.float32))
    got = moe_q4_matmul_plain(x, w, e)
    ref = torch.stack([x[i] @ w[int(e[i])].dequantize(torch.float32).t() for i in range(r)])
    assert got.shape == (r, 40) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors runs the plain version and counts no launch
    before = moe_q4_matmul.launches
    torch.testing.assert_close(moe_q4_matmul(x, w, e), got, rtol=0, atol=0)
    assert moe_q4_matmul.launches == before


@pytest.mark.parametrize("t", [1, 4, 32])
def test_moe_q4_plain_token_rows_reach_each_of_their_experts(t):
    """ids [T, k]: row t of x goes through each of its k experts, y [T, k, N]
    equal to the same selections given one row each."""
    rng = np.random.default_rng(t)
    w = _expert_weights(4, 24, 64, rng)
    e = torch.from_numpy(rng.integers(0, 4, (t, 2)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((t, 64)).astype(np.float32))
    got = moe_q4_matmul_plain(x, w, e, out_dtype=torch.bfloat16)
    flat = moe_q4_matmul_plain(x.repeat_interleave(2, dim=0), w, e.reshape(-1),
                               out_dtype=torch.bfloat16)
    assert got.shape == (t, 2, 24) and got.dtype == torch.bfloat16
    assert torch.equal(got.reshape(-1, 24), flat)


@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("r", [1, 9, 64, 300])
def test_moe_groups_are_a_stable_sort_by_expert(r, case):
    rng = np.random.default_rng(r + 1)
    e_np = _ids(r, 4, case, rng)
    g = moe_groups(torch.from_numpy(e_np), 4)
    assert g.order.dtype == torch.int32 and g.offsets.dtype == torch.int32
    np.testing.assert_array_equal(g.order.numpy(), np.argsort(e_np, kind="stable"))
    np.testing.assert_array_equal(g.offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(e_np, minlength=4))]))
    assert moe_groups_plain(torch.from_numpy(e_np), 4).order.equal(g.order)


@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("r", [0, 1, 9, 64, 300, 1000])
def test_moe_groups_work_lists_match_an_enumeration(r, case):
    """Both routes' row tiles (the prefill route's of at most TILE_ROWS rows,
    the decode route's of at most DECODE_TILE_ROWS) against a direct
    enumeration of the sorted selections: every selection lies in exactly one
    tile, of its own expert; at most ceil(R / rows) + E tiles; an untouched
    expert has none; entries past the count hold -1; R = 0 gives none."""
    rng = np.random.default_rng(r + 7)
    e_np = _ids(r, 4, case, rng)
    g = moe_groups(torch.from_numpy(e_np), 4)
    order = g.order.numpy()
    for lst, count, rows in ((g.tiles, g.counts[0], TILE_ROWS),
                             (g.dtiles, g.counts[1], DECODE_TILE_ROWS)):
        want = []
        for x in range(4):
            pos = [i for i in range(r) if e_np[order[i]] == x]
            want += [(x, pos[f], min(rows, len(pos) - f)) for f in range(0, len(pos), rows)]
        t = lst.numpy()
        assert t.shape == (max_tiles(r, 4, rows), 3) and int(count) == len(want)
        assert len(want) <= -(-r // rows) + 4
        assert [tuple(row) for row in t[:len(want)]] == want
        assert (t[len(want):] == -1).all()
        seen = np.zeros(r, np.int64)
        for x, first, n in want:
            assert 0 < n <= rows and (e_np[order[first:first + n]] == x).all()
            seen[first:first + n] += 1
        assert (seen == 1).all()
        assert {x for x, _, _ in want} == set(e_np.tolist())


@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("r", [9, 64, 300])
@pytest.mark.parametrize("proj", ["w1", "w2"])
def test_moe_q4_tiled_plain_matches_jax_ragged_dot(proj, r, case):
    """The prefill route's rounding model against the JAX package's
    `_moe_ragged` grouped matmul on the CPU: the same q4 expert stack
    `dequantize(jnp.bfloat16)`, x in bf16 repeated by the top-k and sorted
    by expert, and `jax.lax.ragged_dot(..., preferred_element_type=f32)`
    over the group sizes, unsorted. w1-shaped: one x row a token, top-2
    (ceil(R / 2) tokens); w2-shaped: one x row a selection. Within 1e-5 of
    max|ref|: only the order of the f32 sums differs."""
    import jax
    from jlama_tpu.nn.qarray import QArray as JQArray

    rng = np.random.default_rng(r + (0 if proj == "w1" else 1000))
    n_exp, (n, k) = 4, ((40, 96) if proj == "w1" else (64, 128))
    w = _expert_weights(n_exp, n, k, rng)
    if proj == "w1":
        t = -(-r // 2)
        e_np = _ids(2 * t, n_exp, case, rng).reshape(t, 2)
    else:
        t = r
        e_np = _ids(r, n_exp, case, rng)
    x_np = rng.standard_normal((t, k)).astype(np.float32)
    got = moe_q4_matmul_tiled_plain(torch.from_numpy(x_np), w, torch.from_numpy(e_np),
                                    torch.float32).reshape(-1, n).numpy()
    flat = e_np.reshape(-1)
    per = flat.size // t
    order = np.argsort(flat, kind="stable")
    xs = jnp.repeat(jnp.asarray(x_np, jnp.bfloat16), per, axis=0)[order]
    wj = JQArray(jnp.asarray(w.data.numpy()), jnp.asarray(w.scales.numpy()), "q4")
    w_t = jnp.swapaxes(wj.dequantize(jnp.bfloat16), -1, -2)
    gs = jnp.asarray(np.bincount(flat, minlength=n_exp), jnp.int32)
    ys = jax.lax.ragged_dot(xs, w_t, gs, preferred_element_type=jnp.float32)
    ref = np.asarray(ys)[np.argsort(order)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("per", [1, 2])
def test_moe_gather_matches_jax_repeat_then_order(per, case):
    """The prefill route's gathered copy of x on the CPU against the JAX
    package's `jnp.repeat(xf, k, axis=0)[order]` (`_moe_ragged`): per 2 is
    gate and up's input (one x row a token, top-2), per 1 down's (one row a
    selection). Bit for bit, with no launch counted."""
    rng = np.random.default_rng(per * 10 + len(case))
    t = 37
    e_np = _ids(t * per, 4, case, rng)
    x_np = rng.standard_normal((t, 96)).astype(np.float32)
    x = torch.from_numpy(x_np).to(torch.bfloat16)
    before = moe_gather.launches
    got = moe_gather(x, moe_groups(torch.from_numpy(e_np), 4), per)
    assert moe_gather.launches == before
    order = np.argsort(e_np, kind="stable")
    ref = jnp.repeat(jnp.asarray(x_np, jnp.bfloat16), per, axis=0)[order]
    assert got.dtype == torch.bfloat16 and got.shape == (t * per, 96)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_moe_q4_gate_up_on_cpu_is_two_plain_calls(out_dtype):
    """Gate and up in one call: on the CPU two `moe_q4_matmul_plain` calls,
    bit for bit, with no launch counted."""
    rng = np.random.default_rng(5)
    w1, w3 = _expert_weights(4, 40, 96, rng), _expert_weights(4, 40, 96, rng)
    e = torch.from_numpy(rng.integers(0, 4, (7, 2)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((7, 96)).astype(np.float32)).to(out_dtype)
    before = moe_q4_matmul.launches
    gate, up = moe_q4_gate_up(x, w1, w3, e)
    assert moe_q4_matmul.launches == before
    assert torch.equal(gate, moe_q4_matmul_plain(x, w1, e, out_dtype))
    assert torch.equal(up, moe_q4_matmul_plain(x, w3, e, out_dtype))
    assert gate.shape == (7, 2, 40) and gate.dtype == out_dtype


def test_row_tile_holds_every_decode_expert_in_one_tile():
    assert [row_tile(r) for r in (1, 2, 8, 9, 16, 17, 32, 33, 1024)] == \
        [8, 8, 8, 16, 16, 32, 32, 32, 32]


def test_moe_q4_rejects_bad_shapes():
    w = _expert_weights(4, 24, 64, np.random.default_rng(0))
    with pytest.raises(ValueError, match="q4 QArray"):
        moe_q4_matmul(torch.ones(2, 64), w[0], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="ids"):
        moe_q4_matmul(torch.ones(2, 64), w, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        moe_q4_matmul(torch.ones(2, 64, device="meta"), w.to("meta"),
                      torch.zeros(2, dtype=torch.int32, device="meta"))


def test_qarray_expert_axis():
    """A q4 QArray [E, N, K]: dequantize, unpack and indexing work over the
    expert axis, expert by expert equal to the 2-D QArrays."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 8, 64)).astype(np.float32)
    w = quantize_q4(a)
    assert w.shape == (3, 8, 64) and w.ndim == 3
    for i in range(3):
        wi = quantize_q4(a[i])
        assert torch.equal(w[i].data, wi.data) and torch.equal(w[i].scales, wi.scales)
        assert torch.equal(w.dequantize()[i], wi.dequantize())
        assert torch.equal(w.unpack()[i], wi.unpack())
    sub = w[torch.tensor([2, 0])]
    assert sub.shape == (2, 8, 64) and torch.equal(sub.dequantize()[0], w[2].dequantize())


# ---------------------------------------------------------------------------
# The model against jlama_tpu and transformers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from transformers import MixtralConfig, MixtralForCausalLM

    from jlama_tpu.models.loader import load_params
    from jlama_tpu.nn.qarray import quantize_q4 as jquantize

    torch.manual_seed(7)
    hf = MixtralForCausalLM(MixtralConfig(
        **{k: v for k, v in TINY_MIXTRAL.items() if k != "model_type"})).eval()
    model_dir = tmp_path_factory.mktemp("tiny_mixtral")
    save_torch_model(hf, model_dir, TINY_MIXTRAL)
    jp, jcfg = load_params(model_dir, float_dtype=jnp.float32)
    layers = dict(jp["layers"])
    for k in ("experts.w1", "experts.w2", "experts.w3"):
        layers[k] = jquantize(np.asarray(layers[k], np.float32))
    jq = dict(jp, layers=layers)
    from jlama_tpu_torch.config import load_config

    return dict(dir=model_dir, hf=hf, jp=jp, jq=jq, jcfg=jcfg, cfg=load_config(model_dir))


def test_bridge_carries_expert_stacks_and_router(tiny):
    tp = port_tree(tiny["jq"])
    layer = tp["layers"][0]
    w1 = layer["experts.w1"]
    assert isinstance(w1, QArray) and w1.shape == (4, 128, 64) and w1.data.shape == (4, 128, 32)
    assert layer["experts.w2"].shape == (4, 64, 128)
    assert layer["router"].shape == (4, 64) and layer["router"].dtype == torch.float32
    assert_trees_equal(tiny["jq"], tp)


@pytest.mark.parametrize("t", [1, 8])
def test_moe_block_matches_jax(tiny, t):
    """T = 1 is the JAX package's gathered side (B·T·K = 2), T = 8 its ragged
    side (16)."""
    from jlama_tpu.nn import layers as JL
    from jlama_tpu_torch.nn import layers as L

    jq, cfg = tiny["jq"], tiny["cfg"]
    jlayer = {k: (v[0] if not hasattr(v, "data") else type(v)(v.data[0], v.scales[0], v.fmt))
              for k, v in jq["layers"].items()}
    tlayer = port_tree(jq)["layers"][0]
    x = np.random.default_rng(t).standard_normal((1, t, 64)).astype(np.float32)
    ref = np.asarray(JL.moe_block(jnp.asarray(x), jlayer, tiny["jcfg"]))
    got = L.moe_block(torch.from_numpy(x), tlayer, cfg).numpy()
    tol = GATHERED_TOL if t == 1 else RAGGED_TOL
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [1, 8])
def test_forward_logits_match_jax(tiny, t):
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu_torch.models.base import forward_logits

    toks = TOKENS[:, :t]
    pos = np.arange(t)[None, :]
    ref, _ = jforward(tiny["jq"], tiny["jcfg"], jnp.asarray(toks, jnp.int32),
                      jnp.asarray(pos, jnp.int32), dtype=jnp.float32)
    got, _ = forward_logits(port_tree(tiny["jq"]), tiny["cfg"], torch.from_numpy(toks),
                            torch.from_numpy(pos), dtype=torch.float32)
    tol = GATHERED_TOL if t == 1 else RAGGED_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_loader_matches_transformers_and_jax(tiny):
    from jlama_tpu_torch.models.base import forward_logits
    from jlama_tpu_torch.models.loader import load_params

    params, cfg = load_params(tiny["dir"], device="cpu", float_dtype=torch.float32)
    assert cfg.n_experts == 4 and cfg.n_experts_per_token == 2
    assert params["layers"][0]["experts.w1"].shape == (4, 128, 64)
    assert_trees_equal(tiny["jp"], params)
    pos = torch.arange(TOKENS.shape[1])[None, :]
    got, _ = forward_logits(params, cfg, torch.from_numpy(TOKENS), pos, dtype=torch.float32)
    with torch.no_grad():
        ref = tiny["hf"](torch.from_numpy(TOKENS)).logits.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-3, atol=3e-3)


def test_prepare_moe_ragged_transposes_float_experts_only(tiny):
    from jlama_tpu_torch.models.base import forward_logits, prepare_moe_ragged

    fp = port_tree(tiny["jp"])
    rp = prepare_moe_ragged(fp)
    assert "experts.w1_t" in rp["layers"][0] and "experts.w1" not in rp["layers"][0]
    assert rp["layers"][0]["experts.w1_t"].shape == (4, 64, 128)
    qp = port_tree(tiny["jq"])
    assert prepare_moe_ragged(qp)["layers"][0]["experts.w1"] is qp["layers"][0]["experts.w1"]
    pos = torch.arange(8)[None, :]
    a, _ = forward_logits(fp, tiny["cfg"], torch.from_numpy(TOKENS), pos, dtype=torch.float32)
    b, _ = forward_logits(rp, tiny["cfg"], torch.from_numpy(TOKENS), pos, dtype=torch.float32)
    assert torch.equal(a, b)


PROMPTS = [[1, 5, 9, 42, 7], [1, 3, 7, 12, 30, 44, 100, 9, 17, 2, 5, 88, 41, 6, 3, 77, 200, 12]]
CONCURRENT = [[1, 5, 9], [1, 7, 30, 12], [1, 2], [1, 44, 17, 80, 3], [1, 9, 9, 4], [1, 60],
              [1, 22, 33, 44, 55, 66], [1, 100, 3]]


def test_engine_greedy_ids_match_jax(tiny):
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu_torch.runtime.engine import Engine

    jeng = JEngine(tiny["jq"], tiny["jcfg"], max_seq_len=128, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32)
    teng = Engine(port_tree(tiny["jq"]), tiny["cfg"], device="cpu", max_seq_len=128,
                  kv_dtype=torch.float32, compute_dtype=torch.float32)
    for prompt in PROMPTS:
        ref = jeng.generate_tokens(prompt, max_new_tokens=10, stop_ids=set())
        got = teng.generate_tokens(prompt, max_new_tokens=10, stop_ids=set())
        assert got.token_ids == ref.token_ids and len(got.token_ids) == 10


@pytest.mark.parametrize("n_slots", [4, 8])
def test_scheduler_greedy_ids_match_jax(tiny, n_slots):
    """Eight requests at once: 4 slots keep the JAX decode step on its
    gathered side (B·T·K = 8), 8 slots put it on the ragged side (16)."""
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

    kw = dict(n_slots=n_slots, n_pages=64, page_size=8, max_seq_len=64)
    js = JSched(tiny["jq"], tiny["jcfg"], kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    ts = BatchScheduler(port_tree(tiny["jq"]), tiny["cfg"], kv_dtype=torch.float32,
                        compute_dtype=torch.float32, device="cpu", **kw)
    jreqs = [JReq(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
    treqs = [GenRequest(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
    for r in jreqs:
        js.submit(r)
    for r in treqs:
        ts.submit(r)
    for _ in range(400):
        if all(r.state.value == "DONE" for r in jreqs):
            break
        js.step()
    for _ in range(400):
        if all(r.state == RequestState.DONE for r in treqs):
            break
        ts.step()
    assert [r.out_ids for r in treqs] == [r.out_ids for r in jreqs]
    assert all(len(r.out_ids) == 6 for r in treqs)


def test_moe_raises_where_it_is_not_ported(tiny):
    from jlama_tpu_torch.models.base import check_moe_device, prepare_moe_ragged
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    fp = port_tree(tiny["jp"])
    for params in (fp, prepare_moe_ragged(fp)):
        with pytest.raises(NotImplementedError, match="float experts on the card"):
            check_moe_device(params, "cuda")
    check_moe_device(port_tree(tiny["jq"]), "cuda")  # q4 experts: K6 takes them
    with pytest.raises(NotImplementedError, match="q4s MoE"):
        BatchScheduler(port_tree(tiny["jq"]), tiny["cfg"], n_slots=2, n_pages=8, page_size=8,
                       max_seq_len=32, device="cpu", weight_format="q4s")


def test_cpu_moe_goes_through_plain_versions(tiny, monkeypatch):
    """A device="cpu" MoE generation reaches K6's plain version three times a
    layer a forward (gate and up through `moe_q4_gate_up`, down through
    `moe_q4_matmul`) and counts no launch."""
    from jlama_tpu_torch.ops import moe_q4
    from jlama_tpu_torch.runtime.engine import Engine

    calls = []
    inner = moe_q4.moe_q4_matmul_plain
    monkeypatch.setattr(moe_q4, "moe_q4_matmul_plain",
                        lambda *a, **kw: calls.append(1) or inner(*a, **kw))
    before = (moe_q4.moe_q4_matmul.launches, moe_q4.moe_groups.launches)
    eng = Engine(port_tree(tiny["jq"]), tiny["cfg"], device="cpu", max_seq_len=64,
                 kv_dtype=torch.float32, compute_dtype=torch.float32)
    eng.generate_tokens([1, 5, 9, 42], max_new_tokens=3, stop_ids=set())
    assert len(calls) == 3 * tiny["cfg"].n_layers * (1 + 3)  # prefill + 3 decode steps
    assert (moe_q4.moe_q4_matmul.launches, moe_q4.moe_groups.launches) == before
