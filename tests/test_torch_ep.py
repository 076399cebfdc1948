"""Expert parallelism (MoE under tp): each rank holds E/tp experts of every
layer, routes over the model's experts with the replicated router, computes
only the selections of its range and sums the f32 partials over the ranks.

- K6's grouping and plain version over a local range (`ops/moe_q4.py`): no
  foreign selection in any tile, the order a permutation with the foreign
  selections last, foreign rows exactly 0;
- `moe_block` on thread ranks (`ThreadGroup`, tests/test_torch_tp_forward.py):
  the sum of the partials equals the unsharded block within MOE_MODEL_TOL,
  and the tp = 2 logits equal jlama_tpu's single-device and shard_map EP
  forwards within 1e-4 (float experts);
- two gloo rank processes (tests/torch_tp_ranks.py::mesh_rank_main) serving
  a tiny Mixtral, mirroring tests/test_shard_map_tp.py's EP tests: greedy
  ids equal to jlama_tpu's single-device scheduler's and its tp = 2
  shard_map scheduler's, float experts through the grouped route and q4
  experts through K6's plain version, each rank holding E/2 experts.
"""

import pickle
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jlama_tpu_torch.nn.qarray import quantize_q4
from jlama_tpu_torch.ops.moe_q4 import (DECODE_TILE_ROWS, TILE_ROWS, moe_gather,
                                        moe_groups_plain, moe_q4_gate_up, moe_q4_matmul,
                                        moe_q4_matmul_plain, moe_q4_matmul_tiled_plain)
from tests import torch_tp_ranks as R
from tests.helpers import save_torch_model
from tests.test_torch_moe import TINY_MIXTRAL
from tests.test_torch_tp_forward import TOKENS, jax_single_logits, jax_tp_logits, run_ranks
from tests.torch_tp_ranks import start_ranks, wait_ranks

MOE_MODEL_TOL = 1e-4  # f32 sums in another order (chip_smoke.py's K6 model tolerance)
TOL = 1e-4  # f32 logits, as tests/test_torch_tp_forward.py holds the tp forward
E, N_LOCAL = 8, 4


def _foreign(e, lo, n_local):
    el = e.reshape(-1).long() - lo
    return (el < 0) | (el >= n_local)


@pytest.mark.parametrize("lo", [0, 4])
@pytest.mark.parametrize("r", [2, 9, 40, 300])
def test_local_grouping_puts_no_foreign_selection_in_a_tile(r, lo):
    """Over the local range [lo, lo + 4) of 8 experts: every tile of both
    routes lists local rows only (and all of them), the order is a
    permutation whose tail past offsets[4] is the foreign selections in
    selection order, and the gather's rows are the local ones."""
    rng = np.random.default_rng(r + lo)
    e = torch.from_numpy(rng.integers(0, E, r).astype(np.int32))
    g = moe_groups_plain(e, N_LOCAL, lo)
    order = g.order.long()
    assert sorted(order.tolist()) == list(range(r))
    n_loc = int(g.offsets[-1])
    foreign = _foreign(e, lo, N_LOCAL)
    assert n_loc == int((~foreign).sum())
    assert order[n_loc:].tolist() == foreign.nonzero()[:, 0].tolist()
    for tiles, rows, n in ((g.tiles, TILE_ROWS, int(g.counts[0])),
                           (g.dtiles, DECODE_TILE_ROWS, int(g.counts[1]))):
        covered = []
        for ex, first, cnt in tiles[:n].tolist():
            assert 0 <= ex < N_LOCAL and 0 < cnt <= rows
            sel = order[first:first + cnt]
            assert first + cnt <= n_loc and bool((e[sel] - lo == ex).all())
            covered += sel.tolist()
        assert sorted(covered) == sorted((~foreign).nonzero()[:, 0].tolist())
        assert bool((tiles[n:] == -1).all())
    x = torch.randn(r, 32)
    np.testing.assert_array_equal(moe_gather(x, g, 1)[:n_loc].numpy(),
                                  x[order[:n_loc]].numpy())


@pytest.mark.parametrize("lo", [0, 4])
@pytest.mark.parametrize("r", [2, 32, 1024])
def test_plain_versions_give_zero_foreign_rows(r, lo):
    """moe_q4_matmul_plain (and the tiled model, and the CPU's gate-up pair)
    over a stack of experts [lo, lo + 4): foreign rows exactly 0, local rows
    equal to the whole 8-expert stack's."""
    rng = np.random.default_rng(r)
    full = quantize_q4(rng.standard_normal((E, 48, 64)).astype(np.float32) * 0.1)
    local = type(full)(full.data[lo:lo + N_LOCAL], full.scales[lo:lo + N_LOCAL], full.fmt)
    e = torch.from_numpy(rng.integers(0, E, (r // 2, 2)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((r // 2, 64)).astype(np.float32))
    foreign = _foreign(e, lo, N_LOCAL).reshape(r // 2, 2)
    for fn in (moe_q4_matmul_plain, moe_q4_matmul_tiled_plain, moe_q4_matmul):
        y = fn(x, local, e, torch.float32, lo=lo)
        ref = fn(x, full, e, torch.float32)
        assert bool((y[foreign] == 0).all())
        np.testing.assert_array_equal(y[~foreign].numpy(), ref[~foreign].numpy())
    gate, up = moe_q4_gate_up(x, local, local, e, torch.float32, lo=lo)
    assert bool((gate[foreign] == 0).all()) and torch.equal(gate, up)


@pytest.fixture(scope="module")
def mixtral(tmp_path_factory):
    """A tiny Mixtral checkpoint through transformers (4 experts, top-2),
    and both packages' trees of it."""
    from transformers import MixtralConfig, MixtralForCausalLM

    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params

    torch.manual_seed(11)
    hf = MixtralForCausalLM(MixtralConfig(
        **{k: v for k, v in TINY_MIXTRAL.items() if k != "model_type"})).eval()
    model_dir = tmp_path_factory.mktemp("ep_mixtral")
    save_torch_model(hf, model_dir, TINY_MIXTRAL)
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    tp, tcfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return dict(dir=model_dir, jp=jp, jcfg=jcfg, tp=tp, tcfg=tcfg)


def _q4_experts(tree):
    return dict(tree, layers=[{k: quantize_q4(v.numpy()) if k.startswith("experts.") else v
                               for k, v in d.items()} for d in tree["layers"]])


def _ep_ranks(tree, cfg, fn):
    """fn(local tree, group) under a tp context on two thread ranks."""
    from jlama_tpu_torch.parallel import mesh as tmesh
    from jlama_tpu_torch.parallel import tp_forward as ttpf

    def rank_fn(group):
        local = tmesh.shard_params(tree, cfg, 2, group.rank)
        with ttpf.tp_context(ttpf.TPCtx(group)):
            return fn(local, group)

    return run_ranks(2, rank_fn)


@pytest.mark.parametrize("experts", ["float", "q4", "float_t"])
@pytest.mark.parametrize("t", [1, 8])
def test_ep_partials_sum_to_the_unsharded_block(mixtral, experts, t):
    """moe_block on each rank's E/2 experts under a tp context: every rank's
    output (its f32 partial summed over the ranks, then cast) equals the
    unsharded moe_block within MOE_MODEL_TOL, and both ranks agree exactly."""
    from jlama_tpu_torch.models.base import prepare_moe_ragged
    from jlama_tpu_torch.nn import layers as L

    tree = mixtral["tp"]
    tree = _q4_experts(tree) if experts == "q4" else tree
    tree = prepare_moe_ragged(tree) if experts == "float_t" else tree
    cfg = mixtral["tcfg"]
    x = torch.from_numpy(np.random.default_rng(t).standard_normal((1, t, 64)).astype(np.float32))
    ref = L.moe_block(x, tree["layers"][0], cfg)
    outs = _ep_ranks(tree, cfg, lambda local, g: L.moe_block(x, local["layers"][0], cfg))
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), atol=MOE_MODEL_TOL, rtol=0)


def test_rank_slice_holds_its_experts_and_the_whole_router(mixtral):
    """shard_params cuts the expert stacks on axis 0 (a q4 stack's data and
    scales together), keeps the router whole, and prepare_moe_ragged
    transposes a rank's E/2 stacks as it does the whole ones; E % tp != 0
    raises, naming it."""
    from jlama_tpu_torch.models.base import prepare_moe_ragged
    from jlama_tpu_torch.parallel import mesh as tmesh

    cfg = mixtral["tcfg"]
    for tree in (mixtral["tp"], _q4_experts(mixtral["tp"])):
        for rank in range(2):
            lay = tmesh.shard_params(tree, cfg, 2, rank)["layers"][0]
            full = tree["layers"][0]
            assert lay["router"] is full["router"]
            for k in ("experts.w1", "experts.w2", "experts.w3"):
                got, want = lay[k], full[k][2 * rank:2 * rank + 2]
                if hasattr(got, "fmt"):
                    assert torch.equal(got.data, want.data)
                    assert torch.equal(got.scales, want.scales)
                else:
                    assert torch.equal(got, want)
    local = tmesh.shard_params(mixtral["tp"], cfg, 2, 1)
    ragged = prepare_moe_ragged(local)["layers"][0]
    whole = prepare_moe_ragged(mixtral["tp"])["layers"][0]
    for k in ("experts.w1_t", "experts.w2_t", "experts.w3_t"):
        assert ragged[k].shape[0] == 2 and torch.equal(ragged[k], whole[k][2:4])
    three = dict(mixtral["tp"], layers=[{k: (v[:3] if k.startswith("experts.") else v)
                                         for k, v in d.items()}
                                        for d in mixtral["tp"]["layers"]])
    with pytest.raises(ValueError, match="3 experts do not divide over tp=2"):
        tmesh.shard_params(three, replace(cfg, n_experts=3), 2, 0)


def test_ep_logits_match_jax(mixtral):
    """The tp = 2 forward of the tiny Mixtral (float experts, EP) on thread
    ranks against jlama_tpu's single-device forward and its tp = 2
    shard_map EP forward, within 1e-4; both ranks' logits equal."""
    from jlama_tpu_torch.models import base as tbase
    from jlama_tpu_torch.parallel import mesh as tmesh
    from jlama_tpu_torch.parallel import tp_forward as ttpf

    cfg = mixtral["tcfg"]
    fused = tbase.fuse_params(mixtral["tp"], tp=2)
    embed_sh, lm_sh = tmesh.vocab_flags(fused, 2)
    lcfg = ttpf.localize_cfg(cfg, 2)
    toks = torch.from_numpy(TOKENS).long()
    pos = torch.arange(TOKENS.shape[1]).expand(TOKENS.shape)

    def rank_fn(group):
        local = tmesh.shard_params(fused, cfg, 2, group.rank)
        assert local["layers"][0]["experts.w1"].shape[0] == cfg.n_experts // 2
        with ttpf.tp_context(ttpf.TPCtx(group, embed_sh, lm_sh)):
            return tbase.forward_logits(local, lcfg, toks, pos, dtype=torch.float32)[0]

    ranks = [x.numpy() for x in run_ranks(2, rank_fn)]
    np.testing.assert_array_equal(ranks[0], ranks[1])
    jp, jcfg = mixtral["jp"], mixtral["jcfg"]
    np.testing.assert_allclose(ranks[0], jax_single_logits(jp, jcfg), atol=TOL, rtol=0)
    np.testing.assert_allclose(ranks[0], jax_tp_logits(jp, jcfg), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# two rank processes serving the tiny Mixtral
# ---------------------------------------------------------------------------

KINDS = ("ep_float", "ep_q4")


@pytest.fixture(scope="module")
def served(mixtral, tmp_path_factory):
    out = tmp_path_factory.mktemp("ep_serving")
    procs, end = start_ranks(R.mesh_rank_main, lambda r: (
        r, 1, 2, str(out / "store"), str(mixtral["dir"]), str(out), KINDS))
    try:
        ref = jax_ids(mixtral["jp"], mixtral["jcfg"])
    finally:
        wait_ranks(procs, end)
    ranks = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks


def jax_ids(jp, jcfg):
    """jlama_tpu's single-device and tp = 2 shard_map (EP) schedulers on the
    same weights: float experts (ragged) and q4 experts (moe_ragged=False,
    the gathered path at decode)."""
    from jlama_tpu.nn.qarray import quantize_q4 as jquantize
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.runtime.scheduler import BatchScheduler

    layers = dict(jp["layers"])
    for k in R.MOE_Q4_KEYS:
        layers[k] = jquantize(np.asarray(layers[k], dtype=np.float32))
    weights = {"ep_float": (jp, {}, R.EP_FLOAT_PROMPT, 6),
               "ep_q4": (dict(jp, layers=layers), {"moe_ragged": False}, R.EP_Q4_PROMPT, 5)}
    mesh = make_mesh(jax.devices()[:2], dp=1, pp=1, tp=2)
    out = {}
    for kind, (params, kw, prompt, n) in weights.items():
        for label, m in (("single", None), ("tp", mesh)):
            s = BatchScheduler(shard_params(params, jcfg, m) if m else params, jcfg, n_slots=2,
                               kv_dtype=jnp.float32, compute_dtype=jnp.float32, mesh=m,
                               **R.MESH_SCHED, **kw)
            if m is not None:
                assert s._sm is not None  # EP under shard_map, not GSPMD
            out[kind, label] = s.generate(prompt, max_new_tokens=n, temperature=0.0).token_ids
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_ep_greedy_ids_match_jax(served, kind):
    """test_moe_expert_parallel_shard_map (float experts, the grouped route)
    and test_moe_ep_quantized_gathered (q4 experts, K6's plain version):
    the leader's greedy ids equal jlama_tpu's single-device scheduler's and
    its EP scheduler's; each rank held 2 of the 4 experts and the whole
    router, and the follower sampled the leader's ids step for step."""
    ref, ranks = served
    got = ranks[0][kind]["ids"]
    assert got == ref[kind, "single"]
    assert got == ref[kind, "tp"]
    key = "experts.w1_t" if kind == "ep_float" else "experts.w1"
    for res in ranks:
        assert res[kind + "/shapes"][key][0] == 2
        assert res[kind + "/shapes"]["router"] == (4, 64)
        a, b = res[kind + "/log"], ranks[0][kind + "/log"]
        assert len(a) == len(b) > 0 and all(np.array_equal(x, y) for x, y in zip(a, b))
