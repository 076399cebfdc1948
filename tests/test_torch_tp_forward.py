"""The port's tensor-parallel forward in one process (parallel/mesh.py,
parallel/tp_forward.py and the tp hooks of nn/layers.py and
models/base.py), held against jlama_tpu in f32.

The ranks are threads here: `tests/torch_thread_ranks.py::ThreadGroup`
stands in for a `TPGroup`, each collective a barrier, then a sum or a
concatenation in rank order. The multi-process path over torch.distributed
is tests/test_torch_tp_serving.py.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from jlama_tpu.config import from_hf_config as jax_config
from jlama_tpu.models import base as jbase
from jlama_tpu.models.init import init_params as jax_init
from jlama_tpu.parallel import mesh as jmesh
from jlama_tpu.parallel import tp_forward as jtpf
from jlama_tpu_torch.config import from_hf_config
from jlama_tpu_torch.models import base as tbase
from jlama_tpu_torch.nn import layers as tlayers
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.parallel import mesh as tmesh
from jlama_tpu_torch.parallel import tp_forward as ttpf
from tests.helpers import TINY_LLAMA_CONFIG
from tests.test_torch_bridge import port_tree
from tests.torch_thread_ranks import run_ranks

TP = 2
TOL = 1e-4  # f32, as tests/test_multiprocess.py holds the JAX tp forward
TOKENS = np.array([[1, 5, 9, 42, 7, 13, 2, 30], [3, 8, 21, 200, 99, 4, 17, 250]], np.int32)

CONFIGS = {
    "llama": dict(TINY_LLAMA_CONFIG),
    "qwen2": dict(model_type="qwen2", hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  rms_norm_eps=1e-6, vocab_size=256, max_position_embeddings=128,
                  rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False),
    "gemma2": dict(model_type="gemma2", hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                   rms_norm_eps=1e-6, vocab_size=256, max_position_embeddings=128,
                   rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh", head_dim=16,
                   tie_word_embeddings=True, query_pre_attn_scalar=16,
                   final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
                   sliding_window=4),
    "mixtral": dict(model_type="mixtral", hidden_size=64, intermediate_size=128,
                    num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                    rms_norm_eps=1e-5, vocab_size=256, max_position_embeddings=128,
                    rope_theta=10000.0, hidden_act="silu", num_local_experts=4,
                    num_experts_per_tok=2),
}


def _perturb(tree, rng):
    """Norm weights and biases off init's ones and zeros, so that a
    misplaced norm or bias shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif "norm" in k or k.endswith(".bias"):
            a = np.asarray(v)
            out[k] = jnp.asarray(a + rng.uniform(-0.3, 0.3, a.shape).astype(a.dtype))
        else:
            out[k] = v
    return out


def make_model(arch, quantize=None):
    """(jax params, jax cfg, port params, port cfg), the same weights."""
    hf = CONFIGS[arch]
    jcfg, tcfg = jax_config(hf), from_hf_config(hf)
    jparams = _perturb(jax_init(jcfg, seed=3, dtype=jnp.float32, quantize=quantize),
                       np.random.default_rng(7))
    return jparams, jcfg, port_tree(jparams), tcfg


def jax_single_logits(jparams, jcfg):
    pos = np.broadcast_to(np.arange(TOKENS.shape[1], dtype=np.int32), TOKENS.shape)
    logits, _ = jbase.forward_logits(jparams, jcfg, jnp.asarray(TOKENS), jnp.asarray(pos),
                                     dtype=jnp.float32)
    return np.asarray(logits)


def jax_tp_logits(jparams, jcfg, tp=TP):
    """jlama_tpu's shard_map tp forward on tp of the virtual CPU devices."""
    mesh = jmesh.make_mesh(jax.devices()[:tp], dp=1, pp=1, tp=tp)
    fused = jbase.fuse_params(jparams, tp=tp)
    pspecs = jmesh.param_pspecs(fused, jcfg, mesh)
    ok, embed_sh, lm_sh = jtpf.specs_ok(pspecs, tp)
    assert ok
    ctx = jtpf.SpmdCtx("tp", None, embed_sh, lm_sh)
    lcfg = jtpf.localize_cfg(jcfg, tp)

    def body(params, toks, pos):
        with jtpf.spmd_context(ctx):
            return jbase.forward_logits(params, lcfg, toks, pos, dtype=jnp.float32)[0]

    f = jax.shard_map(body, mesh=mesh, in_specs=(pspecs, P(), P()), out_specs=P(),
                      check_vma=False)
    pos = np.broadcast_to(np.arange(TOKENS.shape[1], dtype=np.int32), TOKENS.shape)
    return np.asarray(jax.jit(f)(jmesh.shard_params(fused, jcfg, mesh), jnp.asarray(TOKENS),
                                 jnp.asarray(pos)))


def port_tp_logits(tparams, tcfg, tp=TP, record=None):
    """The port's forward on tp thread ranks: each rank's slice of the
    interleaved fused tree, under a tp context; logits of every rank."""
    fused = tbase.fuse_params(tparams, tp=tp)
    embed_sh, lm_sh = tmesh.vocab_flags(fused, tp)
    lcfg = ttpf.localize_cfg(tcfg, tp)
    toks = torch.from_numpy(TOKENS).long()
    pos = torch.arange(TOKENS.shape[1]).expand(TOKENS.shape)

    def rank_fn(group):
        local = tmesh.shard_params(fused, tcfg, tp, group.rank)
        if record is not None:
            record[group.rank] = local
        with ttpf.tp_context(ttpf.TPCtx(group, embed_sh, lm_sh)):
            return tbase.forward_logits(local, lcfg, toks, pos, dtype=torch.float32)[0]

    return [x.numpy() for x in run_ranks(tp, rank_fn)]


@pytest.mark.parametrize("arch,quantize", [("llama", None), ("llama", "q4"),
                                           ("qwen2", None), ("gemma2", None)])
def test_tp_logits_match_jax(arch, quantize):
    """tp = 2 logits against jlama_tpu's single-device forward and its tp = 2
    shard_map forward, within 1e-4; every rank holds the same logits."""
    jparams, jcfg, tparams, tcfg = make_model(arch, quantize)
    ranks = port_tp_logits(tparams, tcfg)
    np.testing.assert_array_equal(ranks[0], ranks[1])
    np.testing.assert_allclose(ranks[0], jax_single_logits(jparams, jcfg), atol=TOL, rtol=0)
    np.testing.assert_allclose(ranks[0], jax_tp_logits(jparams, jcfg), atol=TOL, rtol=0)


def test_rank_operands_are_one_tp_of_the_weights(monkeypatch):
    """Each rank's layer operands are 1/tp of the weights (as
    tests/test_shard_map_tp.py asserts of the JAX trace), q4 data and block
    scales alike, and the vocabulary-sharded embedding and lm_head too."""
    jparams, jcfg, tparams, tcfg = make_model("llama", "q4")
    seen = [[] for _ in range(TP)]
    real = tlayers.linear

    def spy(x, w, *a, **kw):
        rank = threading.current_thread().name
        seen[int(rank[-1])].append(tuple(w.shape))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(tlayers, "linear", spy)
    local = [None] * TP
    port_tp_logits(tparams, tcfg, record=local)
    qdim = tcfg.n_heads * tcfg.head_size
    kvdim = tcfg.n_kv_heads * tcfg.head_size
    D, H, V = tcfg.embedding_length, tcfg.hidden_length, tcfg.vocab_size
    for rank in range(TP):
        lay = local[rank]["layers"][0]
        assert lay["wqkv"].data.shape == ((qdim + 2 * kvdim) // TP, D // 2)
        assert lay["wqkv"].scales.shape == ((qdim + 2 * kvdim) // TP, D // 32)
        assert lay["wo"].data.shape == (D, qdim // TP // 2)
        assert lay["wo"].scales.shape == (D, qdim // TP // 32)
        assert lay["w13"].data.shape == (2 * H // TP, D // 2)
        assert lay["w2"].data.shape == (D, H // TP // 2)
        assert local[rank]["embed"].shape == (V // TP, D)
        assert local[rank]["lm_head"].shape == (V // TP, D)
    # the layer projections the forward ran: 4 per layer per rank, rank-local
    assert len(seen[0]) == 4 * tcfg.n_layers
    assert set(seen[0]) == {((qdim + 2 * kvdim) // TP, D), (D, qdim // TP), (2 * H // TP, D),
                            (D, H // TP)}


def test_interleaved_tree_on_one_device():
    """A tree fused with tp = 2 runs on one device with cfg.fused_tp = 2
    (`_split_fused` regroups the columns) and gives the tp = 1 tree's
    logits; outside a tp context no collective is reached."""
    from dataclasses import replace

    _, _, tparams, tcfg = make_model("qwen2")
    toks = torch.from_numpy(TOKENS).long()
    pos = torch.arange(TOKENS.shape[1]).expand(TOKENS.shape)
    ref, _ = tbase.forward_logits(tbase.fuse_params(tparams), tcfg, toks, pos,
                                  dtype=torch.float32)
    got, _ = tbase.forward_logits(tbase.fuse_params(tparams, tp=TP), replace(tcfg, fused_tp=TP),
                                  toks, pos, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    assert ttpf.current() is None
    y = torch.ones(3)
    assert ttpf.tp_reduce(y) is y


def test_plan_and_shard_refusals():
    """Where the JAX package's spec would degrade to replicated, the port's
    shard plan raises; an undivided vocabulary stays replicated, as there."""
    _, _, tparams, tcfg = make_model("llama", "q4")
    fused = tbase.fuse_params(tparams, tp=4)
    with pytest.raises(ValueError, match="blocks of 32"):
        tmesh.shard_params(fused, tcfg, 4, 0)  # wo's 64 inputs: 2 blocks over 4 ranks
    with pytest.raises(ValueError, match="rank 2"):
        tmesh.shard_params(fused, tcfg, 2, 2)
    odd = dict(tparams, embed=tparams["embed"][:255], lm_head=tparams["lm_head"][:255])
    local = tmesh.shard_params(tbase.fuse_params(odd, tp=TP), tcfg, TP, 1)
    assert local["embed"] is odd["embed"] and tmesh.vocab_flags(odd, TP) == (False, False)
    assert isinstance(local["layers"][0]["wo"], QArray)


class _Rank0:
    """Rank 0 of a two-rank group, for the checks made before any collective."""

    rank, size, device = 0, 2, torch.device("cpu")


REFUSALS = {
    # pp is served (tests/test_torch_pipeline.py); a pp that does not divide
    # the layers is not, as in the JAX pipeline
    "pp": (dict(mesh=tmesh.Mesh(pp=4)), ValueError, "n_layers must divide by pp"),
    "heads": (dict(mesh=tmesh.Mesh(tp=3, group=_Rank0())), ValueError, "divide the heads"),
    # expert parallelism needs E % tp == 0 (the JAX gate), dp needs n_slots
    # and n_pages % dp == 0
    "experts_tp": (dict(mesh=tmesh.Mesh(tp=2, group=_Rank0()), moe=3), ValueError,
                   "tp=2 does not divide n_experts=3"),
    "dp_slots": (dict(mesh=tmesh.Mesh(dp=2), n_slots=3), ValueError,
                 "dp=2 does not divide n_slots=3"),
    "dp_pages": (dict(mesh=tmesh.Mesh(dp=2), n_pages=7), ValueError,
                 "dp=2 does not divide n_pages=7"),
    "no_group": (dict(mesh=tmesh.Mesh(tp=2)), ValueError, "TPGroup"),
    "channel_without_tp": (dict(step_channel=object()), ValueError, "step_channel"),
    # a rank's slice of K of wo (256 inputs over 2 ranks) splits K5's 256-group
    "q4s_rank_k": (dict(mesh=tmesh.Mesh(tp=2, group=_Rank0()), weight_format="q4s",
                        wide=True), ValueError, r"layers\[0\]\.wo: a rank's K of 128"),
    # a rank's slice without its mesh would run as if whole
    "slice_no_mesh": (dict(rank_slice=True), ValueError, "tp rank 0 of 2's slice"),
}


def _q4s_fmts(params):
    return {k: getattr(v, "fmt", None) for k, v in params["layers"][0].items()}


@pytest.mark.parametrize("case", list(REFUSALS) + ["graphs", "nccl_shared", "nccl_count",
                                                   "nccl_cpu", "engine_mesh",
                                                   "engine_rank_slice", "dp", "moe", "q4s",
                                                   "q4s_dp_tp", "gpt2"])
def test_tp_refusals(case):
    """What tp does not serve raises with a message naming it; nothing runs
    unsharded in its place. dp and MoE under tp, refused before, are served:
    a dp rank holds its group's pages and rows, a MoE rank its E/tp experts
    (tests/test_torch_dp_serving.py and tests/test_torch_ep.py serve them);
    so are q4s (each rank's slice converted, as one device converts the
    whole tree), GPT-2 and BERT, and the Engine on a mesh
    (tests/test_torch_tp_rest.py serves them). decode_graphs=True under tp,
    refused before, builds: a mesh step's collectives cut its graph into
    segments (tests/test_torch_mesh_graphs.py)."""
    from dataclasses import replace

    from jlama_tpu_torch.parallel import distributed
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    if case == "graphs":  # served: graphs on, no reason to run eagerly
        from jlama_tpu_torch.runtime.engine import Engine

        _, _, tparams, tcfg = make_model("llama", "q4")
        mesh = tmesh.Mesh(tp=2, group=_Rank0())
        for owner in (BatchScheduler(tparams, tcfg, n_slots=2, n_pages=8, page_size=8,
                                     max_seq_len=32, device="cpu", mesh=mesh,
                                     decode_graphs=True),
                      Engine(tparams, tcfg, device="cpu", mesh=mesh, decode_graphs=True)):
            st = owner.graphs.stats()
            assert "eager_reason" not in st and st["graphs"] == 0  # the CPU never captures
            assert "eager_reason" not in owner.prefill_graphs.stats()
        yard = BatchScheduler(tparams, tcfg, n_slots=2, n_pages=8, page_size=8, max_seq_len=32,
                              device="cpu", mesh=mesh, decode_graphs=False)
        assert "yardstick" in yard.graphs.stats()["eager_reason"]
        return
    if case == "nccl_shared":
        with pytest.raises(ValueError, match="two ranks share h/cuda:0"):
            distributed.check_nccl_devices(["h/cuda:0", "h/cuda:0"], 2)
        return
    if case == "nccl_count":
        with pytest.raises(ValueError, match="2 ranks on one host but torch sees 1"):
            distributed.check_nccl_devices(["h/cuda:0", "h/cuda:1"], 1)
        distributed.check_nccl_devices(["a/cuda:0", "b/cuda:0"], 1)  # two hosts
        return
    if case == "nccl_cpu":
        with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
            distributed.init_tp_group(2, 0, device="cpu", backend="nccl", store_path="unused")
        return
    if case == "moe":
        _, _, mparams, mcfg = make_model("mixtral", "q4")
        sched = BatchScheduler(mparams, mcfg, n_slots=2, n_pages=8, page_size=8,
                               max_seq_len=32, device="cpu",
                               mesh=tmesh.Mesh(tp=2, group=_Rank0()))
        lay = sched.params["layers"][0]
        assert lay["experts.w1"].data.shape[0] == mcfg.n_experts // 2
        assert lay["router"].shape == (mcfg.n_experts, mcfg.embedding_length)
        return
    _, _, tparams, tcfg = make_model("llama", "q4")
    if case == "dp":
        sched = BatchScheduler(tparams, tcfg, n_slots=2, n_pages=8, page_size=8,
                               max_seq_len=32, device="cpu", mesh=tmesh.Mesh(dp=2, dp_index=1))
        assert sched.kv.state.k_pool.shape[2] == 4 and sched.kv.page_offset == 4
        assert sched._in.tokens.shape[0] == 1 and sched.counts.shape[0] == 1
        return
    if case.startswith("engine"):
        from jlama_tpu_torch.runtime.engine import Engine

        if case == "engine_mesh":  # the Engine on a tp mesh: the rank's heads, graphs on
            eng = Engine(tparams, tcfg, device="cpu", mesh=tmesh.Mesh(tp=2, group=_Rank0()))
            assert eng.params["layers"][0]["wqkv"].data.shape[0] == (
                (tcfg.n_heads + 2 * tcfg.n_kv_heads) * tcfg.head_size // 2)
            assert eng.fwd_cfg.n_kv_heads == tcfg.n_kv_heads // 2
            assert "eager_reason" not in eng.graphs.stats()
            return
        with pytest.raises(ValueError, match="pass the rank's mesh"):
            # a tp rank's slice, as a tp scheduler holds it, without its mesh
            Engine(tmesh.shard_params(tbase.fuse_params(tparams, tp=2), tcfg, 2, 0), tcfg,
                   device="cpu", fuse=False)
        return
    if case in ("q4s", "q4s_dp_tp"):  # served: the rank's formats are one device's
        mesh = tmesh.Mesh(dp=2 if case == "q4s_dp_tp" else 1, tp=2, group=_Rank0())
        kw = dict(n_slots=2, n_pages=8, page_size=8, max_seq_len=32, device="cpu",
                  weight_format="q4s")
        sched = BatchScheduler(tparams, tcfg, mesh=mesh, **kw)
        one = BatchScheduler(tparams, tcfg, **kw)
        assert _q4s_fmts(sched.params) == _q4s_fmts(one.params)
        assert isinstance(sched.params, tmesh.RankSlice) and sched.params.rank == 0
        return
    if case == "gpt2":  # served: GPT-2's rules on the rank (the tiny llama's leaves)
        sched = BatchScheduler(tparams, replace(tcfg, model_type="gpt2"), n_slots=2,
                               n_pages=8, page_size=8, max_seq_len=32, device="cpu",
                               mesh=tmesh.Mesh(tp=2, group=_Rank0()))
        assert sched.fwd_cfg.n_heads == tcfg.n_heads // 2
        return
    kw, exc, msg = REFUSALS[case]
    kw = dict(dict(n_slots=2, n_pages=8), **kw)
    if kw.pop("wide", False):  # every K a multiple of 256: one device converts wo
        from jlama_tpu_torch.models.init import random_q4_params

        tcfg = replace(tcfg, embedding_length=256, hidden_length=512, head_size=64)
        tparams = random_q4_params(tcfg, seed=0, device="cpu")
    if kw.pop("rank_slice", False):
        tparams = tmesh.shard_params(tbase.fuse_params(tparams, tp=2), tcfg, 2, 0)
    if "moe" in kw:
        tcfg = replace(tcfg, model_type="mixtral", n_experts=kw.pop("moe"),
                       n_experts_per_token=2)
    if "model_type" in kw:
        tcfg = replace(tcfg, model_type=kw.pop("model_type"))
    with pytest.raises(exc, match=msg):
        BatchScheduler(tparams, tcfg, page_size=8, max_seq_len=32, device="cpu", **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_tp_distance_on_a_normal_draw_is_jaxs(seed):
    """ROADMAP §3's open item, on the CPU: on a tiny normal(0, 0.02) draw
    (jlama_tpu's `init_params`, its projections q4), the port's tp = 2 f32
    logits lie from its one-device logits no farther than f32 rounding, as
    jlama_tpu's tp = 2 shard_map forward lies from its single device: both
    under 1e-5, the port's within 4 times jlama_tpu's. The tp forward adds
    no distance of its own on such a draw."""
    hf = CONFIGS["llama"]
    jcfg, tcfg = jax_config(hf), from_hf_config(hf)
    jparams = jax_init(jcfg, seed=seed, dtype=jnp.float32, quantize="q4")
    tparams = port_tree(jparams)
    toks = torch.from_numpy(TOKENS).long()
    pos = torch.arange(TOKENS.shape[1]).expand(TOKENS.shape)
    one = tbase.forward_logits(tbase.fuse_params(tparams), tcfg, toks, pos,
                               dtype=torch.float32)[0].numpy()

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    d_port = rel(port_tp_logits(tparams, tcfg)[0], one)
    d_jax = rel(jax_tp_logits(jparams, jcfg), jax_single_logits(jparams, jcfg))
    assert d_port < 1e-5 and d_jax < 1e-5, (d_port, d_jax)
    assert d_port < 4 * d_jax, (d_port, d_jax)


# wide and deep enough for f32 reorderings to flip bf16 roundings: 256 x 64
# rows x 4 layers (at 64 wide and 2 layers hardly one flips)
CAST_LLAMA = dict(TINY_LLAMA_CONFIG, hidden_size=256, intermediate_size=1024,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=4,
                  vocab_size=1024)


@pytest.mark.parametrize("seed", [0, 1])
def test_tp_distance_on_a_normal_draw_comes_from_k1s_bf16_cast(seed):
    """ROADMAP §3's item, its cause on the CPU: the card's K1 route past 16
    rows rounds f32 x to bf16 (`q4_matmul_tiled_plain` models it). On a
    normal(0, 0.02) q4 draw at 64 rows, tp = 2 adds f32 rounding only where
    K1 keeps f32 x (under 1e-5), and the cast turns that reordering into a
    distance at least 100 times larger: bf16 flips of the next layers'
    inputs. tests/test_torch_cuda_tp_distance.py holds the card's kernels
    to it at Llama-3.2-1B's widths."""
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul_plain, q4_matmul_tiled_plain
    from tests.torch_thread_ranks import tp_distance

    cfg = from_hf_config(CAST_LLAMA)
    params = init_params(cfg, seed=seed, dtype=torch.float32, quantize="q4", device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 64))).long()
    d_f32 = tp_distance(params, cfg, toks, matmul=q4_matmul_plain)
    d_cast = tp_distance(params, cfg, toks, matmul=q4_matmul_tiled_plain)
    assert d_f32 < 1e-5, d_f32
    assert d_cast > 100 * d_f32, (d_f32, d_cast)
