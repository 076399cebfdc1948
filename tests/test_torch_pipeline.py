"""The pp ring on the port (`parallel/pipeline.py`) against jlama_tpu's
(`parallel/pipeline.py`), as tests/test_pipeline.py holds the JAX package's:
four gloo rank processes on the CPU (tests/torch_pp_ranks.py::
pipeline_rank_main, started once for the module, joining one world a mesh)
run the GPipe forward and the dense pipelined decode of the 4-layer tiny
llama, while this process runs jlama_tpu's `make_pipelined_forward` and
`make_pipelined_decode` on the virtual CPU devices:

- the GPipe forward, (pp, M) in (2, 2), (2, 4), (4, 2): every rank's hidden
  states within 2e-4 of jlama_tpu's pipelined forward and of its
  `forward_hidden` (tests/test_pipeline.py's limit);
- the dense decode, (pp, tp) in (2, 1), (2, 2), (4, 1): every rank's greedy
  ids equal jlama_tpu's pipelined decode's and one device's;
- each rank's place in the mesh (stage, dp group, tp rank) and its
  point-to-point route (direct on the CPU);
- stage-local loading (no ranks needed): each (stage, tp rank)'s tree read
  from a JQ4 checkpoint, locally and over ranged HTTP, equals the stage's
  layers of the whole fused tree cut to the rank's slice, bit for bit, and
  the rank read less than the payload.
"""

import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_pp_ranks as R
from tests.helpers import make_tiny_llama
from tests.test_torch_shard_load import server  # noqa: F401  (module fixture)
from tests.torch_tp_ranks import start_ranks, wait_ranks

TOL = 2e-4  # tests/test_pipeline.py's


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, and jlama_tpu's, computed here while they run."""
    tmp = tmp_path_factory.mktemp("pp_ring")
    model_dir, _ = make_tiny_llama(tmp / "model", {"num_hidden_layers": 4})
    procs, end = start_ranks(R.pipeline_rank_main,
                             lambda r: (r, str(tmp / "store"), str(model_dir), str(tmp)),
                             world=R.WORLD)
    try:
        ref = jax_refs(model_dir)
    finally:
        wait_ranks(procs, end)
    out = []
    for r in range(R.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return ref, out


def _jax_single_ids(params, cfg, prompts):
    """One device's greedy decode of each prompt (tests/test_pipeline.py's
    reference), its step jitted."""
    from jlama_tpu.models.base import KVCache, forward_logits

    step = jax.jit(lambda p, t, pos, c: forward_logits(p, cfg, t, pos, c, dtype=jnp.float32))
    refs = []
    for p in prompts:
        cache = KVCache.init(cfg, batch=1, max_len=R.DECODE_S, dtype=jnp.float32)
        toks, out = list(p), []
        for i in range(len(p) + R.DECODE_STEPS - 1):
            logits, cache = step(params, jnp.asarray([[toks[i]]], jnp.int32),
                                 jnp.asarray([[i]], jnp.int32), cache)
            if i >= len(p) - 1:
                nxt = int(jnp.argmax(logits[0, -1]))
                out.append(nxt)
                if len(toks) <= i + 1:
                    toks.append(nxt)
        refs.append(out[:R.DECODE_STEPS])
    return refs


def _jax_decode_ids(params, cfg, pp, tp):
    """tests/test_pipeline.py::test_pipelined_decode_matches_single_device's
    run of `make_pipelined_decode`."""
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.parallel.pipeline import make_pipelined_decode

    S, n_steps, M = R.DECODE_S, R.DECODE_STEPS, pp
    prompts = R.decode_prompts(pp)
    mesh = make_mesh(jax.devices()[: pp * tp], dp=1, pp=pp, tp=tp)
    with mesh:
        sp = shard_params(params, cfg, mesh)
        tick, _ = make_pipelined_decode(cfg, mesh)
        k = jnp.zeros((cfg.n_layers, M, cfg.n_kv_heads, S, cfg.head_size), jnp.float32)
        v = jnp.zeros_like(k)
        inflight = jnp.zeros((pp, 1, 1, cfg.embedding_length), jnp.float32)
        feeds = [list(p) for p in prompts]
        outs, fed = [[] for _ in range(M)], [1] * M
        tokens = np.zeros((M, 1), np.int32)
        positions = np.zeros((M, 1), np.int32)
        for mb in range(M):
            tokens[mb, 0] = feeds[mb][0]
        for t in range(M * (max(len(p) for p in prompts) + n_steps + pp)):
            k, v, inflight, logits = tick(sp, k, v, inflight, jnp.asarray(tokens),
                                          jnp.asarray(positions), jnp.asarray(t, jnp.int32))
            mb = (t - pp + 1) % M
            if t >= pp - 1:
                nxt = int(np.argmax(np.asarray(logits)[0]))
                if fed[mb] >= len(feeds[mb]) and len(outs[mb]) < n_steps:
                    outs[mb].append(nxt)
                    feeds[mb].append(nxt)
                if fed[mb] < len(feeds[mb]):
                    tokens[mb, 0] = feeds[mb][fed[mb]]
                    positions[mb, 0] = fed[mb]
                    fed[mb] += 1
            if all(len(o) >= n_steps for o in outs):
                break
    return [o[:n_steps] for o in outs]


def jax_refs(model_dir):
    from jlama_tpu.models.base import forward_hidden
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.parallel.mesh import make_mesh
    from jlama_tpu.parallel.pipeline import make_pipelined_forward

    params, cfg = load_params(model_dir, float_dtype=jnp.float32)
    out = {}
    for pp, m in R.FORWARD_CASES:
        toks, pos = R.forward_inputs(m)
        toks, pos = jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32)
        single, _ = forward_hidden(params, cfg, toks, pos, None, dtype=jnp.float32)
        mesh = make_mesh(jax.devices()[:pp], dp=1, pp=pp, tp=1)
        with mesh:
            pipe = make_pipelined_forward(cfg, mesh, n_microbatches=m)(params, toks, pos,
                                                                       dtype=jnp.float32)
        out["forward", pp, m] = np.asarray(single), np.asarray(pipe)
    single = _jax_single_ids(params, cfg, R.decode_prompts(4))
    for pp, tp in R.DECODE_CASES:
        out["decode", pp, tp] = _jax_decode_ids(params, cfg, pp, tp), single[:pp]
    return out


def _mesh_of(pp, tp=1):
    """The mesh of the four ranks that runs a case."""
    if pp == 4:
        return (1, 4, 1)
    return (1, 2, 2) if tp == 2 else (2, 2, 1)


@pytest.mark.parametrize("pp,n_micro", R.FORWARD_CASES)
def test_pipelined_forward_matches_jax(ranks, pp, n_micro):
    """The GPipe forward's hidden states, on every rank (each dp ring of the
    (2, 2, 1) mesh on its own), against jlama_tpu's pipelined forward and
    its single-device forward."""
    ref, out = ranks
    single, pipe = ref["forward", pp, n_micro]
    dims = _mesh_of(pp)
    for r in range(R.WORLD):
        got = out[r][dims]["forward", n_micro]
        np.testing.assert_allclose(got, pipe, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, single, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pp,tp", R.DECODE_CASES)
def test_pipelined_decode_matches_jax(ranks, pp, tp):
    """The dense pipelined decode's greedy ids, on every rank, against
    jlama_tpu's `make_pipelined_decode` and one device's decode."""
    ref, out = ranks
    pipe, single = ref["decode", pp, tp]
    assert pipe == single
    for r in range(R.WORLD):
        assert out[r][_mesh_of(pp, tp)]["decode"] == pipe


def test_ranks_take_their_places(ranks):
    """Global rank r is tp rank r % tp of stage (r // tp) % pp of dp group
    r // (pp * tp) (the JAX device order); on the CPU every point-to-point
    call goes directly, and each rank's exchanges are counted."""
    _, out = ranks
    for r in range(R.WORLD):
        for dims, res in out[r].items():
            dp, pp, tp = dims
            assert (res["dp_index"], res["stage"], res["tp_rank"]) == (
                r // (pp * tp), (r // tp) % pp, r % tp), (r, dims)
            assert res["route"] == "direct"
            assert res["calls"] > 0


# ---------------------------------------------------------------------------
# stage-local loading
# ---------------------------------------------------------------------------

WIDE = dict(hidden_size=128, intermediate_size=256, num_attention_heads=8,
            num_key_value_heads=4, num_hidden_layers=4)


@pytest.fixture(scope="module")
def jq4(tmp_path_factory):
    from jlama_tpu.quant.quantizer import quantize_model

    tmp = tmp_path_factory.mktemp("pp_load")
    model_dir, _ = make_tiny_llama(tmp / "llama", config_overrides=WIDE)
    return quantize_model(model_dir, tmp / "llama_q4")


def _fake_mesh(dp, pp, tp, stage, tp_rank):
    group = SimpleNamespace(rank=tp_rank, size=tp, device=torch.device("cpu"))
    from jlama_tpu_torch.parallel.mesh import Mesh

    return Mesh(dp, pp, tp, group, 0, None, stage, None)


@pytest.mark.parametrize("where", ["local", "http"])
@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1)])
def test_stage_trees_equal_the_cut_of_the_whole(jq4, server, where, pp, tp):
    """Each (stage, tp rank)'s tree, read shard-locally, is the stage's
    layers of the whole fused tree cut to the rank's slice (its RankSlice
    flags say which), bit for bit; the top-level leaves are read on every
    stage, as the JAX loader places them (replicated over pp); a rank reads
    less than the payload, and a stage's layers alone less than that."""
    from jlama_tpu_torch.models.base import fuse_params
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.parallel import distributed as D
    from jlama_tpu_torch.parallel.mesh import RankSlice, shard_params
    from jlama_tpu_torch.parallel.pipeline import stage_cut
    from tests.test_torch_shard_load import _payload, assert_bit_equal

    model = jq4
    if where == "http":
        root, base = server
        dest = root / f"pp_{pp}_{tp}"
        dest.mkdir(exist_ok=True)
        for f in jq4.iterdir():
            (dest / f.name).write_bytes(f.read_bytes())
        model = f"{base}/{dest.name}"
    whole, cfg = load_params(jq4, device="cpu", float_dtype=torch.float32)
    payload = _payload(jq4)
    reads = []
    for stage in range(pp):
        for t in range(tp):
            got, _ = D.load_params_sharded(model, None, _fake_mesh(1, pp, tp, stage, t),
                                           device="cpu", float_dtype=torch.float32)
            want = shard_params(fuse_params(stage_cut(whole, cfg, pp, stage), tp), cfg, tp, t)
            assert isinstance(got, RankSlice)
            assert (got.pp, got.stage, got.tp, got.rank) == (pp, stage, tp, t if tp > 1 else 0)
            assert len(got["layers"]) == cfg.n_layers // pp
            assert_bit_equal(dict(got), dict(want))
            reads.append(D.LOAD_STATS["bytes_loaded"])
            assert D.LOAD_STATS["payload"] == payload
    assert max(reads) < payload, (reads, payload)


def test_stage_ring_refuses_the_wrong_direction():
    """A stage ring's exchange names what a stage cannot do; a layer count
    that pp does not divide raises the JAX pipeline's message."""
    from jlama_tpu_torch.parallel.pipeline import StageRing, stage_range

    first = StageRing(0, 2, 1, 1, "gloo", torch.device("cpu"))
    last = StageRing(1, 2, 0, 0, "gloo", torch.device("cpu"))
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="only the last stage sends to stage 0"):
        first.exchange(send_first=x)
    with pytest.raises(ValueError, match="only stage 0 receives"):
        last.exchange(recv_last=((2,), torch.int64))
    with pytest.raises(ValueError, match="no next stage"):
        last.exchange(send_next=x)
    assert first.exchange() == (None, None) and first.calls == 0
    assert (first.route, StageRing(0, 2, 1, 1, "gloo", torch.device("cuda", 0)).route,
            StageRing(0, 2, 1, 1, "nccl", torch.device("cuda", 0)).route) == (
        "direct", "host", "direct")
    assert stage_range(32, 2, 1) == (16, 32)
    with pytest.raises(ValueError, match="n_layers must divide by pp"):
        stage_range(6, 4, 0)
