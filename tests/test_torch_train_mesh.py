"""The port's train step on meshes (`parallel/train.py`: dp, tp, EP, pp and
their pairs) against `jlama_tpu`'s loss and gradients on one device: four
gloo rank processes on the CPU (tests/torch_train_ranks.py, started once
for the module) join one world a mesh, (2,1,1), (1,1,2), (1,2,1),
(2,1,2), (1,2,2), (2,2,1) and the tiny Mixtral's expert parallelism at
(1,1,2),
while this process computes JAX's references. XLA's CPU backend refuses a
tp = 2 mesh's bf16 step (`DotThunk`: BF16 x BF16 = F32), so every mesh is
held against one device, which computes the same function.

Per rank and case:
- the f32 composition: the loss within 1e-5 relative of JAX's, each
  gradient leaf and each leaf's SGD update within rel L2 1e-4 of the
  matching slice of JAX's (the rank's stage, fused with its tp rows,
  `parallel.mesh.shard_params`); a leaf whose gradient is 0 in exact
  arithmetic is measured against 1e-3 of the largest leaf's norm, and an
  update also gets what the f32 rounding of the leaf itself allows
  (`rounding`: a norm weight near 1 moved by 5e-4 keeps 1e-4 of it);
- one bf16 `make_train_step` step: its loss within 1e-3 of JAX's
  `loss_fn`, each leaf's update within 1.5 times JAX's own bf16-to-f32
  distance of JAX's bf16 update. A mesh does not keep one device's bf16
  rounding: under tp each rank's part of a replicated input's gradient is
  rounded to bf16 before the all-reduce sums the parts (Megatron's order),
  where one device rounds the whole f32 sum once; measured at most 1.08
  times that distance (dp and pp alone: below 1);
- every leaf that two ranks hold (replicated over tp, dp or the stages,
  the tied embedding under pp included) bit-equal on both, after either
  step.
"""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests import torch_train_ranks as R
from tests.helpers import TINY_LLAMA_CONFIG, make_tiny_llama, save_torch_model
from tests.test_torch_bridge import jax_tree_to_numpy, port_tree
from tests.test_torch_gpt2_bert import _perturb
from tests.test_torch_moe import TINY_MIXTRAL
from tests.test_torch_train import LLAMA, batch, jax_value_and_grad, named, rel
from tests.torch_tp_ranks import start_ranks, wait_ranks

F32_LOSS, F32_LEAF, BF16_LOSS = 1e-5, 1e-4, 1e-3
MESH_BF16 = 1.5
WORLDS = [(dims, cases) for worlds in R.ROUNDS for dims, cases, _ in worlds]
CASES = [(dims, cases, name) for dims, cases in WORLDS for name in cases]


def _trees(tmp):
    """name -> (JAX tree, HF config dict) of the cases' models."""
    from jlama_tpu.models.loader import load_params as jload
    from transformers import MixtralConfig, MixtralForCausalLM

    out = {}
    for name, over in (("llama_tied", LLAMA), ("llama", {})):
        model_dir, hf = make_tiny_llama(tmp / name, over)
        _perturb(hf, 3)
        save_torch_model(hf, model_dir, dict(TINY_LLAMA_CONFIG, **over))
        out[name] = (jload(model_dir, float_dtype=jnp.float32)[0], dict(TINY_LLAMA_CONFIG, **over))
    torch.manual_seed(7)
    hf = MixtralForCausalLM(MixtralConfig(
        **{k: v for k, v in TINY_MIXTRAL.items() if k != "model_type"})).eval()
    _perturb(hf, 8)
    save_torch_model(hf, tmp / "mixtral", TINY_MIXTRAL)
    out["mixtral"] = (jload(tmp / "mixtral", float_dtype=jnp.float32)[0], TINY_MIXTRAL)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results, JAX's references by case), the references
    computed here while the ranks run."""
    from jlama_tpu.config import from_hf_config as jcfg_of
    from jlama_tpu_torch.config import from_hf_config

    tmp = tmp_path_factory.mktemp("train_mesh")
    trees = _trees(tmp)
    toks, pos = batch(256)
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump({"trees": {k: (jax_tree_to_numpy(jp), hf) for k, (jp, hf) in trees.items()},
                     "tokens": toks, "positions": pos}, f)
    procs, end = start_ranks(R.train_rank_main,
                             lambda r: (r, str(tmp / "store"), str(tmp / "data.pkl"), str(tmp)),
                             world=R.WORLD)
    try:
        refs = {}
        for name, (jp, hf) in trees.items():
            jcfg = jcfg_of(hf)
            refs[name] = dict(cfg=from_hf_config(hf), params=port_tree(jp),
                              f32=jax_value_and_grad(jp, jcfg, toks, pos, jnp.float32),
                              bf16=jax_value_and_grad(jp, jcfg, toks, pos, None))
    finally:
        wait_ranks(procs, end)
    ranks = []
    for r in range(R.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, refs


def _members(ranks, dims, cases):
    return [res[dims, cases] for res in ranks if (dims, cases) in res]


def _rank_slice(tree_by_name: dict, ref: dict, dims, stage, tp_rank) -> dict:
    """The slice of a whole tree (by name, port layout) that a rank of this
    place holds: its stage's layers, fused with its tp rows."""
    from jlama_tpu_torch.models.base import fuse_params
    from jlama_tpu_torch.parallel.mesh import shard_params
    from jlama_tpu_torch.parallel.pipeline import stage_cut
    from jlama_tpu_torch.parallel.train import _tree

    whole = _tree(ref["params"], [tree_by_name[n] for n in named(ref["params"])])
    _, pp, tp = dims
    return named(shard_params(fuse_params(stage_cut(whole, ref["cfg"], pp, stage), tp),
                              ref["cfg"], tp, tp_rank))


def update_rel(p, p0, g, scale: float) -> float:
    """The distance of the stepped leaf p from p0 − lr·g, relative to the
    update lr·g (floored as `rel` floors)."""
    p, p0, g = p.double(), p0.double(), g.double()
    return float(torch.linalg.vector_norm(p - (p0 - R.LR * g))) / _floor(g, scale)


def _floor(g, scale: float) -> float:
    return max(float(torch.linalg.vector_norm(R.LR * g.double())), 1e-3 * R.LR * scale)


def rounding(p0, g, scale: float) -> float:
    """What the f32 rounding of a stepped leaf alone allows `update_rel`:
    2^-23 of the leaf's norm (the step and the reference each round it once)
    over the update's."""
    return 2.0 ** -23 * float(torch.linalg.vector_norm(p0.double())) / _floor(g, scale)


def _id(case):
    dims, _, name = case
    return "x".join(map(str, dims)) + "-" + name


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_f32_composition_matches_one_jax_device(run, case):
    ranks, refs = run
    dims, cases, name = case
    ref = refs[name]
    want_loss, want = ref["f32"]
    scale = max(float(torch.linalg.vector_norm(g)) for g in want.values())
    before = named(ref["params"])
    members = _members(ranks, dims, cases)
    assert len(members) == dims[0] * dims[1] * dims[2]
    for res in members:
        got = res[name]
        assert abs(got["f32_loss"] - want_loss) <= F32_LOSS * abs(want_loss)
        g_want = _rank_slice(want, ref, dims, res["stage"], res["tp_rank"])
        p0 = _rank_slice(before, ref, dims, res["stage"], res["tp_rank"])
        assert set(got["f32_grads"]) == set(g_want)
        for k, w in g_want.items():
            assert rel(torch.from_numpy(got["f32_grads"][k]), w, scale) <= F32_LEAF, k
            p = torch.from_numpy(got["f32_params"][k])
            assert update_rel(p, p0[k], w, scale) <= F32_LEAF + rounding(p0[k], w, scale), k


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_bf16_step_matches_one_jax_device(run, case):
    ranks, refs = run
    dims, cases, name = case
    ref = refs[name]
    want_loss, want = ref["bf16"]
    _, f32 = ref["f32"]
    scale = max(float(torch.linalg.vector_norm(g)) for g in want.values())
    before = named(ref["params"])
    for res in _members(ranks, dims, cases):
        got = res[name]
        assert abs(got["bf16_loss"] - want_loss) <= BF16_LOSS * abs(want_loss)
        g_want = _rank_slice(want, ref, dims, res["stage"], res["tp_rank"])
        g_f32 = _rank_slice(f32, ref, dims, res["stage"], res["tp_rank"])
        p0 = _rank_slice(before, ref, dims, res["stage"], res["tp_rank"])
        for k, w in g_want.items():
            p = torch.from_numpy(got["bf16_params"][k])
            assert update_rel(p, p0[k], w, scale) <= MESH_BF16 * rel(w, g_f32[k], scale) \
                + rounding(p0[k], w, scale), k


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: "x".join(map(str, w[0])))
def test_replicated_leaves_are_bit_equal_across_ranks(run, world):
    """Every leaf two ranks hold is the same bits on both, after the f32
    and the bf16 step; each rank has its mesh place."""
    ranks, _ = run
    dims, cases = world
    dp, pp, tp = dims
    members = _members(ranks, dims, cases)
    places = sorted((m["dp_index"], m["stage"], m["tp_rank"]) for m in members)
    assert places == [(d, s, t) for d in range(dp) for s in range(pp) for t in range(tp)]
    for name in cases:
        for field in ("f32_digests", "bf16_digests"):
            held = {}
            for m in members:
                for key, d in m[name][field].items():
                    held.setdefault(key, set()).add(d)
            shared = [k for k in held if sum(k in m[name][field] for m in members) > 1]
            assert shared, (name, field)
            assert all(len(held[k]) == 1 for k in shared), [k for k in shared
                                                            if len(held[k]) > 1]
            if pp > 1:
                assert ("top", "embed", "all") in shared or ("top", "embed", 0) in shared
