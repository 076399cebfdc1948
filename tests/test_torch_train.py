"""The port's train step (`jlama_tpu_torch/parallel/train.py`) against
`jlama_tpu/parallel/train.py` on one device, on the CPU: a tied Llama at
head size 64 (where inference would take K3), the tiny Mixtral (float
experts, B·T·K = 128, past `_moe_gathered`'s threshold of 8), Gemma 2
(softcaps, a window, post-norms, GELU) and GPT-2 (learned positions,
biases, GELU), each a tiny checkpoint written through `transformers` with
its norms and biases perturbed.

The JAX side is compiled with `xla_allow_excess_precision` off: XLA's CPU
backend otherwise keeps bf16 intermediates of fused elementwise ops in f32,
where the TPU, and the port, round every bf16 op. Limits:

- the f32 composition (`value_and_grad(dtype=float32)` against JAX's
  `forward_hidden(dtype=float32)` + the NLL): loss within 1e-5 relative,
  each leaf's rel L2 within 1e-4;
- the real bf16 `loss_fn`: loss within 1e-3 relative, and each leaf's
  distance from JAX's bf16 gradient within a third of JAX's own bf16-to-f32
  distance for that leaf, which the f32 composition fails (checked here
  too), so a port that trains in f32 cannot pass;
- one `make_train_step` step against JAX's `make_train_step` on meshes
  (1,1,1), (2,1,1) and (1,2,1) of the virtual CPU devices: the loss within
  1e-3 and each leaf's update within a third of JAX's bf16-to-f32
  distance (measured: at most 0.017 of it, the same on the three meshes).

A leaf whose gradient is 0 in exact arithmetic (k's bias: a shift of every
score of a query) is measured against 1e-3 of the largest leaf's norm.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests.helpers import TINY_LLAMA_CONFIG, make_tiny_llama, save_torch_model
from tests.test_torch_archs import ARCHS, _build
from tests.test_torch_bridge import jax_tree_to_numpy, port_tree
from tests.test_torch_gpt2_bert import GPT2, _perturb
from tests.test_torch_moe import TINY_MIXTRAL

NOEX = {"xla_allow_excess_precision": False}
B, T = 4, 16
F32_LOSS, F32_LEAF = 1e-5, 1e-4
BF16_LOSS, BF16_SHARE = 1e-3, 1 / 3
LR = 0.5

LLAMA = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=2,
             intermediate_size=256, tie_word_embeddings=True)


def _llama(tmp):
    model_dir, hf = make_tiny_llama(tmp, LLAMA)
    _perturb(hf, 3)
    save_torch_model(hf, model_dir, dict(TINY_LLAMA_CONFIG, **LLAMA))
    return model_dir


def _mixtral(tmp):
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(7)
    hf = MixtralForCausalLM(MixtralConfig(
        **{k: v for k, v in TINY_MIXTRAL.items() if k != "model_type"})).eval()
    _perturb(hf, 8)
    save_torch_model(hf, tmp, TINY_MIXTRAL)
    return tmp


def _gemma2(tmp):
    prefix, seed, cfg = ARCHS["gemma2"]
    _build(tmp, prefix, seed, cfg)
    return tmp


def _gpt2(tmp):
    from transformers import GPT2Config, GPT2LMHeadModel

    cfg = dict(GPT2, n_embd=64, n_inner=128)
    torch.manual_seed(0)
    hf = GPT2LMHeadModel(GPT2Config(**{k: v for k, v in cfg.items()
                                       if k != "model_type"})).eval()
    _perturb(hf, 10)
    save_torch_model(hf, tmp, cfg)
    return tmp


MODELS = {"llama_tied": _llama, "mixtral": _mixtral, "gemma2": _gemma2, "gpt2": _gpt2}


def named(tree) -> dict:
    from jlama_tpu_torch.parallel.train import _named_leaves

    return dict(_named_leaves(tree))


def rel(a, b, scale: float) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-3 * scale))


def batch(vocab: int):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, vocab, (B, T)).astype(np.int32)
    return toks, np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()


def jax_value_and_grad(jp, jcfg, toks, pos, dtype):
    """JAX's loss_fn (dtype None: its bf16 default) or its f32 composition,
    value and grad, compiled without excess precision; (loss, port-layout
    gradients by name)."""
    from jlama_tpu.models.base import forward_hidden, lm_logits
    from jlama_tpu.parallel.train import loss_fn

    def composed(p, t, ps):
        h, _ = forward_hidden(p, jcfg, t, ps, None, dtype=dtype)
        logp = jax.nn.log_softmax(lm_logits(p, jcfg, h)[:, :-1].astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, t[:, 1:, None], axis=-1)[..., 0].mean()

    fn = (lambda p, t, ps: loss_fn(p, jcfg, t, ps)) if dtype is None else composed
    args = (jp, jnp.asarray(toks), jnp.asarray(pos))
    loss, grads = jax.jit(jax.value_and_grad(fn)).lower(*args).compile(NOEX)(*args)
    return float(loss), named(port_tree(jax_tree_to_numpy(grads)))


@pytest.fixture(scope="module", params=list(MODELS))
def model(request, tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.config import load_config

    model_dir = MODELS[request.param](tmp_path_factory.mktemp(f"train_{request.param}"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    cfg = load_config(model_dir)
    toks, pos = batch(cfg.vocab_size)
    ref = {"bf16": jax_value_and_grad(jp, jcfg, toks, pos, None),
           "f32": jax_value_and_grad(jp, jcfg, toks, pos, jnp.float32)}
    return dict(name=request.param, jp=jp, jcfg=jcfg, cfg=cfg, toks=toks, pos=pos, ref=ref)


def _port(model, dtype):
    from jlama_tpu_torch.parallel.train import value_and_grad

    toks, pos = (torch.from_numpy(a).long() for a in (model["toks"], model["pos"]))
    loss, grads = value_and_grad(port_tree(model["jp"]), model["cfg"], toks, pos, dtype)
    return float(loss), named(grads)


def test_f32_composition_matches_jax(model):
    want_loss, want = model["ref"]["f32"]
    loss, got = _port(model, torch.float32)
    assert abs(loss - want_loss) <= F32_LOSS * abs(want_loss), (loss, want_loss)
    assert set(got) == set(want)
    scale = max(float(torch.linalg.vector_norm(g)) for g in want.values())
    worst = max((rel(got[k], want[k], scale), k) for k in want)
    assert worst[0] <= F32_LEAF, worst


def test_loss_fn_matches_jax_bf16_within_a_third_of_its_rounding(model):
    """Each leaf of the bf16 gradient within a third of JAX's bf16-to-f32
    distance; the f32 composition, a port that trains in f32, fails it."""
    want_loss, want = model["ref"]["bf16"]
    _, f32 = model["ref"]["f32"]
    loss, got = _port(model, torch.bfloat16)
    assert abs(loss - want_loss) <= BF16_LOSS * abs(want_loss), (loss, want_loss)
    scale = max(float(torch.linalg.vector_norm(g)) for g in want.values())
    share = {k: rel(got[k], want[k], scale) / rel(want[k], f32[k], scale) for k in want}
    worst = max((v, k) for k, v in share.items())
    assert worst[0] <= BF16_SHARE, worst
    _, port_f32 = _port(model, torch.float32)
    f32_share = [rel(port_f32[k], want[k], scale) / rel(want[k], f32[k], scale) for k in want]
    assert max(f32_share) > BF16_SHARE


@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.config import load_config

    model_dir = _llama(tmp_path_factory.mktemp("train_step_llama"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    cfg = load_config(model_dir)
    toks, pos = batch(cfg.vocab_size)
    _, bf16 = jax_value_and_grad(jp, jcfg, toks, pos, None)
    _, f32 = jax_value_and_grad(jp, jcfg, toks, pos, jnp.float32)
    return dict(jp=jp, jcfg=jcfg, cfg=cfg, toks=toks, pos=pos, bf16=bf16, f32=f32)


@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 1, 1), (1, 2, 1)])
def test_train_step_matches_jax_make_train_step(llama, dims):
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.parallel.train import make_train_step as jmake
    from jlama_tpu_torch.parallel.train import make_train_step

    dp, pp, tp = dims
    mesh = make_mesh(jax.devices()[:dp * pp * tp], dp=dp, pp=pp, tp=tp)
    toks, pos = jnp.asarray(llama["toks"]), jnp.asarray(llama["pos"])
    with mesh:
        jp = shard_params(jax.tree.map(jnp.array, llama["jp"]), llama["jcfg"], mesh)
        step = jmake(llama["jcfg"], mesh, lr=LR)
        jp_new, jloss = step.lower(jp, toks, pos).compile(NOEX)(jp, toks, pos)
    want = named(port_tree(jax_tree_to_numpy(jp_new)))
    before = named(port_tree(llama["jp"]))
    params = port_tree(llama["jp"])
    params, loss = make_train_step(llama["cfg"], lr=LR)(
        params, torch.from_numpy(llama["toks"]).long(), torch.from_numpy(llama["pos"]).long())
    got = named(params)
    assert abs(float(loss) - float(jloss)) <= BF16_LOSS * abs(float(jloss))
    scale = max(float(torch.linalg.vector_norm(g)) for g in llama["bf16"].values())
    for k in want:
        d = rel((got[k] - before[k]) / -LR, (want[k] - before[k]) / -LR, scale)
        noise = rel(llama["bf16"][k], llama["f32"][k], scale)
        assert d <= BF16_SHARE * noise, (k, d, noise)


def test_step_leaves_a_leaf_without_gradient_as_it_was(llama):
    """An unused leaf (a token-type table the llama never reads) has no
    gradient and keeps its value; the others move by lr times theirs."""
    from jlama_tpu_torch.parallel.train import make_train_step, tree_leaves, value_and_grad

    params = port_tree(llama["jp"])
    params["unused"] = torch.ones(3)
    toks, pos = (torch.from_numpy(llama[k]).long() for k in ("toks", "pos"))
    _, grads = value_and_grad(params, llama["cfg"], toks, pos)
    assert grads["unused"] is None
    before = {k: v.clone() for k, v in named(params).items()}
    make_train_step(llama["cfg"], lr=LR)(params, toks, pos)
    assert torch.equal(params["unused"], torch.ones(3))
    for (k, p), g in zip(named(params).items(), tree_leaves(grads), strict=True):
        if g is not None:
            assert torch.equal(p, before[k] - LR * g), k


def test_flash_prefill_raises_under_autograd():
    """K3's wrapper refuses a differentiable forward on either device (the
    kernel has no backward); without grad mode it runs as before."""
    from jlama_tpu_torch.ops.attention import flash_prefill

    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    k, v = torch.randn(1, 1, 8, 64), torch.randn(1, 1, 8, 64)
    pos0 = torch.zeros(1, dtype=torch.long)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_prefill(q, k, v, pos0, 0.125)
    with torch.no_grad():
        assert flash_prefill(q, k, v, pos0, 0.125).shape == (1, 2, 8, 64)


def test_train_path_takes_the_dense_attention(llama, monkeypatch):
    """At head size 64 (K3's sizes) loss_fn never calls K3's wrapper."""
    from jlama_tpu_torch.nn import layers
    from jlama_tpu_torch.parallel.train import loss_fn

    def refuse(*a, **kw):
        raise AssertionError("K3 on the train path")

    monkeypatch.setattr(layers, "flash_prefill", refuse)
    toks, pos = (torch.from_numpy(llama[k]).long() for k in ("toks", "pos"))
    assert torch.isfinite(loss_fn(port_tree(llama["jp"]), llama["cfg"], toks, pos))


def test_qarray_leaf_is_refused_by_name(llama):
    from jlama_tpu_torch.nn.qarray import quantize_q4
    from jlama_tpu_torch.parallel.train import make_train_step

    params = port_tree(llama["jp"])
    params["layers"][1]["wo"] = quantize_q4(params["layers"][1]["wo"].numpy())
    toks, pos = (torch.from_numpy(llama[k]).long() for k in ("toks", "pos"))
    with pytest.raises(TypeError, match=r"layers\[1\]\.wo is a q4 QArray"):
        make_train_step(llama["cfg"])(params, toks, pos)
