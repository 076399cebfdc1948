"""The train step's card paths (`parallel/train.py`): K6's gather under
autograd (`ops/moe_q4.py::moe_gather`, its backward the plain scatter-add),
the grouped product's gradient (`ops/moe_float.py::grouped_mm`, the card's
`torch._grouped_mm`), and the tiny train step on the card against the CPU.

Marked `cuda`: each test skips where torch has no CUDA device (as on the CPU
test runs); on a machine with an NVIDIA GPU run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_train.py -m cuda -q`.
This file imports no JAX (the card machine has none): the CPU side is the
port's own plain path.

- The gather: every held row the token's row, the foreign tail 0, and x's
  gradient equal to the plain indexing's autograd gradient over the held
  rows (each token's at most k rows summed: equal bits expected; held to
  one bf16 ulp).
- `_grouped_mm`'s gradients of x and w against the per-group f32 products'
  (`grouped_mm_plain`'s) autograd gradients, within a bf16 rounding of the
  largest (2^-7 of max|ref|, plus 1e-3 of it for the f32 sums' order).
- `linear` with a bf16 x and an f32 output (the logits, tp's partial sums)
  on the card: one tensor-core GEMM writing f32 (`ops/linear.py::_WideMM`),
  no f32 copy of the weight (the peak memory of a call below a bf16 copy's
  size), forward and gradients against the widened f32 product's within
  the f32 sums' order (4·K·2^-24 of the sum of |products|); a bias's
  gradient under bf16 activations one reduction of the rows.
- The step: a tiny Llama at head size 64 (the dense attention, no K3
  launch) on the card against the same tree on the CPU, f32 composition:
  loss within 1e-5, each leaf's rel L2 within 1e-4; bf16 `loss_fn`: loss
  within 1e-3 and each leaf within twice the CPU's own bf16-to-f32
  distance (the card's bf16 roundings are its own); a tiny Mixtral with
  float experts through the card's route (gather, grouped products) against
  the CPU's plain experts at 2e-2 rel L2 a leaf (the card's route rounds x
  and the down projection to bf16 even in the f32 composition, ROADMAP
  §3), with K6's gather and the grouped product launched.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

LLAMA = dict(model_type="llama", hidden_size=128, intermediate_size=256, num_attention_heads=2,
             num_key_value_heads=2, num_hidden_layers=2, rms_norm_eps=1e-5, vocab_size=256,
             max_position_embeddings=128, rope_theta=10000.0, bos_token_id=1, eos_token_id=2,
             hidden_act="silu", tie_word_embeddings=True)
MIXTRAL = dict(LLAMA, model_type="mixtral", hidden_size=64, intermediate_size=128,
               num_attention_heads=4, num_local_experts=4, num_experts_per_tok=2,
               tie_word_embeddings=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("lo", [None, 0, 4])
@pytest.mark.parametrize("t", [1, 37, 512])
def test_moe_gather_backward_matches_plain(cuda, t, lo):
    from jlama_tpu_torch.ops.moe_q4 import moe_gather, moe_groups

    g = torch.Generator(device=cuda).manual_seed(t)
    k, n_exp, d = 2, 8, 256
    n_local = n_exp if lo is None else 4
    e = torch.rand((t, n_exp), generator=g, device=cuda).argsort(dim=1)[:, :k].to(torch.int32)
    x = torch.randn((t, d), generator=g, device=cuda).to(torch.bfloat16).requires_grad_()
    groups = moe_groups(e, n_local, lo or 0)
    r = torch.randn((t * k, d), generator=g, device=cuda)
    held = torch.arange(t * k, device=cuda) < groups.offsets[-1]
    before = moe_gather.launches
    xg = moe_gather(x, groups, k)
    assert moe_gather.launches == before + 1
    plain = x.detach()[groups.order.long() // k]
    assert torch.equal(xg[held], plain[held]) and not xg[~held].any()
    (xg.float() * r).sum().backward()
    x2 = x.detach().clone().requires_grad_()
    rows = x2[groups.order.long() // k]
    (rows.float() * r * held[:, None]).sum().backward()
    lim = 2.0 ** -8 * x2.grad.float().abs() + 1e-30
    assert ((x.grad.float() - x2.grad.float()).abs() <= lim).all()


@pytest.mark.parametrize("rows", [[3, 0, 40, 5], [64, 64, 64, 64], [0, 0, 0, 9]])
def test_grouped_mm_gradient_matches_plain(cuda, rows):
    from jlama_tpu_torch.ops.moe_float import grouped_mm, grouped_mm_plain

    g = torch.Generator(device=cuda).manual_seed(sum(rows))
    k, n = 128, 64
    x = torch.randn((sum(rows), k), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((len(rows), k, n), generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    ends = torch.tensor(rows, device=cuda).cumsum(0).to(torch.int32)
    r = torch.randn((sum(rows), n), generator=g, device=cuda)
    grads = []
    for fn in (grouped_mm, grouped_mm_plain):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xi, wi, ends).float() * r).sum().backward()
        grads.append((xi.grad.float(), wi.grad.float()))
    for got, ref in zip(*grads):
        lim = (2.0 ** -7 + 1e-3) * ref.abs().max() + 1e-30
        assert ((got - ref).abs() <= lim).all()


@pytest.mark.parametrize("rows", [1, 74])
def test_wide_linear_is_one_f32_output_gemm(cuda, rows):
    from jlama_tpu_torch.ops.linear import add_bias, linear

    g = torch.Generator(device=cuda).manual_seed(rows)
    k, n = 256, 1000
    x = torch.randn((rows, k), generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn((n, k), generator=g, device=cuda) * 0.05
    r = torch.randn((rows, n), generator=g, device=cuda)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = linear(xs, ws, out_dtype=torch.float32)
    (got * r).sum().backward()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = torch.matmul(xr.float(), wr.to(torch.bfloat16).float().t())
    (ref * r).sum().backward()
    assert got.dtype == torch.float32
    wb = w.to(torch.bfloat16).float()
    tol = 4 * k * 2.0 ** -24
    assert ((got - ref).abs() <= tol * (x.float().abs() @ wb.abs().t()) + 1e-30).all()
    gx_lim = tol * (r.abs() @ wb.abs()) + 2.0 ** -7 * xr.grad.float().abs()
    assert ((xs.grad.float() - xr.grad.float()).abs() <= gx_lim + 1e-30).all()
    gw_lim = tol * (r.abs().t() @ x.float().abs()) + 2.0 ** -7 * wr.grad.abs()
    assert ((ws.grad - wr.grad).abs() <= gw_lim + 1e-30).all()
    # no f32 copy of the weight: a served bf16 lm_head's call allocates less
    # than the weight's own size
    big = torch.randn((32000, 4096), generator=g, device=cuda).to(torch.bfloat16)
    h = torch.randn((1, 4096), generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        linear(h, big, out_dtype=torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        y = linear(h, big, out_dtype=torch.float32)
        torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert torch.cuda.max_memory_allocated() - base < big.numel() * big.element_size()
    # a bias under bf16 activations: its gradient one reduction of the rows
    b = torch.randn((n,), generator=g, device=cuda).requires_grad_()
    yb = torch.randn((rows, n), generator=g, device=cuda).to(torch.bfloat16)
    gb = torch.randn((rows, n), generator=g, device=cuda).to(torch.bfloat16)
    add_bias(yb, b).backward(gb)
    want = gb.float().sum(0).to(torch.bfloat16).float()
    assert ((b.grad - want).abs() <= 2.0 ** -7 * want.abs() + 1e-30).all()


def _tree(cfg_dict, device):
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.base import params_to
    from jlama_tpu_torch.models.init import init_params

    cfg = from_hf_config(cfg_dict)
    cpu = init_params(cfg, seed=3, dtype=torch.float32, quantize=None, device="cpu")
    return cfg, cpu, params_to(cpu, device)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    from jlama_tpu_torch.ops.attention import flash_prefill
    from jlama_tpu_torch.parallel.train import tree_leaves, value_and_grad

    cfg, cpu, card = _tree(LLAMA, cuda)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 256, (4, 32), generator=g)
    pos = torch.arange(32).expand(4, 32)
    k3 = flash_prefill.launches
    ref = {d: value_and_grad(cpu, cfg, toks, pos, d) for d in (torch.float32, torch.bfloat16)}
    got = {d: value_and_grad(card, cfg, toks.to(cuda), pos.to(cuda), d)
           for d in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    assert flash_prefill.launches == k3
    l32, l32_ref = float(got[torch.float32][0]), float(ref[torch.float32][0])
    lb, lb_ref = float(got[torch.bfloat16][0]), float(ref[torch.bfloat16][0])
    assert abs(l32 - l32_ref) <= 1e-5 * abs(l32_ref) and abs(lb - lb_ref) <= 1e-3 * abs(lb_ref)
    for a, b, ab, bb in zip(*(tree_leaves(x[1]) for x in (got[torch.float32], ref[torch.float32],
                                                           got[torch.bfloat16],
                                                           ref[torch.bfloat16]))):
        assert _rel(a, b) <= 1e-4
        assert _rel(ab, bb) <= 2 * _rel(bb, b)


def test_float_moe_train_step_takes_the_card_route(cuda):
    from jlama_tpu_torch.ops.moe_float import grouped_mm
    from jlama_tpu_torch.ops.moe_q4 import moe_gather
    from jlama_tpu_torch.parallel.train import tree_leaves, value_and_grad

    cfg, cpu, card = _tree(MIXTRAL, cuda)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 256, (2, 24), generator=g)
    pos = torch.arange(24).expand(2, 24)
    before = (moe_gather.launches, grouped_mm.launches)
    loss, grads = value_and_grad(card, cfg, toks.to(cuda), pos.to(cuda), torch.float32)
    torch.cuda.synchronize()
    assert moe_gather.launches - before[0] == cfg.n_layers
    assert grouped_mm.launches - before[1] == 3 * cfg.n_layers
    ref_loss, ref = value_and_grad(cpu, cfg, toks, pos, torch.float32)
    assert abs(float(loss) - float(ref_loss)) <= 1e-3 * abs(float(ref_loss))
    for a, b in zip(tree_leaves(grads), tree_leaves(ref)):
        assert torch.isfinite(a).all() and _rel(a, b) <= 2e-2
