"""Expert parallelism's kernels on the card: K6 (`ops/moe_q4.py`) and the
float experts' route (`ops/moe_float.py`) over a rank's local range of
experts, against their plain versions with the same range.

Marked `cuda`: each test skips where torch has no CUDA device (as on the CPU
test runs); on a machine with an NVIDIA GPU run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ep.py -m cuda -q`.

A stack of 4 experts, the model's lo .. lo + 3 of 8 (lo 0 and 4, as the two
ranks of tp = 2 hold them), ids over all 8: K6's grouping puts no foreign
selection in a tile (one launch, no host sync), each route is held to its
plain model with the same range (the decode route to the plain version,
the prefill route to its rounding model: the same exact products, f32 sums
in another order, 1e-4 of max|ref|, plus one bf16 ulp of the value for a
bf16 output), every foreign row is exactly 0, and a second call gives the
same bits; the float route is held to `_moe_float_plain` with the same
range as tests/test_torch_cuda_kernels.py holds the whole route.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

N_EXP, N_LOCAL = 8, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ids(cuda, t, g):
    """Top-2 of 8 experts without replacement per token, [t, 2] int32."""
    return torch.rand((t, N_EXP), generator=g, device=cuda).argsort(dim=1)[:, :2].to(torch.int32)


def _foreign(e, lo):
    el = e.reshape(-1).long() - lo
    return (el < 0) | (el >= N_LOCAL)


def _within(got, ref, out_dtype):
    lim = 1e-4 * ref.abs().max().item()
    if out_dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.abs()
    return bool(((got.float() - ref).abs() <= lim).all())


@pytest.mark.parametrize("lo", [0, 4])
@pytest.mark.parametrize("r", [2, 32, 1024])
def test_local_grouping_on_the_card(cuda, r, lo):
    """moe_groups over the range [lo, lo + 4): one launch, equal to
    moe_groups_plain (order, offsets, both tile lists and their counts),
    under torch.cuda's sync debug mode at "error" (no host sync)."""
    from jlama_tpu_torch.ops.moe_q4 import moe_groups, moe_groups_plain

    g = torch.Generator(device=cuda).manual_seed(r + lo)
    e = _ids(cuda, r // 2, g)
    torch.cuda.synchronize()
    before = moe_groups.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe_groups(e, N_LOCAL, lo)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert moe_groups.launches == before + 1
    want = moe_groups_plain(e, N_LOCAL, lo)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("lo", [0, 4])
@pytest.mark.parametrize("r", [2, 32, 1024])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k6_local_range_matches_plain(cuda, r, lo, out_dtype):
    """Gate and up in one call (one x row a token) and down (one a
    selection) on a 4-expert stack: each route against its plain model with
    the same range, foreign rows exactly 0, a second call bit-equal."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.moe_q4 import (moe_gather, moe_q4_gate_up, moe_q4_matmul,
                                            moe_q4_matmul_plain, moe_q4_matmul_tiled_plain,
                                            takes_decode)

    n, k = 1000, 2048
    g = torch.Generator(device=cuda).manual_seed(r * 7 + lo)

    def stack():
        return QArray(torch.randint(0, 256, (N_LOCAL, n, k // 2), generator=g, device=cuda,
                                    dtype=torch.uint8),
                      (torch.rand((N_LOCAL, n, k // 32), generator=g, device=cuda) + 0.5)
                      * 0.0043)

    w1, w3, w2 = stack(), stack(), stack()
    e = _ids(cuda, r // 2, g)
    x = torch.randn((r // 2, k), generator=g, device=cuda).to(torch.bfloat16)
    h = torch.randn((r, k), generator=g, device=cuda).to(torch.bfloat16)
    model = moe_q4_matmul_plain if takes_decode(r) else moe_q4_matmul_tiled_plain
    foreign = _foreign(e, lo)
    before = (moe_q4_matmul.launches, moe_gather.launches)
    gate, up = moe_q4_gate_up(x, w1, w3, e, out_dtype, lo=lo)
    y2 = moe_q4_matmul(h, w2, e.reshape(-1), out_dtype, lo=lo)
    assert (moe_q4_matmul.launches, moe_gather.launches) == \
        (before[0] + 2, before[1] + 2 * (not takes_decode(r)))
    for y, (xx, w, ee) in ((gate, (x, w1, e)), (up, (x, w3, e)), (y2, (h, w2, e.reshape(-1)))):
        ref = model(xx, w, ee, torch.float32, lo=lo)
        torch.cuda.synchronize()
        assert _within(y, ref, out_dtype)
        assert bool((y.reshape(r, n)[foreign] == 0).all())
    again = moe_q4_gate_up(x, w1, w3, e, out_dtype, lo=lo)
    assert torch.equal(again[0], gate) and torch.equal(again[1], up)
    assert torch.equal(moe_q4_matmul(h, w2, e.reshape(-1), out_dtype, lo=lo), y2)


@pytest.mark.parametrize("lo", [0, 4])
@pytest.mark.parametrize("t", [1, 16, 512])
def test_float_route_local_range_matches_plain(cuda, t, lo):
    """The float experts' route over the range [lo, lo + 4) of 8 (K6's
    grouping and gather, the grouped product, the scatter, the mask):
    foreign rows exactly 0, the rest within tests/test_torch_cuda_kernels.py's
    limit of `_moe_float_plain` with the same range, a second call
    bit-equal, no host sync."""
    import dataclasses

    from jlama_tpu_torch.models.init import mixtral_8x7b_config
    from jlama_tpu_torch.nn import layers as L
    from jlama_tpu_torch.ops.moe_float import moe_float_experts, stack_in_out

    cfg = dataclasses.replace(mixtral_8x7b_config(), embedding_length=1024, hidden_length=1792)
    d, hd = 1024, 1792
    g = torch.Generator(device=cuda).manual_seed(t * 5 + lo)
    ws = {nm: (torch.randn(shape, generator=g, device=cuda) * 0.02).to(torch.bfloat16)
          for nm, shape in (("w1", (N_LOCAL, hd, d)), ("w3", (N_LOCAL, hd, d)),
                            ("w2", (N_LOCAL, d, hd)))}
    params = {f"experts.{nm}": w for nm, w in ws.items()}
    stacks = [stack_in_out(params[f"experts.{nm}"], False) for nm in ("w1", "w3", "w2")]
    x = torch.randn((t, d), generator=g, device=cuda).to(torch.bfloat16)
    e = _ids(cuda, t, g)
    act = lambda v: L.activation(v, "silu")  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe_float_experts(x, *stacks, e, N_LOCAL, act, lo)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    again = moe_float_experts(x, *stacks, e, N_LOCAL, act, lo)
    plain = L._moe_float_plain(x, params, cfg, e, lo)
    torch.cuda.synchronize()
    assert torch.equal(y, again)
    foreign = _foreign(e, lo)
    assert bool((y[foreign] == 0).all()) and bool((plain[foreign] == 0).all())
    el = (e.reshape(-1).long() - lo).clamp(0, N_LOCAL - 1)
    xs = x.float().repeat_interleave(2, dim=0)
    hf = L.activation(torch.einsum("rd,rhd->rh", xs, ws["w1"].float()[el]), "silu") \
        * torch.einsum("rd,rhd->rh", xs, ws["w3"].float()[el])
    absd = torch.einsum("rh,rdh->rd", hf.abs(), ws["w2"].float()[el].abs())
    assert bool(((y - plain).abs() <= 2.0 ** -8 * (plain.abs() + absd)).all())
