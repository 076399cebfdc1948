"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch has no CUDA device (as on the CPU
test runs); on a machine with an NVIDIA GPU run them with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -m cuda -q`
(`--noconftest`: `tests/conftest.py` imports jax, which such a machine may
not have; nothing here needs it).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def q8_tie_inputs(n_groups=3125, block=32, seed=0):
    """n_groups * block (10^5 by default) f32 values made from a seed with
    numpy, in groups of `block`: random group maxima (an eighth of them 127,
    where 127 / amax is 1), half the values drawn uniformly and half set to
    (k + 1/2) / (127 / amax) for an integer k, so that x * 127 / amax lands
    exactly on a half wherever that quotient is exact in f32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    amax = rng.uniform(0.01, 8.0, n_groups).astype(np.float32)
    amax[: n_groups // 8] = 127.0
    x = rng.uniform(-1, 1, (n_groups, block)).astype(np.float32) * amax[:, None]
    iscale = np.float32(127) / amax
    k = rng.integers(-127, 127, (n_groups, block)).astype(np.float32)
    half = ((k + np.float32(0.5)) / iscale[:, None]).astype(np.float32)
    x = np.where(rng.uniform(size=(n_groups, block)) < 0.5,
                 np.clip(half, -amax[:, None], amax[:, None]), x)
    sign = np.where(rng.uniform(size=n_groups) < 0.5, -1.0, 1.0).astype(np.float32)
    x[np.arange(n_groups), rng.integers(0, block, n_groups)] = amax * sign
    return x.reshape(-1)


# M = 2..16 with bf16 x takes the tensor-core route (both token tiles, ragged
# ones), M = 1 and f32 x the GEMV routes, M > 16 the wgmma route (f32 x cast to bf16
# by the wrapper); N not a multiple of 16; K = 96 (3 blocks, fewer than the 8
# warps; half a 64-wide K step at the end), 2048 and 14336; a tuple is x's
# leading dims. Past M = 16: the 1B prefill's wqkv at M = 511, w2 at 512, a
# perplexity window's 1024 rows at an uneven N, 37 rows of the 8B w2 and one
# exact 64 x 128 x 128 tile, beside 17 x 384 x 96 and 130 x 520 x 640.
@pytest.mark.parametrize("m,n,k", [(1, 256, 256), (3, 1000, 2048), (16, 512, 128),
                                   (17, 384, 96), (130, 520, 640), (2, 64, 14336),
                                   (2, 1000, 96), (5, 24, 2048), (8, 1000, 14336),
                                   (9, 24, 96), (13, 1000, 2048), (16, 1000, 14336),
                                   (16, 24, 2048), ((2, 3), 1000, 2048),
                                   (511, 3072, 2048), (512, 2048, 8192), (1024, 1000, 2048),
                                   (37, 2048, 14336), (64, 128, 128)])
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.float32),
                                               (torch.bfloat16, torch.float32)])
def test_q4_matmul_kernel_matches_plain(cuda, m, n, k, x_dtype, out_dtype):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain, q4_matmul_tiled_plain

    lead = m if isinstance(m, tuple) else (m,)
    rows = 1
    for d in lead:
        rows *= d
    g = torch.Generator(device=cuda).manual_seed(rows * n + k)
    w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=cuda, dtype=torch.uint8),
               torch.rand((n, k // 32), generator=g, device=cuda) * 0.01)
    x = torch.randn((*lead, k), generator=g, device=cuda).to(x_dtype)
    before = q4_matmul.launches
    got = q4_matmul(x, w, out_dtype)
    assert q4_matmul.launches == before + 1 and got.dtype == out_dtype
    assert got.shape == (*lead, n)
    ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
    torch.cuda.synchronize()
    # M <= 16 dequantizes exactly (products exact in f32, f32 scales; only the
    # order of the f32 sums differs); the tiled path rounds W to bf16
    tol = 2e-2 if (rows > 16 or out_dtype == torch.bfloat16) else 1e-4
    assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    if rows > 16:
        # against the route's rounding model: the same exact products, f32
        # sums in another order (1e-4 of max|ref|), plus one bf16 ulp (2^-7 of
        # the value) for a bf16 output
        model = q4_matmul_tiled_plain(x, w.data, w.scales, torch.float32)
        lim = 1e-4 * model.abs().max().item()
        if out_dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * model.abs()
        assert bool(((got.float() - model).abs() <= lim).all())
        # the same call again, bit for bit (a missing proxy fence shows as a
        # result that changes between runs)
        again = q4_matmul(x, w, out_dtype)
        assert q4_matmul.launches == before + 2
        assert torch.equal(again, got)


def test_q4_matmul_both_m16_routes_launch(cuda):
    """At M = 16 bf16 x takes the tensor-core route and f32 x the GEMV: each
    call counts one launch and meets its own limit (bf16 out: 2e-2 of
    max|ref|; f32 out: 1e-4)."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(16)
    n, k = 2048, 2048
    w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=cuda, dtype=torch.uint8),
               torch.rand((n, k // 32), generator=g, device=cuda) * 0.01)
    x = torch.randn((16, k), generator=g, device=cuda)
    for x_dtype, out_dtype, tol in ((torch.bfloat16, torch.bfloat16, 2e-2),
                                    (torch.float32, torch.float32, 1e-4)):
        xi = x.to(x_dtype)
        before = q4_matmul.launches
        got = q4_matmul(xi, w, out_dtype)
        assert q4_matmul.launches == before + 1
        ref = q4_matmul_plain(xi, w.data, w.scales, torch.float32)
        torch.cuda.synchronize()
        assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


# The GEMV routes (bf16 x at M = 1 on the tensor cores, f32 x at M <= 16 on
# the CUDA cores): Llama-3.2-1B's decode shapes at M = 1, ragged N (1, 96,
# 1000: half tiles, rows past N), K tails that fill no step or slice (32, 96,
# 800) and the 8B w2's 14336, f32 x at M = 2, 5 and 16. Each is held to the
# plain version (f32 out: 1e-4 of max|ref|, the f32 sums in another order; bf16
# out: that plus one bf16 ulp of the value), counts one launch a call, and
# gives the same bits on a second call.
GEMV_CASES = [(1, 3072, 2048), (1, 16384, 2048), (1, 2048, 8192), (1, 1, 2048), (1, 96, 2048),
              (1, 1000, 2048), (1, 300, 32), (1, 100, 96), (1, 1000, 800), (1, 512, 14336),
              (2, 1000, 2048), (5, 96, 800), (16, 1000, 2048), (16, 64, 14336), (5, 1, 32)]


@pytest.mark.parametrize("m,n,k,x_dtype,out_dtype", [
    (m, n, k, xd, od) for m, n, k in GEMV_CASES
    for xd, od in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                   (torch.float32, torch.float32), (torch.float32, torch.bfloat16))
    if m == 1 or xd == torch.float32])  # bf16 x at M > 1 takes the mma route (above)
def test_q4_gemv_routes_match_plain_and_repeat(cuda, m, n, k, x_dtype, out_dtype):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain, takes_gemv

    assert takes_gemv(m, x_dtype)
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=cuda, dtype=torch.uint8),
               (torch.rand((n, k // 32), generator=g, device=cuda) + 0.5) * 0.0043)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    before = q4_matmul.launches
    got = q4_matmul(x, w, out_dtype)
    assert q4_matmul.launches == before + 1 and got.dtype == out_dtype
    assert got.shape == (m, n)
    ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
    torch.cuda.synchronize()
    lim = 1e-4 * ref.abs().max().item()
    if out_dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.abs()
    assert bool(((got.float() - ref).abs() <= lim).all())
    again = q4_matmul(x, w, out_dtype)
    assert q4_matmul.launches == before + 2
    assert torch.equal(again, got)


def test_q8_quantize_on_card_equals_cpu(cuda):
    """q8_quantize on the card equals it on the CPU bit for bit (codes and
    scales), on values that land exactly on rounding ties."""
    from jlama_tpu_torch.quant.blockq import q8_quantize

    x = torch.from_numpy(q8_tie_inputs()).reshape(-1, 32)
    cq, cs = q8_quantize(x)
    gq, gs = q8_quantize(x.to(cuda))
    assert torch.equal(gq.cpu(), cq)
    assert torch.equal(gs.cpu().view(torch.int32), cs.view(torch.int32))


# pos0 an int: the same for every row; a tuple: one per row. S = 700 and 333
# are not multiples of the bf16 route's key tile (128 at hd 64, 64 at hd
# 128, 32 at hd 256). H 32 / n_kv 8 are Llama-3.2-1B's heads: T = S = 512 is
# its prefill (query tiles of 64), B = 4 x T = 256 a serving chunk (tiles of
# 128). H 8 / n_kv 4 at hd 256 are Gemma-2-2B's: keys past one 32-key tile
# and queries past one 64-row tile, its softcap of 50 with a window, its
# 512-token prefill and 1,100-2,304-token ones (tiles of 64 rows at hd 256).
@pytest.mark.parametrize("B,T,S,pos0,hd,cap,win,H,n_kv", [
    (1, 64, 64, 0, 64, None, None, 8, 2), (2, 40, 100, 60, 128, None, None, 8, 2),
    (1, 33, 77, 20, 64, 30.0, 16, 8, 2), (1, 128, 512, 384, 128, None, None, 8, 2),
    (3, 100, 700, (0, 300, 600), 64, None, None, 8, 2),
    (2, 77, 333, (256, 5), 128, None, None, 8, 2),
    (2, 64, 300, (10, 200), 128, 30.0, 40, 8, 2),
    (1, 512, 512, 0, 64, None, None, 32, 8),
    (4, 256, 1024, (0, 256, 512, 768), 64, None, None, 32, 8),
    (4, 256, 768, (0, 100, 300, 512), 128, None, None, 32, 8),
    (1, 100, 150, 40, 256, None, None, 8, 4),
    (2, 130, 300, (10, 170), 256, 50.0, 64, 8, 4),
    (1, 512, 512, 0, 256, 50.0, None, 8, 4),
    (2, 1100, 1300, (0, 200), 256, 50.0, 300, 8, 4),
    (1, 2304, 2304, 0, 256, None, None, 8, 4),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_kernel_matches_plain(cuda, B, T, S, pos0, hd, cap, win, H, n_kv, dtype):
    """Within 2e-5 (f32) or 2e-2 (bf16) of the plain version; the bf16 route
    also within 4e-3 of its rounding model (P rounded to bf16 per key tile)
    and bit-equal on a repeat."""
    from jlama_tpu_torch.ops.attention import (flash_prefill, flash_prefill_plain,
                                               flash_prefill_tiled_plain)

    g = torch.Generator(device=cuda).manual_seed(T * S + hd)
    q = torch.randn((B, H, T, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    p0 = torch.tensor(pos0 if isinstance(pos0, tuple) else (pos0,) * B, dtype=torch.int32,
                      device=cuda)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    assert flash_prefill.launches == before + 1
    ref = flash_prefill_plain(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        model = flash_prefill_tiled_plain(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
        assert (got.float() - model.float()).abs().max().item() <= 4e-3
        assert torch.equal(flash_prefill(q, k, v, p0, hd ** -0.5, softcap=cap, window=win), got)


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_kernel_not_causal(cuda, hd, dtype):
    """causal=False (every key < S for every row), with a ragged S and a
    different pos0 per row: the plain version's limits, and for bf16 the
    rounding model's 4e-3 and a bit-equal repeat."""
    from jlama_tpu_torch.ops.attention import (flash_prefill, flash_prefill_plain,
                                               flash_prefill_tiled_plain)

    g = torch.Generator(device=cuda).manual_seed(hd)
    B, H, n_kv, T, S = 2, 8, 2, 96, 200
    q = torch.randn((B, H, T, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    p0 = torch.tensor([0, 70], dtype=torch.int32, device=cuda)
    got = flash_prefill(q, k, v, p0, hd ** -0.5, causal=False)
    ref = flash_prefill_plain(q, k, v, p0, hd ** -0.5, causal=False)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        model = flash_prefill_tiled_plain(q, k, v, p0, hd ** -0.5, causal=False)
        assert (got.float() - model.float()).abs().max().item() <= 4e-3
        assert torch.equal(flash_prefill(q, k, v, p0, hd ** -0.5, causal=False), got)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_flash_prefill_misaligned_view_raises(cuda, which):
    """The bf16 route loads by TMA: a view one element off a 16-byte boundary
    raises, and nothing is launched."""
    from jlama_tpu_torch.ops.attention import flash_prefill

    B, H, n_kv, T, S, hd = 1, 8, 2, 64, 64, 64
    shapes = {"q": (B, H, T, hd), "k": (B, n_kv, S, hd), "v": (B, n_kv, S, hd)}
    t = {n: torch.randn(sh, device=cuda).to(torch.bfloat16) for n, sh in shapes.items()}
    base = torch.zeros(t[which].numel() + 1, dtype=torch.bfloat16, device=cuda)
    t[which] = base[1:].view(shapes[which])  # storage offset one element (2 bytes)
    before = flash_prefill.launches
    with pytest.raises(ValueError, match="TMA"):
        flash_prefill(t["q"], t["k"], t["v"], torch.zeros(B, dtype=torch.int32, device=cuda),
                      hd ** -0.5)
    assert flash_prefill.launches == before


def test_engine_on_card_matches_cpu_logits(cuda):
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.base import forward_logits, fuse_params, params_to
    from jlama_tpu_torch.models.init import init_params

    # written out, not taken from tests/helpers.py: on a machine where some
    # installed package ships a top-level `tests`, `tests.helpers` resolves there
    cfg = from_hf_config({
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "rms_norm_eps": 1e-5, "vocab_size": 256, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2,
        "hidden_act": "silu", "tie_word_embeddings": False,
    })
    params = fuse_params(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    toks = torch.tensor([[1, 5, 9, 42, 7, 13, 99, 100] * 4])
    pos = torch.arange(toks.shape[1])[None, :]
    ref, _ = forward_logits(params, cfg, toks, pos, None, dtype=torch.float32)
    got, _ = forward_logits(params_to(params, cuda), cfg, toks.to(cuda), pos.to(cuda), None,
                            dtype=torch.float32)
    # the tiled K1 path (M = 32 > 16) rounds x and W to bf16 on the card
    rel = ((got.cpu() - ref).norm() / ref.norm()).item()
    assert rel < 3e-2, rel


def _pools(cuda, kind, shape, g):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.quant.blockq import q8_quantize

    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=g, device=cuda)
        if kind == "q8":
            out.append(QArray(*q8_quantize(x), "q8"))
        else:
            out.append(x.to(torch.bfloat16 if kind == "bf16" else torch.float32))
    return out


def _layer(pool, l):
    from jlama_tpu_torch.nn.qarray import QArray

    return QArray(pool.data[l], pool.scales[l], "q8") if isinstance(pool, QArray) else pool[l]


# "short": 5 rows within one split of the kernel; "long": rows up to 2,000
# keys on pages of 16, which take several splits, and a row of length 0
K2_ROWS = {"short": ([1, 37, 96, 50, 17], 6), "long": ([0, 2000, 1037, 16, 1], 125)}


def _k2_page_tables(cuda, lengths, P, ps, n_pages, g=None):
    """[B, P] int32 of distinct random pages (1 .. n_pages-1) over each row's
    live keys, from the generator g (the global one where none is given);
    empty decode slots (length 0 or 1) on the scratch page 0."""
    pt = torch.zeros((len(lengths), P), dtype=torch.int32, device=cuda)
    perm = (torch.randperm(n_pages - 1, device=cuda, generator=g) + 1).to(torch.int32)
    nxt = 0
    for b, ln in enumerate(lengths):
        n = -(-ln // ps) if ln > 1 else 0
        pt[b, :n] = perm[nxt:nxt + n]
        nxt += n
    return pt


@pytest.mark.parametrize("hd,cap,win", [(64, None, None), (128, 30.0, 20), (64, None, 9),
                                        (64, None, 700), (256, None, None), (256, 50.0, 9),
                                        (256, 50.0, 700)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
# groups of 4, 32 (MQA), 24 (a partial row group) and 1
@pytest.mark.parametrize("H,n_kv", [(8, 2), (32, 1), (48, 2), (8, 8)])
@pytest.mark.parametrize("rows", ["short", "long"])
# f32 q: the CUDA-core route; bf16 q on a bf16 or q8 pool: the tensor cores,
# held to one bf16 ulp of the output (2^-7 |plain|) beside the same limit
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(cuda, q_dtype, rows, kind, hd, cap, win, H, n_kv):
    from jlama_tpu_torch.ops.attention import paged_decode, paged_decode_plain

    g = torch.Generator(device=cuda).manual_seed(hd + int(cap or 0))
    lens, P = K2_ROWS[rows]
    B, ps = len(lens), 16
    n_pages = sum(-(-ln // ps) for ln in lens) + 8
    # stacked [L=2, ...] pools, read through layer 1's strided view
    kp, vp = (_layer(p, 1) for p in _pools(cuda, kind, (2, n_kv, n_pages, ps, hd), g))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    # hd 256's page tables from g: the global generator's draws, which later
    # tests take, stay those of the cases at hd 64 and 128
    pt = _k2_page_tables(cuda, lens, P, ps, n_pages, g if hd == 256 else None)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(q_dtype)
    before = paged_decode.launches
    got = paged_decode(q, kp, vp, pt, lengths, hd ** -0.5, cap, win).float()
    assert paged_decode.launches == before + 1
    ref = paged_decode_plain(q, kp, vp, pt, lengths, hd ** -0.5, cap, win).float()
    torch.cuda.synchronize()
    tol = 3e-3 if kind == "q8" else 2e-5
    if q_dtype == torch.float32:
        assert (got - ref).abs().max().item() <= tol
    else:
        assert torch.all((got - ref).abs() <= 2.0 ** -7 * ref.abs() + tol)
    if lens[0] == 0:
        assert torch.all(got[0] == 0)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_long_row_rolls_its_lookups(cuda, q_dtype):
    """One row of 40,000 keys on pages of 64 and one KV head: too few (row, KV
    head) pairs to fill the card, so each split holds more than the 8 tiles
    whose page lookups a block loads up front, and the rest are looked up a
    tile at a time (both routes)."""
    from jlama_tpu_torch.ops.attention import paged_decode, paged_decode_plain

    g = torch.Generator(device=cuda).manual_seed(40)
    n, ps, hd, H = 40_000, 64, 64, 4
    P = -(-n // ps)
    kp, vp = _pools(cuda, "bf16", (1, P + 1, ps, hd), g)
    pt = (torch.randperm(P, device=cuda) + 1).to(torch.int32)[None, :]
    lengths = torch.tensor([n], dtype=torch.int32, device=cuda)
    q = torch.randn((1, H, hd), generator=g, device=cuda).to(q_dtype)
    got = paged_decode(q, kp, vp, pt, lengths, hd ** -0.5).float()
    ref = paged_decode_plain(q, kp, vp, pt, lengths, hd ** -0.5).float()
    torch.cuda.synchronize()
    if q_dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 2e-5
    else:
        assert torch.all((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 2e-5)


@pytest.mark.parametrize("length,win", [(1, None), (600, None), (640, None), (640, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_dense_view(cuda, dtype, length, win):
    """The Engine's route: one row's dense cache [1, n_kv, 1024, hd], cut to
    a 640-slot window, as one page of 640 slots (page stride n_kv * 1024 *
    hd); f32 within 2e-5, bf16 within one bf16 ulp (2^-7 |plain|) + 2e-5."""
    from jlama_tpu_torch.ops.attention import paged_decode, paged_decode_plain
    from jlama_tpu_torch.ops.kv_write import dense_page_table, dense_pool_view

    g = torch.Generator(device=cuda).manual_seed(length)
    H, n_kv, hd, S, W = 32, 8, 64, 1024, 640
    k, v = (torch.randn((1, n_kv, S, hd), generator=g, device=cuda).to(dtype) for _ in range(2))
    q = torch.randn((1, H, hd), generator=g, device=cuda).to(dtype)
    args = (q, dense_pool_view(k[:, :, :W]), dense_pool_view(v[:, :, :W]),
            dense_page_table(1, cuda), torch.tensor([length], device=cuda), hd ** -0.5, None,
            win)
    before = paged_decode.launches
    got = paged_decode(*args).float()
    assert paged_decode.launches == before + 1
    ref = paged_decode_plain(*args).float()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - ref).abs().max().item() <= 2e-5
    else:
        assert torch.all((got - ref).abs() <= 2.0 ** -7 * ref.abs() + 2e-5)


def _k2_large_scores_f64(cuda, kind, hd, seed):
    """Large scores on the tensor-core route (bf16 q): q and K of size ~16,
    as a deeper layer of a random-weight model gives at head size 128, so
    scores of several hundred to ~1,000 (the route once took its running max
    in natural units and its exponents in log2 units, and overflowed to NaN
    past scores of ~285), with the page layout drawn from its own generator
    seeded `seed`: the kernel's and the plain version's
    outputs, the f64 reference, and the f32 rounding each may carry from its
    scores. That term is the output's sensitivity to its scores, sum_i p_i
    |v_i - o| (d o / d s_i = p_i (v_i - o)), times 4 units of f32 rounding at
    the row's largest |score|: near nothing where one key dominates, and up
    to ~1e-4 where two near-tied keys cancel."""
    from jlama_tpu_torch.ops.attention import _gather_pages, paged_decode, paged_decode_plain

    g = torch.Generator(device=cuda).manual_seed(hd)
    lens, P = K2_ROWS["long"]
    B, ps, H, n_kv = len(lens), 16, 32, 8
    n_pages = sum(-(-ln // ps) for ln in lens) + 8
    kp, vp = _pools(cuda, kind, (n_kv, n_pages, ps, hd), g)
    if kind == "bf16":
        kp = kp * 16
    else:
        kp.scales.mul_(16)
    layout = torch.Generator(device=cuda).manual_seed(seed)
    pt = _k2_page_tables(cuda, lens, P, ps, n_pages, layout)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = (torch.randn((B, H, hd), generator=g, device=cuda) * 16).to(torch.bfloat16)
    got = paged_decode(q, kp, vp, pt, lengths, hd ** -0.5).double()
    ref = paged_decode_plain(q, kp, vp, pt, lengths, hd ** -0.5).double()
    k, v = (_gather_pages(p, pt).double() for p in (kp, vp))
    s = torch.einsum("bkgd,bksd->bkgs", q.reshape(B, n_kv, H // n_kv, hd).double(), k)
    live = (torch.arange(k.shape[2], device=cuda)[None, :] < lengths[:, None])[:, None, None]
    s = torch.where(live, s * hd ** -0.5, torch.tensor(-torch.inf, device=cuda,
                                                      dtype=torch.float64))
    p = torch.nan_to_num(torch.softmax(s, dim=-1))  # a row with no live key: zeros
    exact = torch.einsum("bkgs,bksd->bkgd", p, v)
    sens = torch.stack([  # one row at a time: [n_kv, G, S, hd] in f64
        torch.einsum("kgs,kgsd->kgd", p[b], (v[b][:, None] - exact[b][:, :, None]).abs())
        for b in range(B)])
    smax = s.masked_fill(~live, 0).abs().amax(dim=-1, keepdim=True)
    rounding = (4 * 2.0 ** -24 * smax * sens).reshape(B, H, hd)
    torch.cuda.synchronize()
    return got, ref, exact.reshape(B, H, hd), rounding, smax.max().item()


@pytest.mark.parametrize("seed", range(24))
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_paged_decode_kernel_large_scores_f64(cuda, kind, hd, seed):
    """The large-score case over 24 page layouts at head sizes 64, 128 and
    256 (Gemma's; Gemma 1 puts no softcap on its scores), against an f64
    reference: the probabilities stay finite, and the kernel and the plain
    version each lie within 2^-7 |exact| + the f32 limit (2e-5; 3e-3 on a q8
    pool) plus the f32 rounding their scores carry (`_k2_large_scores_f64`).
    Without that last term the plain f32 version itself misses the limit on
    some layouts where near-tied keys cancel, as the kernel does (ROADMAP
    section 3)."""
    got, ref, exact, rounding, smax = _k2_large_scores_f64(cuda, kind, hd, seed)
    assert torch.isfinite(got).all() and torch.isfinite(ref).all()
    assert 300 < smax < 1500, smax  # the regime the route once overflowed in
    tol = 3e-3 if kind == "q8" else 2e-5
    lim = 2.0 ** -7 * exact.abs() + tol + rounding
    for out in (got, ref):
        assert torch.all((out - exact).abs() <= lim), ((out - exact).abs() - lim).max().item()


@pytest.mark.parametrize("kind", ["bf16", "q8"])
def test_paged_decode_kernel_repeat_is_bit_equal(cuda, kind):
    """Rows over several splits: the last block of a row merges the splits in
    split order, whichever block comes last, so a repeat is equal bit for bit."""
    from jlama_tpu_torch.ops.attention import paged_decode

    g = torch.Generator(device=cuda).manual_seed(7)
    lens, P = K2_ROWS["long"]
    B, ps, H, n_kv, hd = len(lens), 16, 32, 8, 64
    n_pages = sum(-(-ln // ps) for ln in lens) + 8
    kp, vp = _pools(cuda, kind, (n_kv, n_pages, ps, hd), g)
    pt = _k2_page_tables(cuda, lens, P, ps, n_pages)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((B, H, hd), generator=g, device=cuda).to(torch.bfloat16)
    first = paged_decode(q, kp, vp, pt, lengths, hd ** -0.5)
    for _ in range(3):
        assert torch.equal(paged_decode(q, kp, vp, pt, lengths, hd ** -0.5), first)


@pytest.mark.parametrize("B,T", [(4, 1), (3, 37)])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
def test_kv_write_kernel_matches_plain(cuda, kind, B, T):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.kv_write import kv_write, kv_write_plain

    g = torch.Generator(device=cuda).manual_seed(B * T)
    n_kv, ps, n_pages, P, hd = 2, 16, 20, 4, 64
    stacked = _pools(cuda, kind, (2, n_kv, n_pages, ps, hd), g)

    def clone(p):
        return QArray(p.data.clone(), p.scales.clone(), "q8") if isinstance(p, QArray) \
            else p.clone()

    mine = [clone(p) for p in stacked]
    plain = [clone(p) for p in stacked]
    pt = (torch.randperm(n_pages - 1, device=cuda)[: B * P] + 1).to(torch.int32).reshape(B, P)
    pt[-1] = 0  # a pad row on the scratch page
    start = torch.tensor([0, 5, 40, 60][:B], device=cuda)  # the last row runs past its table
    pos = start[:, None] + torch.arange(T, device=cuda)[None, :]
    new = [torch.randn((B, T, n_kv, hd), generator=g, device=cuda).to(torch.bfloat16)
           for _ in range(2)]
    before = kv_write.launches
    kv_write(_layer(mine[0], 1), _layer(mine[1], 1), *new, pt, pos)
    assert kv_write.launches == before + 1
    kv_write_plain(_layer(plain[0], 1), _layer(plain[1], 1), *new, pt, pos)
    torch.cuda.synchronize()
    for a, b in zip(mine, plain):  # page 0 left out: the pad row's writes race there
        if kind == "q8":  # both round as q8_quantize does: equal
            assert torch.equal(a.data[:, :, 1:], b.data[:, :, 1:])
            assert torch.equal(a.scales[:, :, 1:], b.scales[:, :, 1:])
        else:
            assert torch.equal(a[:, :, 1:], b[:, :, 1:])


def test_kv_write_kernel_dense_engine_view(cuda):
    from jlama_tpu_torch.ops.kv_write import dense_page_table, dense_pool_view, kv_write

    cache = torch.randn((2, 4, 32, 64), device=cuda).to(torch.bfloat16)
    ref = cache.clone()
    new = torch.randn((2, 3, 4, 64), device=cuda)  # f32 rows into a bf16 cache
    pos = torch.tensor([[7, 8, 9], [29, 30, 31]], device=cuda)
    kv_write(dense_pool_view(cache), dense_pool_view(cache), new, new,
             dense_page_table(2, cuda), pos)
    for b in range(2):
        ref[b, :, pos[b]] = new[b].transpose(0, 1).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


# K4 with RoPE fused, at the main path's shapes (32 query heads, 8 KV heads):
# label -> (B, T, hd, dense). "decode": 16 ragged slots, the empty ones on the
# scratch page; "chunk": 4 rows of a 256-token prefill chunk, one running past
# its page table; "dense": the Engine's cache, one row of 2,048 slots
K4_ROPE_CASES = {"decode": (16, 1, 64, False), "chunk": (4, 256, 64, False),
                 "dense T1": (1, 1, 64, True), "dense T512": (1, 512, 64, True),
                 "hd128": (16, 1, 128, False), "hd256": (16, 1, 256, False)}
K4_DECODE_LENGTHS = [1, 2048, 1500, 1024, 777, 64, 65, 300, 2000, 129, 1, 513, 1800, 256, 999,
                     1234]


@pytest.mark.parametrize("case,kind", [(c, k) for c, (_, _, _, dense) in K4_ROPE_CASES.items()
                                       for k in (("f32", "bf16") if dense
                                                 else ("f32", "bf16", "q8"))])
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
def test_kv_write_rope_kernel_matches_plain(cuda, case, kind, act):
    """q, k, v as the split views of one fused QKV output: one launch per
    call; q_rot and float pools equal to the plain version (`apply_rope`,
    then the plain write) bit for bit, q8 payloads within 1 code and scales
    within 1 ulp; a repeat equal bit for bit."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.kv_write import (
        dense_page_table, dense_pool_view, kv_write, kv_write_plain)

    B, T, hd, dense = K4_ROPE_CASES[case]
    H, n_kv, ps = 32, 8, 64
    g = torch.Generator(device=cuda).manual_seed(B * T + hd)
    if dense:
        pools = [dense_pool_view(c) for c in _pools(cuda, kind, (B, n_kv, 2048, hd), g)]
        pt = dense_page_table(B, cuda)
        pos = ((700 if T == 1 else 0) + torch.arange(T, device=cuda))[None, :].expand(B, T)
    else:
        P = 32
        pools = _pools(cuda, kind, (n_kv, 16 * P + 1, ps, hd), g)
        if T == 1:
            pt = _k2_page_tables(cuda, K4_DECODE_LENGTHS, P, ps, 16 * P + 1)
            pos = (torch.tensor(K4_DECODE_LENGTHS, device=cuda) - 1)[:, None]
        else:
            pt = (torch.randperm(16 * P, device=cuda)[: B * P] + 1).to(torch.int32)
            pt = pt.reshape(B, P)
            start = torch.tensor([0, 300, 1500, P * ps - T + 40], device=cuda)
            pos = start[:, None] + torch.arange(T, device=cuda)[None, :]
    qkv = torch.randn((B, T, (H + 2 * n_kv) * hd), generator=g, device=cuda).to(act)
    q, k, v = qkv.split((H * hd, n_kv * hd, n_kv * hd), dim=-1)
    q, k, v = q.reshape(B, T, H, hd), k.reshape(B, T, n_kv, hd), v.reshape(B, T, n_kv, hd)
    inv = 1.0 / (500000.0 ** (torch.arange(0, hd, 2, device=cuda, dtype=torch.float32) / hd))
    ang = pos[..., None].float() * inv
    cos, sin = torch.cos(ang), torch.sin(ang)

    def clone(p):
        return QArray(p.data.clone(), p.scales.clone(), "q8") if isinstance(p, QArray) \
            else p.clone()

    mine, again, plain = ([clone(p) for p in pools] for _ in range(3))
    before = kv_write.launches
    got = kv_write(*mine, k, v, pt, pos, q=q, cos=cos, sin=sin)
    assert kv_write.launches == before + 1
    rep = kv_write(*again, k, v, pt, pos, q=q, cos=cos, sin=sin)
    ref = kv_write_plain(*plain, k, v, pt, pos, q=q, cos=cos, sin=sin)
    torch.cuda.synchronize()
    assert got.shape == (B, T, H, hd) and got.dtype == act and got.is_contiguous()
    assert torch.equal(got, ref) and torch.equal(rep, got)
    live = slice(None) if dense or T > 1 else slice(1, None)  # page 0: racing pad writes
    for a, b, c in zip(mine, plain, again):
        if kind == "q8":
            dd = (a.data[:, live].int() - b.data[:, live].int()).abs().max().item()
            du = (a.scales[:, live].view(torch.int32).long()
                  - b.scales[:, live].view(torch.int32).long()).abs().max().item()
            assert dd <= 1 and du <= 1
            assert torch.equal(a.data[:, live], c.data[:, live])
            assert torch.equal(a.scales[:, live], c.scales[:, live])
        else:
            assert torch.equal(a[:, live], b[:, live]) and torch.equal(a[:, live], c[:, live])


@pytest.mark.parametrize("kv_dtype", [torch.float32, "q8"])
def test_paged_forward_on_card_matches_cpu_logits(cuda, kv_dtype):
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.kv.paged import PagedKVCache
    from jlama_tpu_torch.models.base import forward_logits, fuse_params, params_to
    from jlama_tpu_torch.models.init import init_params

    cfg = from_hf_config({
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "rms_norm_eps": 1e-5, "vocab_size": 256, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2,
        "hidden_act": "silu", "tie_word_embeddings": False,
    })
    params = fuse_params(init_params(cfg, seed=0, dtype=torch.float32, device="cpu"))
    toks = torch.tensor([[1, 5, 9, 42, 7, 13, 99, 100] * 3])

    def run(p, device):
        kv = PagedKVCache(cfg, n_pages=6, page_size=16, max_pages_per_seq=2, dtype=kv_dtype,
                          device=device)
        kv.alloc.ensure_capacity("s", 32, 16)
        cache = (kv.layer_states(), torch.from_numpy(kv.page_table(["s"])).to(device))
        outs = [forward_logits(p, cfg, toks[:, :16].to(device),
                               torch.arange(16, device=device)[None], cache,
                               dtype=torch.float32)[0]]
        for t in range(16, 24):
            outs.append(forward_logits(p, cfg, toks[:, t:t + 1].to(device),
                                       torch.tensor([[t]], device=device), cache,
                                       dtype=torch.float32)[0])
        return torch.cat(outs, dim=1).cpu()

    ref = run(params, "cpu")
    got = run(params_to(params, cuda), cuda)
    # every K1 call here is a GEMV (M <= 16): f32 dequant, sums in another order
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel < 3e-2, rel


def _q4s_weight(n, k, g, device):
    """A q4s weight made by to_q4s from random JQ4 (nibbles uniform, scales
    positive), on `device`."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.w8a8 import to_q4s

    q4 = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=device,
                              dtype=torch.uint8),
                (torch.rand((n, k // 32), generator=g, device=device) + 0.5) * 0.0043)
    return to_q4s(q4)


# M <= 16 takes the decode route (x quantized in the launch to M = 2, else by
# the pre-pass; per-warp TMA rings; mma.sync s8 with the tokens on the n8
# side: one token tile to M = 8, two above; row tiles of 32 or 16 weight rows
# by N, 8 or 16 warps), M > 16 the wgmma route (pre-pass, TMA ring, wgmma s8).
# Decode: M = 1, 8 and 16 at N = 1000 and N = 96 (ragged row tiles), K = 768
# (sigma and swk rows of 24 and 12 bytes, which TMA cannot map; 3 groups for
# 8 warps) and K = 14336 (56 groups: 16 warps at N = 96 and 64, 7 rounds of 8
# at Llama-3.1-8B's w2, N = 4096); 13 rows at N = 9000 and 4 at N = 5000
# (32-row tiles, ragged). Prefill: 17 and 300 rows at K = 768, 130 rows at N =
# 1000, 300 rows at N = 96, a perplexity window's 1024 rows (f32 x in the f32
# parametrisation), and the 1B w13 at 512.
@pytest.mark.parametrize("m,n,k", [(1, 256, 256), (5, 1000, 512), (16, 384, 1024),
                                   (1, 1000, 768), (8, 1000, 768), (16, 1000, 768),
                                   (1, 96, 14336), (8, 96, 14336), (16, 96, 14336),
                                   (1, 4096, 14336), (8, 4096, 14336), (13, 9000, 2048),
                                   (4, 5000, 1024),
                                   (17, 520, 768), (300, 384, 768), (130, 1000, 2048),
                                   (2, 64, 14336), (16, 4096, 14336), (300, 96, 14336),
                                   (1024, 1000, 2048), (512, 16384, 2048)])
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.float32),
                                               (torch.bfloat16, torch.float32)])
def test_w8a8_kernel_matches_plain(cuda, m, n, k, x_dtype, out_dtype):
    """K5 against its plain version run on the CPU, on either route: exact
    integer dots, each group's products and their sums rounded in group
    order, as the plain version's, so bit for bit, and bit for bit on a
    second call."""
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, q4s_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    w = _q4s_weight(n, k, g, cuda)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    x[0, :256] = 0  # an all-zero activation group: scale 0
    before = q4s_matmul.launches
    got = q4s_matmul(x, w, out_dtype)
    assert q4s_matmul.launches == before + 1 and got.dtype == out_dtype
    assert torch.equal(got.cpu(), q4s_matmul_plain(x.cpu(), w.to("cpu"), out_dtype))
    assert torch.equal(q4s_matmul(x, w, out_dtype), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_prefill_takes_views_and_leading_dims(cuda, dtype):
    """The wgmma route on x given as a view at an offset that is not 16-byte
    aligned (the wrapper clones it) and with leading dims: the plain
    version's bits."""
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, q4s_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(5)
    w = _q4s_weight(384, 512, g, cuda)
    flat = torch.randn(3 * 40 * 512 + 1, generator=g, device=cuda).to(dtype)
    x = flat[1:].view(3, 40, 512)  # 2 or 4 bytes past an aligned base
    assert x.data_ptr() % 16
    got = q4s_matmul(x, w, dtype)
    assert got.shape == (3, 40, 384)
    assert torch.equal(got.cpu(), q4s_matmul_plain(x.cpu(), w.to("cpu"), dtype))


# y rows that are no 16-byte multiple: GPT-2's tied lm_head (vocabulary
# 50,257, K 768) in a perplexity window (f32 x and out, 1024 rows), an odd N
# in bf16, and f32 out at N = 1003
@pytest.mark.parametrize("m,n,k,x_dtype,out_dtype", [
    (1024, 50257, 768, torch.float32, torch.float32),
    (37, 1001, 256, torch.bfloat16, torch.bfloat16),
    (300, 1003, 768, torch.bfloat16, torch.float32)])
def test_w8a8_prefill_any_n(cuda, m, n, k, x_dtype, out_dtype):
    """Past M = 16 the output goes out by TMA, which needs 16-byte row
    strides: the wrapper pads y's stride and returns the N columns, contiguous
    and equal to the plain version's bits."""
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, q4s_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(n)
    w = _q4s_weight(n, k, g, cuda)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    got = q4s_matmul(x, w, out_dtype)
    assert got.shape == (m, n) and got.is_contiguous() and got.dtype == out_dtype
    assert torch.equal(got.cpu(), q4s_matmul_plain(x.cpu(), w.to("cpu"), out_dtype))


@pytest.mark.parametrize("m,k", [(1, 256), (16, 2048), (37, 14336)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_activation_quantization_exact(cuda, m, k, dtype):
    """The kernels' activation quantization (in the launch at M = 1, else
    the pre-pass), held through their output: on an input that q8_quantize
    reproduces exactly (integers in [-127, 127] times 0.5, each group
    holding a 127, one all-zero group) and
    a weight whose swk are all 2^-8, every product and f32 sum is exact in
    any order, so the output equals the plain version's bit for bit (f32 and
    bf16 out) only if every code and scale does."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, q4s_matmul_plain
    from jlama_tpu_torch.quant.blockq import q8_quantize

    g = torch.Generator(device=cuda).manual_seed(m + k)
    w = _q4s_weight(384, k, g, cuda)
    w = QArray(w.data, (w.scales[0], torch.full_like(w.scales[1], 2.0 ** -8)), "q4s")
    ints = torch.randint(-127, 128, (m, k), generator=g, device=cuda).float()
    ints[:, ::256] = 127.0
    ints[0, :256] = 0.0
    x = (ints * 0.5).to(dtype)
    xq, _ = q8_quantize(x.float(), block=256)
    assert torch.equal(xq.float() * 0.5, x.float())  # lossless
    for out_dtype in (torch.float32, torch.bfloat16):
        got = q4s_matmul(x, w, out_dtype).cpu()
        assert torch.equal(got, q4s_matmul_plain(x.cpu(), w.to("cpu"), out_dtype))


def test_q4s_forward_on_card_matches_cpu_logits(cuda):
    """A q4s model (every projection and the lm_head through K5) on the card
    against the same weights through K5's plain version on the CPU, in f32:
    rel L2 < 3e-2, as the q4 forwards above. Each K5 call is exact against
    the plain version on the same input, but the int8 quantization is
    discontinuous: a last-bit difference in an activation (the other ops sum
    in another order) can move its code by one, and the layers after it
    carry that on. The embedding is float so that layer 0's input holds no
    exact rounding ties (a q4 row after the norm does)."""
    from jlama_tpu_torch.config import from_hf_config
    from jlama_tpu_torch.models.base import forward_logits, fuse_params, params_to
    from jlama_tpu_torch.models.init import init_params
    from jlama_tpu_torch.nn.qarray import quantize_q4
    from jlama_tpu_torch.ops.w8a8 import prepare_params_for_w8a8, q4s_matmul

    cfg = from_hf_config({
        "model_type": "llama", "hidden_size": 256, "intermediate_size": 512,
        "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
        "rms_norm_eps": 1e-5, "vocab_size": 512, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "bos_token_id": 1, "eos_token_id": 2,
        "hidden_act": "silu", "tie_word_embeddings": False,
    })
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params["lm_head"] = quantize_q4(params["lm_head"].numpy())
    params = prepare_params_for_w8a8(fuse_params(params))
    assert params["lm_head"].fmt == "q4s"
    for T in (1, 32):  # the decode kernel and the prefill kernel
        toks = torch.tensor([[1, 5, 9, 42, 7, 13, 99, 100] * 4])[:, :T]
        pos = torch.arange(T)[None, :]
        ref, _ = forward_logits(params, cfg, toks, pos, None, dtype=torch.float32)
        before = q4s_matmul.launches
        got, _ = forward_logits(params_to(params, cuda), cfg, toks.to(cuda), pos.to(cuda), None,
                                dtype=torch.float32)
        assert q4s_matmul.launches == before + 4 * cfg.n_layers + 1
        rel = ((got.cpu() - ref).norm() / ref.norm()).item()
        assert rel < 3e-2, (T, rel)


# ---- the design benches (P1-P3): each kernel against its plain version on the
# card, at a ragged shape and a Llama-3.2-1B one, at M = 1 and 16 -------------

BENCH_SHAPES = [(1003, 1024), (8192, 2048)]


def _q4_bench_names():
    from jlama_tpu_torch.scripts import kbench_q4

    return [v for v in kbench_q4.VARIANTS if v != "i4x"]


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("n,k", BENCH_SHAPES)
@pytest.mark.parametrize("name", _q4_bench_names())
def test_kbench_q4_kernel_matches_plain(cuda, name, n, k, m):
    from jlama_tpu_torch.scripts import _common, kbench_q4 as kb

    x, packed, scales = kb.make_inputs(n, k, m, cuda)
    s16 = scales.to(torch.bfloat16)
    wrapper, kw, form, _ = kb.VARIANTS[name]
    args = (x, packed, s16) + ((s16.repeat_interleave(16, dim=1),) if form == "expanded" else ())
    before = wrapper.launches
    got = wrapper(*args, **kw)
    assert wrapper.launches == before + 1 and got.shape == (m, n)
    ref = kb._plain_of(wrapper, kw)[1](*args)
    torch.cuda.synchronize()
    err, ratio = _common.limit_ratio(got, ref, name in kb.EXACT)
    assert ratio <= 1.0, (name, err, ratio)


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("n,k", BENCH_SHAPES)
@pytest.mark.parametrize("name", ["pb8", "pgb8", "pgbf", "di8b", "pk4"])
def test_kbench_w8a8_kernel_matches_plain(cuda, name, n, k, m):
    from jlama_tpu_torch.quant.blockq import q4_unpack, q8_quantize
    from jlama_tpu_torch.scripts import _common, kbench_w8a8 as kb

    x, packed, scales, sg = kb.make_inputs(n, k, m, cuda)
    xq, xs = q8_quantize(x)
    blocks = lambda: kb.blocks_plain(xq, xs, packed, scales)  # noqa: E731
    calls = {
        "pb8": (lambda: kb.pb8(x, packed, scales), blocks),
        "pgb8": (lambda: kb.pgb(x, packed, scales), blocks),
        "pgbf": (lambda: kb.pgb(x, packed, scales, dom="bf16"),
                 lambda: kb.float_plain(x, packed, scales)),
        "di8b": (lambda: kb.di8b(x, q4_unpack(packed), scales),
                 lambda: kb.int8_plain(xq, q4_unpack(packed), scales)),
        "pk4": (lambda: kb.pk4(x, packed, sg), lambda: kb.groups_plain(xq, packed, sg)),
    }
    wrapper = kb.VARIANTS[name][0]
    before = wrapper.launches
    got = calls[name][0]()
    assert wrapper.launches == before + 1 and got.shape == (m, n)
    ref = calls[name][1]()
    torch.cuda.synchronize()
    err, ratio = _common.limit_ratio(got, ref, name in kb.EXACT)
    assert ratio <= 1.0, (name, err, ratio)


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("n,k", [(1003, 1024), (4096, 4096)])
@pytest.mark.parametrize("probe", ["pallas", "bitcast"])
def test_probe_int4_kernel_matches_plain(cuda, probe, n, k, m):
    from jlama_tpu_torch.scripts import _common, probe_int4 as pi

    x, packed, s = pi.make_inputs(n, k, m, cuda)
    fn = pi.PROBES[probe]
    before = fn.launches
    got = fn(x, packed, s)
    assert fn.launches == before + 1
    ref = pi.u4_plain(x, packed, s)
    torch.cuda.synchronize()
    assert _common.limit_ratio(got, ref, exact=False)[1] <= 1.0


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("n,k", [(1003, 1024), (256, 512)])
def test_probe_sigma_kernels_equal_plain(cuda, n, k, m):
    from jlama_tpu_torch.scripts import probe_sigma_i16 as ps

    x, w, sigma = ps.make_inputs(n, k, m, cuda)
    ref = ps.sigma_plain(x, w, sigma)
    for fn in ps.WRAPPERS:
        before = fn.launches
        got = fn(x, w, sigma)
        assert fn.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, ref), fn.__name__


# K6, the grouped expert q4 matmul: Mixtral's expert widths cut to narrow
# ones (N 1000, K 2048; N 512, K 1536; the 3-block K of 96), 8 experts, at R
# = 1, 2, 8, 9, 16, 32, 33, 64, 512, 1024 and 2048 selections (both routes,
# the decode route's 8-, 16- and 32-column chunks, ragged ones, row tiles
# that end inside the next expert's rows), ids [T, 2] (one x row a token,
# the gate/up call) and [R] (one a selection, the down call), random top-2
# routing, an expert chosen by no selection, and every selection on one
# expert. Each R is held to its route's plain model: the decode route to
# the plain version (f32 dequantization, one f32 matmul per expert group),
# the prefill route to its rounding model (x and the weights rounded to
# bf16, `_moe_ragged`'s function): the same exact products, f32 sums in
# another order (1e-4 of max|ref|), plus one bf16 ulp of the value (2^-7 of
# it) for a bf16 output; a second call gives the same bits.
def _moe_case(cuda, r, n, k, ids, case, g):
    from jlama_tpu_torch.nn.qarray import QArray

    n_exp = 8
    w = QArray(torch.randint(0, 256, (n_exp, n, k // 2), generator=g, device=cuda,
                             dtype=torch.uint8),
               (torch.rand((n_exp, n, k // 32), generator=g, device=cuda) + 0.5) * 0.0043)
    t = r // 2 if ids == "tk" else r
    if case == "one":
        e = torch.full((t, 2) if ids == "tk" else (t,), 5, dtype=torch.int32, device=cuda)
    else:
        # top-2 of 8 without replacement per token; "empty": expert 3 never
        choices = torch.tensor([0, 1, 2, 4, 5, 6, 7] if case == "empty" else list(range(8)),
                               device=cuda)
        pick = torch.rand((max(t, 1) if ids == "tk" else (r + 1) // 2, len(choices)),
                          generator=g, device=cuda).argsort(dim=1)[:, :2]
        e = choices[pick].to(torch.int32).reshape(-1)[:r]
        if ids == "tk":
            e = e.reshape(t, 2)
    x = torch.randn((t, k), generator=g, device=cuda).to(torch.bfloat16)
    return x, w, e


def _moe_model(r):
    """The plain model of the route that R selections take on the card."""
    from jlama_tpu_torch.ops import moe_q4

    return moe_q4.moe_q4_matmul_plain if moe_q4.takes_decode(r) \
        else moe_q4.moe_q4_matmul_tiled_plain


def _moe_within(got, ref, out_dtype):
    lim = 1e-4 * ref.abs().max().item()
    if out_dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * ref.abs()
    return bool(((got.float() - ref).abs() <= lim).all())


@pytest.mark.parametrize("r,ids", [(1, "r"), (2, "tk"), (2, "r"), (8, "tk"), (9, "r"),
                                   (16, "tk"), (32, "tk"), (32, "r"), (33, "r"), (64, "tk"),
                                   (512, "tk"), (1024, "tk"), (1024, "r"), (2048, "r")])
@pytest.mark.parametrize("n,k", [(1000, 2048), (512, 1536), (40, 96)])
@pytest.mark.parametrize("case", ["random", "empty", "one"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_moe_q4_kernel_matches_plain(cuda, r, ids, n, k, case, out_dtype):
    from jlama_tpu_torch.ops.moe_q4 import (moe_gather, moe_groups, moe_q4_matmul,
                                            moe_q4_matmul_plain, takes_decode)

    g = torch.Generator(device=cuda).manual_seed(r * n + k)
    x, w, e = _moe_case(cuda, r, n, k, ids, case, g)
    before = (moe_q4_matmul.launches, moe_groups.launches, moe_gather.launches)
    got = moe_q4_matmul(x, w, e, out_dtype)
    # the prefill route gathers x first, a launch of its own
    assert (moe_q4_matmul.launches, moe_groups.launches, moe_gather.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + (not takes_decode(r)))
    assert got.dtype == out_dtype and got.shape == (*e.shape, n)
    ref = _moe_model(r)(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert _moe_within(got, ref, out_dtype)
    if not takes_decode(r):  # the prefill route's distance from the exact plain version
        exact = moe_q4_matmul_plain(x, w, e, torch.float32)
        print(f"K6 prefill R={r} {n}x{k} {case}: max |kernel - exact| "
              f"{(got.float() - exact).abs().max().item():.3g} (max|exact| "
              f"{exact.abs().max().item():.3g})")
    groups = moe_groups(e, 8)
    again = moe_q4_matmul(x, w, e, out_dtype, groups=groups)
    assert torch.equal(again, got)


@pytest.mark.parametrize("r,ids", [(2, "tk"), (32, "tk"), (1024, "tk")])
@pytest.mark.parametrize("n,k", [(1000, 2048), (40, 96)])
@pytest.mark.parametrize("case", ["random", "one"])
def test_moe_q4_gate_up_matches_two_plain_calls(cuda, r, ids, n, k, case):
    """Gate and up in one launch (two weight stacks, one grouping) against
    the route's plain model of each stack, and each output equal bit for bit
    to that stack's own single-stack call."""
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.moe_q4 import moe_groups, moe_q4_gate_up, moe_q4_matmul

    g = torch.Generator(device=cuda).manual_seed(r + n + k)
    x, w1, e = _moe_case(cuda, r, n, k, ids, case, g)
    w3 = QArray(torch.randint(0, 256, w1.data.shape, generator=g, device=cuda,
                              dtype=torch.uint8), w1.scales.flip(1).contiguous())
    groups = moe_groups(e, 8)
    before = moe_q4_matmul.launches
    gate, up = moe_q4_gate_up(x, w1, w3, e, groups=groups)
    assert moe_q4_matmul.launches == before + 1
    torch.cuda.synchronize()
    for w, y in ((w1, gate), (w3, up)):
        assert y.dtype == torch.bfloat16 and y.shape == (*e.shape, n)
        assert _moe_within(y, _moe_model(r)(x, w, e, torch.float32), torch.bfloat16)
        assert torch.equal(y, moe_q4_matmul(x, w, e, groups=groups))


@pytest.mark.parametrize("variant", ["grid", "decode", "prefill"])
@pytest.mark.parametrize("r", [2, 32, 300])
def test_moe_q4_compare_variants_match_their_models(cuda, variant, r):
    """The comparison entry's kernels at any R: the grid kernel and the
    decode route against the plain version, the prefill route against its
    rounding model."""
    from jlama_tpu_torch.ops.moe_q4 import (moe_q4_compare, moe_q4_matmul_plain,
                                            moe_q4_matmul_tiled_plain)

    g = torch.Generator(device=cuda).manual_seed(r)
    x, w, e = _moe_case(cuda, r, 1000, 2048, "r", "random", g)
    before = moe_q4_compare.launches
    got = moe_q4_compare(x, w, e, torch.float32, variant=variant)
    assert moe_q4_compare.launches == before + 1
    model = moe_q4_matmul_tiled_plain if variant == "prefill" else moe_q4_matmul_plain
    ref = model(x, w, e, torch.float32)
    torch.cuda.synchronize()
    assert _moe_within(got, ref, torch.float32)


@pytest.mark.parametrize("r", [300, 600])
@pytest.mark.parametrize("per", [1, 2])
def test_moe_gather_skips_selections_outside_the_experts(cuda, per, r):
    """Selections whose id lies outside [0, E) are in no group: the prefill
    route's gathered copy holds x[order // per] in its first offsets[E] rows,
    and the y rows of the grouped selections are the bits of the same
    selections without the others."""
    from jlama_tpu_torch.ops.moe_q4 import moe_gather, moe_groups, moe_q4_matmul, takes_decode

    g = torch.Generator(device=cuda).manual_seed(per * r)
    x, w, e = _moe_case(cuda, r, 1000, 2048, "tk" if per == 2 else "r", "random", g)
    bad = e.clone()
    bad.view(-1)[::7] = 8  # past the last expert
    groups = moe_groups(bad, 8)
    n_ok = int(groups.offsets[-1])
    assert n_ok == r - len(range(0, r, 7)) and not takes_decode(n_ok)
    xg = moe_gather(x, groups, per)
    assert torch.equal(xg[:n_ok], x[groups.order[:n_ok].long() // per])
    y = moe_q4_matmul(x, w, bad, torch.float32, groups=groups).reshape(r, -1)
    ok = (bad.reshape(-1) < 8).nonzero()[:, 0]
    xr = x.repeat_interleave(per, dim=0) if per > 1 else x
    alone = moe_q4_matmul(xr[ok].contiguous(), w, bad.reshape(-1)[ok].contiguous(),
                          torch.float32)
    assert torch.equal(y[ok], alone)


def test_moe_q4_threshold_and_tile_rows(cuda):
    """The C source owns the threshold and the routes' tile rows: the
    16-slot decode step (R = 32) takes the decode route, a 512-token prefill
    (R = 1024) the prefill route, and the Python mirrors of the tile rows
    agree."""
    from jlama_tpu_torch.ops import _build, moe_q4

    lib = _build.load("moe_q4", moe_q4._SIGNATURES)
    assert lib.moe_q4_tile_rows() == moe_q4.TILE_ROWS
    assert lib.moe_q4_decode_tile_rows() == moe_q4.DECODE_TILE_ROWS
    assert moe_q4.takes_decode(2) and moe_q4.takes_decode(32)
    assert not moe_q4.takes_decode(1024)


@pytest.mark.parametrize("r", [0, 1, 33, 300, 2048])
def test_moe_groups_kernel_equals_plain(cuda, r):
    """order, offsets, both routes' tile lists and their counts, entries
    past the counts -1, equal to the plain grouping's."""
    from jlama_tpu_torch.ops.moe_q4 import moe_groups, moe_groups_plain

    g = torch.Generator(device=cuda).manual_seed(r)
    e = torch.randint(0, 8, (r,), generator=g, device=cuda, dtype=torch.int32)
    e[e == 3] = 4  # an expert no selection chose
    got = moe_groups(e, 8)
    ref = moe_groups_plain(e.cpu(), 8)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("route,r,subsets", [("decode", 32, (1, 16)), ("prefill", 1024, (512,))])
def test_moe_q4_row_does_not_depend_on_the_batch(cuda, route, r, subsets):
    """Within a route, a selection's output is the same bits alone or among
    more (other groupings, other row tiles or chunks): the serving batch does
    not change a request's numbers. Across the two routes the rounding
    differs (the decode route exact f32 dequantization, the prefill route bf16
    weights), as K1's routes and the JAX package's two MoE routes differ."""
    from jlama_tpu_torch.ops.moe_q4 import moe_q4_matmul, takes_decode

    g = torch.Generator(device=cuda).manual_seed(7)
    x, w, e = _moe_case(cuda, r, 1000, 2048, "r", "random", g)
    assert all(takes_decode(t) == (route == "decode") for t in (r, *subsets))
    full = moe_q4_matmul(x, w, e)
    for t in subsets:
        assert torch.equal(moe_q4_matmul(x[:t].clone(), w, e[:t].clone()), full[:t])


def test_moe_q4_rejects_f32_x_on_the_card(cuda):
    from jlama_tpu_torch.ops.moe_q4 import moe_q4_matmul

    g = torch.Generator(device=cuda).manual_seed(1)
    x, w, e = _moe_case(cuda, 2, 64, 64, "tk", "random", g)
    with pytest.raises(ValueError, match="bf16"):
        moe_q4_matmul(x.float(), w, e)


def test_moe_forward_on_card_matches_cpu_logits(cuda):
    """A 2-layer Mixtral-shaped model at narrow width (hidden 1024, head size
    128, 8 experts, top-2), random JQ4 weights: the prefill logits of 24
    tokens on the card (bf16, K6 for the experts) against the plain path in
    f32 on the CPU, relative L2 < 5e-2."""
    import dataclasses

    from jlama_tpu_torch.models.base import forward_logits, params_to
    from jlama_tpu_torch.models.init import mixtral_8x7b_config, random_q4_params
    from jlama_tpu_torch.ops.moe_q4 import moe_q4_matmul

    cfg = dataclasses.replace(mixtral_8x7b_config(), n_layers=2, embedding_length=1024,
                              hidden_length=1792, n_heads=8, n_kv_heads=2)
    params = random_q4_params(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(24)[None, :]
    before = moe_q4_matmul.launches
    gpu, _ = forward_logits(params, cfg, toks.to(cuda), pos.to(cuda), None, dtype=torch.bfloat16)
    assert moe_q4_matmul.launches == before + 2 * cfg.n_layers  # gate+up, down
    with torch.inference_mode():
        ref, _ = forward_logits(params_to(params, "cpu"), cfg, toks, pos, None,
                                dtype=torch.float32)
    gpu = gpu.float().cpu()
    assert torch.isfinite(gpu).all()
    assert ((gpu - ref).norm() / ref.norm()).item() < 5e-2


def test_gemma2_forward_on_card_matches_cpu_logits(cuda):
    """A 2-layer Gemma-2-shaped model at narrow width (hidden 512, head size
    256, 8 query heads on 4 KV heads, window 16 on layer 0, both softcaps),
    random JQ4 weights: 40 prompt tokens and 4 decode steps through the
    dense cache (K3 and K2 at hd 256, the window cutting both) on the card
    in bf16 against the plain path in f32 on the CPU, relative L2 < 5e-2."""
    import dataclasses

    from jlama_tpu_torch.models.base import KVCache, forward_logits, params_to
    from jlama_tpu_torch.models.init import gemma2_2b_config, random_q4_params
    from jlama_tpu_torch.ops.attention import flash_prefill, paged_decode

    cfg = dataclasses.replace(gemma2_2b_config(), n_layers=2, embedding_length=512,
                              hidden_length=1024, vocab_size=4096, sliding_window=16)
    params = random_q4_params(cfg, seed=0, device=cuda)
    cpu = params_to(params, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 44), generator=torch.Generator().manual_seed(0))
    caches = {d: KVCache.init(cfg, 1, 64, dt, device=d)
              for d, dt in ((cuda, torch.bfloat16), ("cpu", torch.float32))}
    steps = [(0, 40)] + [(t, t + 1) for t in range(40, 44)]
    before = (flash_prefill.launches, paged_decode.launches)
    for a, b in steps:
        pos = torch.arange(a, b)[None, :]
        gpu, _ = forward_logits(params, cfg, toks[:, a:b].to(cuda), pos.to(cuda), caches[cuda],
                                dtype=torch.bfloat16)
        with torch.inference_mode():
            ref, _ = forward_logits(cpu, cfg, toks[:, a:b], pos, caches["cpu"],
                                    dtype=torch.float32)
        gpu = gpu.float().cpu()
        assert torch.isfinite(gpu).all()
        assert ((gpu - ref).norm() / ref.norm()).item() < 5e-2, (a, b)
    assert (flash_prefill.launches - before[0], paged_decode.launches - before[1]) == \
        (cfg.n_layers, 4 * cfg.n_layers)
