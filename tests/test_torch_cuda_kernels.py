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


@pytest.mark.parametrize("m,n,k", [(1, 256, 256), (3, 1000, 2048), (16, 512, 128),
                                   (17, 384, 96), (130, 520, 640), (2, 64, 14336)])
@pytest.mark.parametrize("x_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                               (torch.float32, torch.float32),
                                               (torch.bfloat16, torch.float32)])
def test_q4_matmul_kernel_matches_plain(cuda, m, n, k, x_dtype, out_dtype):
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain

    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    w = QArray(torch.randint(0, 256, (n, k // 2), generator=g, device=cuda, dtype=torch.uint8),
               torch.rand((n, k // 32), generator=g, device=cuda) * 0.01)
    x = torch.randn((m, k), generator=g, device=cuda).to(x_dtype)
    before = q4_matmul.launches
    got = q4_matmul(x, w, out_dtype)
    assert q4_matmul.launches == before + 1 and got.dtype == out_dtype
    ref = q4_matmul_plain(x, w.data, w.scales, torch.float32)
    torch.cuda.synchronize()
    # GEMV (m <= 16) dequantizes exactly in f32; the tiled path rounds W to bf16
    tol = 2e-2 if (m > 16 or out_dtype == torch.bfloat16) else 1e-4
    assert (got.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("B,T,S,pos0,hd,cap,win", [
    (1, 64, 64, 0, 64, None, None), (2, 40, 100, 60, 128, None, None),
    (1, 33, 77, 20, 64, 30.0, 16), (1, 128, 512, 384, 128, None, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_kernel_matches_plain(cuda, B, T, S, pos0, hd, cap, win, dtype):
    from jlama_tpu_torch.ops.attention import flash_prefill, flash_prefill_plain

    g = torch.Generator(device=cuda).manual_seed(T * S + hd)
    H, n_kv = 8, 2
    q = torch.randn((B, H, T, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, n_kv, S, hd), generator=g, device=cuda).to(dtype)
    p0 = torch.full((B,), pos0, dtype=torch.int32, device=cuda)
    got = flash_prefill(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    ref = flash_prefill_plain(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max().item() <= tol


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
