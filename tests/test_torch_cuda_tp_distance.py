"""The tp = 2 f32 distance of a normal(0, 0.02) draw on the card, and its
cause: K1 past 16 rows takes bf16 x, so its wrapper rounds f32 x to bf16
(`ops/q4_matmul.py`); tp's reordered f32 sums of wo and w2 then flip some of
the next layers' bf16 roundings, and the draw carries them on. At
Llama-3.2-1B's widths and depth (random q4 weights, normal(0, 0.02), seed
0), 64 tokens, the port's tp = 2 logits (thread ranks on the one card,
`tests/torch_thread_ranks.py`) against one device's, in f32:

- K1 as served, past 16 rows: the distance is the cast's, within 4 times of
  what the route's plain model (`q4_matmul_tiled_plain`, x rounded to bf16)
  gives in K1's place, and both at least 100 times the f32 one;
- K1 replaced by its f32 plain version (`q4_matmul_plain`): f32 rounding
  only, under 1e-5;
- K1 as served at 16 tokens (its f32 route): under 1e-5.

Marked `cuda`: it skips where torch has no CUDA device (as on the CPU test
runs); on a machine with an NVIDIA GPU run it with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tp_distance.py -m cuda -q -s`
(the distances are printed)."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def test_tp_distance_is_k1s_bf16_cast():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels)")
    from jlama_tpu_torch.models.init import init_params, llama_1b_config
    from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain, q4_matmul_tiled_plain
    from torch_thread_ranks import tp_distance  # tests/ (pytest puts it on sys.path)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = llama_1b_config()
    params = init_params(cfg, seed=0, dtype=torch.float32, quantize="q4", device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)))
    toks = toks.long().cuda()
    before = q4_matmul.launches
    d = {"kernel": tp_distance(params, cfg, toks)}
    assert q4_matmul.launches > before
    d["f32"] = tp_distance(params, cfg, toks, matmul=q4_matmul_plain)
    d["cast"] = tp_distance(params, cfg, toks, matmul=q4_matmul_tiled_plain)
    d["kernel_16"] = tp_distance(params, cfg, toks[:, :16])
    print(f"\n{torch.cuda.get_device_name(0)}, Llama-3.2-1B ({cfg.n_layers} layers), tp = 2 "
          "f32 logits' rel L2 from one device: "
          + ", ".join(f"{k} {v:.4e}" for k, v in d.items()), flush=True)
    assert d["f32"] < 1e-5 and d["kernel_16"] < 1e-5, d
    assert d["kernel"] > 100 * d["f32"] and d["cast"] > 100 * d["f32"], d
    assert d["cast"] / 4 < d["kernel"] < 4 * d["cast"], d
