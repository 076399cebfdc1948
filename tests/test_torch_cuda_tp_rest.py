"""The rest of tensor parallelism on the card: K5 at the tp = 2 rank shapes
of Llama-3.1-8B (wqkv N 3,072 and w13 N 14,336 at K 4,096, wo K 2,048 and w2
K 7,168 = 28 groups with f32 output, the vocabulary-sharded lm_head N 64,128)
at the decode route's M = 1 and 16 and the prefill route's 512, bit-equal to
`q4s_matmul_plain` and on a repeat; and two gloo ranks on cuda:0 running
chip_smoke.py phase 19's rank program (jlama_tpu_torch/scripts/
tp_load_check.py) at tiny widths in f32: a JQ4 llama written here (HF names,
then the port's quantizer) read shard-locally, q4 and q4s served at tp = 2
with one device's ids (K5 on each rank's own weights bit-equal to its plain
version), GPT-2, and a BERT mesh server's /v1/embeddings, every check of
`check_ranks`.

Marked `cuda`: it skips where torch has no CUDA device (as on the CPU test
runs); on a machine with an NVIDIA GPU run it with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tp_rest.py -m cuda -q`.
The rank processes start with `spawn`, meet through a FileStore in tmp_path
and have a deadline of their own."""

import json
import pickle
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
# Llama-3.1-8B at tp = 2: (N, K, out dtype) of one rank's q4s weights
TP8B = {"wqkv": (3072, 4096, "bf16"), "wo": (4096, 2048, "f32"), "w13": (14336, 4096, "bf16"),
        "w2": (4096, 7168, "f32"), "lm_head": (64128, 4096, "f32")}
DEADLINE = 240


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels)")


@pytest.mark.parametrize("m", [1, 16, 512])
@pytest.mark.parametrize("name", list(TP8B))
def test_k5_at_tp_rank_shapes_equals_plain(name, m):
    _card()
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.ops.w8a8 import q4s_matmul, q4s_matmul_plain, to_q4s

    n, k, out = TP8B[name]
    out = {"bf16": torch.bfloat16, "f32": torch.float32}[out]
    g = torch.Generator(device="cuda").manual_seed(n + k + m)
    w = to_q4s(QArray(torch.randint(0, 256, (n, k // 2), generator=g, device="cuda",
                                    dtype=torch.uint8),
                      (torch.rand((n, k // 32), generator=g, device="cuda") + 0.5) * 0.0043))
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    before = q4s_matmul.launches
    y = q4s_matmul(x, w, out)
    assert q4s_matmul.launches == before + 1
    assert y.shape == (m, n) and y.dtype == out
    assert torch.equal(y, q4s_matmul_plain(x, w, out))
    assert torch.equal(q4s_matmul(x, w, out), y)


def test_tp_rest_ranks_on_the_card(tmp_path):
    """Phase 19's rank program at tiny widths (f32 activations: K1's and K5's
    f32 routes; the greedy ids of tp = 2 and one device then differ only in
    f32 sums of the row-parallel partials)."""
    _card()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from jlama_tpu_torch.quant.quantizer import quantize_model
    from jlama_tpu_torch.scripts import tp_check, tp_load_check

    hf = dict(model_type="llama", hidden_size=512, intermediate_size=1024, head_dim=64,
              num_attention_heads=8, num_key_value_heads=4, num_hidden_layers=2,
              rms_norm_eps=1e-5, vocab_size=1024, max_position_embeddings=2048,
              rope_theta=500000.0, bos_token_id=1, eos_token_id=2, hidden_act="silu",
              tie_word_embeddings=False)
    chip_smoke._write_hf_llama(torch, tmp_path / "src", hf, seed=0)
    model_dir = quantize_model(tmp_path / "src", tmp_path / "llama-JQ4", device="cuda")
    bert = dict(model_type="bert", hidden_size=128, num_attention_heads=4, num_hidden_layers=2,
                intermediate_size=256, max_position_embeddings=512, type_vocab_size=2,
                layer_norm_eps=1e-12, hidden_act="gelu", vocab_size=4096)
    gpt2 = dict(model_type="gpt2", n_embd=256, n_head=4, n_layer=2, n_positions=1024,
                n_inner=512, vocab_size=1024, layer_norm_epsilon=1e-5,
                activation_function="gelu_new", bos_token_id=0, eos_token_id=0)
    tok = tmp_path / "bert_tokenizer.json"
    tok.write_text(json.dumps(chip_smoke.bert_tokenizer_json(bert["vocab_size"])))
    spec = dict(device="cuda:0", backend="gloo", timeout_s=DEADLINE, seed=0, f32=True,
                model_dir=str(model_dir), gpt2=gpt2, bert=bert, bert_tokenizer=str(tok),
                texts=["the quick brown fox", "a dog", "over the lazy dog " * 8], n_slots=4,
                n_pages=64, page_size=64, max_seq_len=1024, requests=4, prompt_len=(24, 80),
                new_tokens=8, prefill=64, logit_rows=8, k5_m=(1, 16, 64))
    procs, end = tp_check.start_ranks(tp_load_check.rank_main,
                                      lambda r: (r, 2, str(tmp_path / "store"),
                                                 str(tmp_path / f"rank{r}.pkl"), spec),
                                      2, DEADLINE)
    err = tp_check.wait_ranks(procs, end)
    assert err is None, err
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert tp_load_check.check_ranks(ranks, spec, embed_limit=tp_check.REL_L2_LIMIT) == []
    for res in ranks:
        assert res["disk_q4s"]["launches"]["w8a8_matmul"] > 0, res["disk_q4s"]["launches"]
        print(f"rank {res['rank']}: {res['local']}, launches "
              + ", ".join(f"{n} {res[n]['launches']}"
                          for n in tp_load_check.LLAMA_RUNS + ("gpt2", "bert")))
