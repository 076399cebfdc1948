"""chip_smoke.py's tensor-parallel phase rehearsed on the CPU: the rank
program (jlama_tpu_torch/scripts/tp_check.py) on two gloo ranks at a tiny
Llama (head size 64, so that K2's and K3's plain versions run), started with
`spawn` through a FileStore in tmp_path, and its checks (`check_ranks`),
which the card run applies at Llama-3.1-8B's widths."""

import pickle

from jlama_tpu_torch.scripts import tp_check
from tests.torch_tp_ranks import start_ranks, wait_ranks

SPEC = dict(hf_config=dict(model_type="llama", hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                           rms_norm_eps=1e-5, vocab_size=512, max_position_embeddings=4096,
                           rope_theta=500000.0, bos_token_id=1, eos_token_id=2,
                           hidden_act="silu", tie_word_embeddings=False),
            device="cpu", backend="gloo", timeout_s=60, seed=0, n_pages=64, prefill=64,
            logit_rows=8, requests=4, new_tokens=6, timed_steps=4, profile=0, threads=2)


def test_tp_phase_rank_program_on_the_cpu(tmp_path):
    procs, end = start_ranks(tp_check.rank_main,
                             lambda r: (r, 2, str(tmp_path / "store"),
                                        str(tmp_path / f"rank{r}.pkl"), SPEC))
    wait_ranks(procs, end)
    ranks = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    assert tp_check.check_ranks(ranks, SPEC) == []
    lead = ranks[0]
    assert lead["logits_rel_l2"] < 1e-2 and lead["decode_ms_per_step"] > 0
    assert lead["collectives_per_step"] == 2 * 2 + 2  # wo, w2 a layer; embed; lm_head
    # a wrong expectation is caught
    broken = [dict(ranks[0], disk_ids=[]), ranks[1]]
    assert any("disk suspend" in b for b in tp_check.check_ranks(broken, SPEC))
